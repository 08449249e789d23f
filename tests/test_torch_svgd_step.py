"""PyTorch port, methods/svgd.py + experiments/cifar.py (svgd variant) +
tree.py: three SVGD steps of plain ResNet-20 (FRN, swish), 3 particles,
batch 4, no augmentation, from the same weights on the same batches, held
against the JAX package's jitted ``svgd_method.update``; the ``__mle``
bypass on a two-parameter model built alike in both frameworks; the
non-finite guard; ``rbf``; the tree helpers; ``run_single`` at a tiny size.

The config exercises weight decay (inside phi as ``l2_reg / 2`` and again in
the optimizer) and the Wilson schedule: with steps_per_epoch=1 and 2 epochs
the third step runs at lr * 0.01. The lr is 0.01, not the config's 0.05: at
0.05 the loss of four noise images rises over the steps and the step is
chaotic there (moving the weights by 1e-7 moves the JAX package's own
gradient by 1e-3 relative, and its jitted and op-by-op updates part after
two steps), so no two fp32 implementations stay together; at 0.01 the loss
falls and the jitted JAX update repeats its op-by-op one to 4e-7.

Tolerances: ``loss`` and ``backbone_loss`` 1e-5 relative (fp32 forwards
through 21 convolutions summed in another order); ResNet parameters 2e-6
absolute after three steps (measured 3.6e-7: gradients agree to about 1e-5
relative and the JAX CPU Gram, an XLA dot over 273,610 products, is itself
1e-4 off an fp64 product, which moves h and K); the two-parameter model
1e-6 absolute; ``rbf`` 1e-5 of the largest entry."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close, load_jax_params, nchw, random_jax_params, to_numpy_tree
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import svgd_method as jax_svgd_method
from beyond_deep_ensembles_tpu.methods.svgd import rbf as jax_rbf
from beyond_deep_ensembles_tpu.tree import ravel as jax_ravel
from beyond_deep_ensembles_tpu.tree import tree_stack as jax_tree_stack
from beyond_deep_ensembles_tpu_torch import tree
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.methods.svgd import rbf, svgd_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import particles_from_jax
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

PARTICLES = 3
CONFIG = {
    **jax_cifar.DEFAULT_CONFIG,
    "model": "svgd",
    "svgd_particles": PARTICLES,
    "weight_decay": 3e-4,
    "epochs": 2,
    "dataset_size": 1000,
    "augment": False,
    "lr": 0.01,
}
STEPS_PER_EPOCH = 1


def _batches(n_steps, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (rng.standard_normal((batch, 32, 32, 3)).astype(np.float32), rng.randint(0, 10, batch))
        for _ in range(n_steps)
    ]


def _port_built(config=CONFIG):
    return cifar.build(config, torch.Generator().manual_seed(0), STEPS_PER_EPOCH, device="cpu")


def _load_particles(particles, jax_stacked):
    for particle, state_dict in zip(particles, particles_from_jax(to_numpy_tree(jax_stacked))):
        particle.load_state_dict(state_dict, strict=True)


def test_three_svgd_steps_match_jax():
    model = jax_cifar._resnet(CONFIG)
    method = jax_svgd_method(
        jax_cifar._xent_loss_fn(model, augment=False),
        jax_cifar._base_tx(CONFIG, STEPS_PER_EPOCH),
        particle_count=PARTICLES,
        dataset_size=CONFIG["dataset_size"],
        l2_reg=CONFIG["svgd_reg_scale"],
    )
    stacked = jax_tree_stack([random_jax_params(model.module, (2, 32, 32, 3), seed=i) for i in range(PARTICLES)])
    state = method.init(jax.random.key(0), stacked, {})
    update = jax.jit(method.update)
    batches = _batches(3)
    jax_metrics = []
    for i, (x, y) in enumerate(batches):
        state, m = update(state, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        jax_metrics.append({k: float(v) for k, v in m.items()})

    built = _port_built()
    _load_particles(built.state.params, stacked)
    noise = NoiseSource.seeded(0)
    for (x, y), want in zip(batches, jax_metrics):
        built.state, m = built.method.update(built.state, noise, (nchw(x), torch.from_numpy(y)))
        assert m.keys() == want.keys()
        for k in want:
            assert_close(float(m[k]), want[k], rtol=1e-5, err_msg=k)
    assert built.state.step == 3

    for particle, ref in zip(built.state.params, particles_from_jax(to_numpy_tree(state.params))):
        got = {k: p.detach().numpy() for k, p in particle.named_parameters()}
        assert got.keys() == ref.keys()
        for k in ref:
            assert_close(got[k], ref[k].numpy(), atol=2e-6, rtol=0, err_msg=k)


def _tiny_jax_loss(params, model_state, key, batch):
    del key
    t, _ = batch
    loss = jnp.sum((params["w"] - t) ** 2) + t[0] * jnp.sum(params["rho__mle"] ** 2)
    return JaxLossOutput(loss=loss, model_state=model_state)


def _tiny_port_loss(params, model_state, noise, batch):
    del noise
    t, _ = batch
    loss = torch.sum((params.w - t) ** 2) + t[0] * torch.sum(params.rho__mle**2)
    return LossOutput(loss=loss, model_state=model_state)


def _tiny_particle(w, rho):
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.tensor(w))
    module.rho__mle = torch.nn.Parameter(torch.tensor(rho))
    return module


def test_mle_parameters_bypass_the_stein_step():
    """``rho__mle`` takes its raw gradient, ``w`` takes -phi: two steps of a
    two-parameter model against JAX, and the first step's rho by hand."""
    rng = np.random.RandomState(0)
    w = rng.standard_normal((PARTICLES, 3)).astype(np.float32)
    rho = rng.standard_normal((PARTICLES, 2)).astype(np.float32)
    targets = [(rng.standard_normal(3).astype(np.float32) + 1.5, None) for _ in range(2)]
    lr, l2 = 0.1, 0.01

    method = jax_svgd_method(_tiny_jax_loss, optax.sgd(lr), PARTICLES, dataset_size=10, l2_reg=l2)
    state = method.init(jax.random.key(0), {"w": jnp.asarray(w), "rho__mle": jnp.asarray(rho)})
    for i, (t, _) in enumerate(targets):
        state, _ = method.update(state, jax.random.key(i), (jnp.asarray(t), None))

    # the port's SGD without momentum or decay: optax.sgd(lr)
    port = svgd_method(_tiny_port_loss, lambda params: (SGD(params, lr), None), PARTICLES, dataset_size=10, l2_reg=l2)
    pstate = port.init(torch.nn.ModuleList(_tiny_particle(w[i], rho[i]) for i in range(PARTICLES)))
    noise = NoiseSource.seeded(0)
    t0 = torch.from_numpy(targets[0][0])
    pstate, _ = port.update(pstate, noise, (t0, None))
    for i, particle in enumerate(pstate.params):
        raw_step = torch.from_numpy(rho[i]) - lr * 2 * t0[0] * torch.from_numpy(rho[i])
        assert_close(particle.rho__mle.detach().numpy(), raw_step.numpy(), atol=1e-6, rtol=0, err_msg="rho, step 1")
    pstate, _ = port.update(pstate, noise, (torch.from_numpy(targets[1][0]), None))
    for name in ("w", "rho__mle"):
        got = np.stack([getattr(p, name).detach().numpy() for p in pstate.params])
        assert_close(got, np.asarray(state.params[name]), atol=1e-6, rtol=0, err_msg=name)


def test_nonfinite_gradient_skips_params_momentum_and_schedule():
    built = _port_built({**CONFIG, "svgd_particles": 2, "augment": True})
    (x, y), = _batches(1)
    xt, yt = nchw(x), torch.from_numpy(y)
    noise = NoiseSource.seeded(0)
    built.state, m = built.method.update(built.state, noise, (xt, yt))
    assert math.isfinite(float(m["loss"]))
    # the port's SGD: momentum in one flat buffer, the schedule's count on the device
    optimizer, _ = built.state.opt_state
    params = {k: p.detach().clone() for k, p in built.state.params.named_parameters()}
    momentum = optimizer.trace.clone()
    count = int(optimizer.count)
    assert count == 1 and bool(momentum.abs().sum() > 0)

    bad = xt.clone()
    bad[0] = float("nan")  # the whole image, so no crop misses it
    built.state, m = built.method.update(built.state, noise, (bad, yt))
    assert not math.isfinite(float(m["loss"]))
    assert built.state.step == 2
    assert int(optimizer.count) == count
    assert torch.equal(optimizer.trace, momentum)
    for k, p in built.state.params.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


@pytest.mark.parametrize("h_override", [None, 5.0], ids=["median", "h_override"])
def test_rbf_matches_jax(h_override):
    x = np.random.RandomState(3).standard_normal((6, 40)).astype(np.float32)
    kernel, grad_kernel = jax_rbf(jnp.asarray(x), h_override=h_override)
    got_kernel, got_grad = rbf(torch.from_numpy(x), h_override=h_override)
    assert_close(got_kernel.numpy(), np.asarray(kernel), rtol=0, atol=1e-5, err_msg="K")
    top = float(np.abs(np.asarray(grad_kernel)).max())
    assert_close(got_grad.numpy() / top, np.asarray(grad_kernel) / top, rtol=0, atol=1e-5, err_msg="grad K")


def test_tree_helpers():
    net = cifar._resnet(CONFIG, torch.Generator().manual_seed(0), "plain")
    flat = tree.ravel(net)
    assert flat.shape == (273_610,)  # ResNet-20 FRN, the JAX tree's size
    views = tree.make_unravel(net)(flat)
    assert list(views) == [k for k, _ in net.named_parameters()]
    for k, p in net.named_parameters():
        assert torch.equal(views[k], p.detach()), k
    assert views["Conv_0.kernel"].data_ptr() == flat.data_ptr()  # views, no copy
    with pytest.raises(ValueError):
        tree.make_unravel(net)(flat[:-1])

    # the same values as the JAX ravel, in another order (module order, not
    # alphabetical, and OIHW kernels)
    params = random_jax_params(jax_cifar._resnet(CONFIG).module, (2, 32, 32, 3), seed=4)
    load_jax_params(net, params)
    np.testing.assert_array_equal(np.sort(tree.ravel(net).numpy()), np.sort(np.asarray(jax_ravel(params))))

    stacked = tree.tree_stack([net, dict(net.named_parameters())])
    assert stacked["Dense_0.kernel"].shape == (2, 10, 64)
    assert torch.equal(stacked["Dense_0.kernel"][1], net.Dense_0.kernel.detach())


def test_run_single_on_cpu():
    """The svgd slice end to end through its entry point, at a tiny size."""
    config = {
        "model": "svgd", "svgd_particles": 2, "subsample": 64, "test_subsample": 30,
        "epochs": 1, "batch_size": 32, "eval_batch_size": 20, "eval_samples": 3,
    }
    res = cifar.run_single(config, device="cpu")["test"]
    assert set(res) == {"accuracy", "avg_log_likelihood", "avg_likelihood", "ece", "signed_ece"}
    assert all(math.isfinite(v) for v in res.values())
    assert 0.0 <= res["accuracy"] <= 1.0 and res["avg_log_likelihood"] < 0.0


def test_particles_initialized_in_turn_and_distinct():
    built = _port_built()
    flats = [tree.ravel(p) for p in built.state.params]
    assert len(flats) == PARTICLES and not torch.equal(flats[0], flats[1])
    gen = torch.Generator().manual_seed(0)
    first = cifar._resnet(CONFIG, gen, "plain")
    assert torch.equal(tree.ravel(first), flats[0])
    assert torch.equal(tree.ravel(cifar._resnet(CONFIG, gen, "plain")), flats[1])
    assert built.state.model_state == {}
    method = built.method
    assert method.sample(built.state, None, 4)[0] is built.state.params[4 % PARTICLES]
