"""PyTorch port, methods/bbb.py + experiments/cifar.py (loss, optimizer,
schedule): three BBB steps of ResNet-20 from the same weights on the same
batches and the same noise, no augmentation, held against the JAX method.
``jax.disable_jit`` makes the JAX MC loop call the noise feed once per
sample, so each of the 2 x 76 draws of a step is its own array.

The config exercises weight decay and the Wilson schedule: with
steps_per_epoch=1 and 2 epochs the third step runs at lr * 0.01.

Tolerances: metrics 1e-5 relative; parameters 2e-5 absolute after three
SGD steps (gradients agree to about 1e-5 relative, the lr is 0.05)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_jax, install_feed, load_jax_params, nchw, random_jax_params, torch_noise
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import GaussianPrior as JaxGaussianPrior
from beyond_deep_ensembles_tpu.methods import bbb_method as jax_bbb_method
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

CONFIG = {
    **jax_cifar.DEFAULT_CONFIG,
    "model": "bbb",
    "weight_decay": 3e-4,
    "epochs": 2,
    "dataset_size": 1000,
    "augment": False,
}
STEPS_PER_EPOCH = 1
DRAWS_PER_STEP = 2 * (22 + 18 * 3)


def _batches(n_steps, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (rng.standard_normal((batch, 32, 32, 3)).astype(np.float32), rng.randint(0, 10, batch))
        for _ in range(n_steps)
    ]


def _port_built():
    return cifar.build(CONFIG, torch.Generator().manual_seed(0), STEPS_PER_EPOCH, device="cpu")


def test_three_bbb_steps_match_jax(monkeypatch):
    model = jax_cifar._resnet(CONFIG, conv_kind="bbb")
    method = jax_bbb_method(
        jax_cifar._xent_loss_fn(model, augment=False),
        jax_cifar._base_tx(CONFIG, STEPS_PER_EPOCH),
        JaxGaussianPrior(0.0, CONFIG["prior_std"]),
        dataset_size=CONFIG["dataset_size"],
        mc_samples=CONFIG["bbb_mc_samples"],
        kl_rescaling=CONFIG["kl_rescaling"],
    )
    params = random_jax_params(model.module, (2, 32, 32, 3))
    state = method.init(jax.random.key(0), params, {})
    batches = _batches(3)
    feed = install_feed(monkeypatch, seed=3)
    jax_metrics = []
    with jax.disable_jit():
        for i, (x, y) in enumerate(batches):
            state, m = method.update(state, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
            jax_metrics.append({k: float(v) for k, v in m.items()})
    assert len(feed.draws) == 3 * DRAWS_PER_STEP

    built = _port_built()
    load_jax_params(built.state.params, params)
    noise = torch_noise(feed.draws)
    for (x, y), want in zip(batches, jax_metrics):
        built.state, m = built.method.update(built.state, noise, (nchw(x), torch.from_numpy(y)))
        for k in ("loss", "data_loss", "kl"):
            assert_close(float(m[k]), want[k], rtol=1e-5, err_msg=k)
    assert noise.draws == len(feed.draws)
    assert built.state.step == 3

    ref = flat_jax(state.params)
    got = {k: p.detach().numpy() for k, p in built.state.params.named_parameters()}
    assert got.keys() == ref.keys()
    for k in ref:
        assert_close(got[k], ref[k], atol=2e-5, rtol=0, err_msg=k)


def test_nonfinite_loss_skips_params_momentum_and_schedule():
    built = _port_built()
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
    bad[0, 0, 0, 0] = float("nan")
    built.state, m = built.method.update(built.state, noise, (bad, yt))
    assert not math.isfinite(float(m["loss"]))
    assert built.state.step == 2
    assert int(optimizer.count) == count
    assert torch.equal(optimizer.trace, momentum)
    for k, p in built.state.params.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


def test_run_single_on_cpu():
    """The slice end to end through its entry point, at a tiny size: the
    last partial eval batch is padded and trimmed."""
    config = {
        "model": "bbb", "members": 1, "prior_std": 1.0, "weight_decay": 0.0,
        "bbb_mc_samples": 2, "kl_rescaling": 0.2, "subsample": 64, "test_subsample": 30,
        "epochs": 1, "batch_size": 32, "eval_batch_size": 20, "eval_samples": 2,
    }
    res = cifar.run_single(config, device="cpu")["test"]
    assert set(res) == {"accuracy", "avg_log_likelihood", "avg_likelihood", "ece", "signed_ece"}
    assert all(math.isfinite(v) for v in res.values())
    assert 0.0 <= res["accuracy"] <= 1.0 and res["avg_log_likelihood"] < 0.0


@pytest.mark.parametrize("model", ["ivon", "laplace", "rank1", "sngp"])
def test_other_variants_not_ported(model):
    """The other variants build since their port; the options not ported
    with them still raise before any work is done."""
    cifar.build({**CONFIG, "model": model}, torch.Generator(), device="cpu")
    for key in ("bf16", "use_hmc_baseline", "data_parallel"):
        with pytest.raises(NotImplementedError, match=key):
            cifar.build({**CONFIG, "model": model, key: True}, torch.Generator(), device="cpu")


@pytest.mark.parametrize("model", ["svgd"])
def test_members_not_ported(model):
    """An ensemble of SVGD particle sets (no configs/cifar.yaml row; the JAX
    build ignores ``members`` there) raises; MultiBBB is ported."""
    with pytest.raises(NotImplementedError, match="members"):
        cifar.build({**CONFIG, "model": model, "members": 2}, torch.Generator(), device="cpu")
