"""PyTorch port, the Rank-1 slice: ``nn/rank1.py`` (``Rank1Dense``,
``Rank1Conv``), ``ResNet20(conv_kind="rank1")``, ``bbb_method`` with
``components`` and ``l2_scale``, ``predict`` with components, and
``nn/convert.py``, held against the JAX package on the CPU with the JAX
draws given: the JAX layers' ``jax.random.normal`` is wrapped so that each
draw is also recorded (``jax.debug.callback``, in program order, which
holds under ``jit``; under ``vmap`` the callback runs once per sample, the
samples of one draw site together).

Tolerances: layer outputs and gradients 1e-5 (relative and absolute, fp32
sums in other orders), ResNet-20 logits 1e-5 absolute, the three BBB steps'
metrics 1e-5 relative and parameters 1e-6 absolute (their gap is 6e-8; lr
0.05),
``predict``'s log-probs 1e-6; the converters and the component counter are
held to equality."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from _torch_parity import (assert_close, flat_jax, load_jax_params, nchw,
                           random_jax_params, record_jax_normals)
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import GaussianPrior as JaxGaussianPrior
from beyond_deep_ensembles_tpu.methods import bbb_method as jax_bbb_method
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu.methods import predict as jax_predict
from beyond_deep_ensembles_tpu.models.resnet import ResNet20 as JaxResNet20
from beyond_deep_ensembles_tpu.nn import convert as jax_convert
from beyond_deep_ensembles_tpu.nn import rank1 as jax_rank1
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods import predict
from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior, LossOutput
from beyond_deep_ensembles_tpu_torch.methods.bbb import MixtureState, bbb_method
from beyond_deep_ensembles_tpu_torch.methods.map import map_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20
from beyond_deep_ensembles_tpu_torch.nn import convert
from beyond_deep_ensembles_tpu_torch.nn.base import Model, add_auto_named
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.nn.rank1 import Rank1Conv, Rank1Dense
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

TOL = {"rtol": 1e-5, "atol": 1e-5}
GEN = torch.Generator().manual_seed(0)


@pytest.fixture
def draws(monkeypatch):
    """The JAX Rank-1 layers' normals, recorded as they are drawn."""
    return record_jax_normals(monkeypatch, jax_rank1)


def _grads_to_port(tree):
    return {k: v.numpy() for k, v in params_from_jax({k: np.asarray(v) for k, v in tree.items()}).items()}


@pytest.mark.parametrize("component", [0, 2])
@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_rank1_layer_matches_jax(kind, component, draws):
    """Output, input gradient and parameter gradients of one training
    forward of component ``component`` of 3, one draw of s and r."""
    rng = np.random.RandomState(1)
    if kind == "dense":
        jmod = jax_rank1.Rank1Dense(5, components=3)
        x = rng.standard_normal((4, 6)).astype(np.float32)
        port = Rank1Dense(6, 5, components=3, generator=GEN)
    else:
        jmod = jax_rank1.Rank1Conv(4, (3, 3), strides=2, padding=1, components=3)
        x = rng.standard_normal((2, 7, 7, 3)).astype(np.float32)
        port = Rank1Conv(3, 4, (3, 3), strides=2, padding=1, components=3, generator=GEN)
    params = random_jax_params(jmod, x.shape, seed=2)
    out_shape = jax.eval_shape(lambda: jmod.apply({"params": params}, x, component=component,
                                                  rngs={"noise": jax.random.key(0)})).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)

    def loss(p, xx):
        out = jmod.apply({"params": p}, xx, train=True, component=component, rngs={"noise": jax.random.key(3)})
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    jax.effects_barrier()
    assert [d.shape for d in draws] == [(x.shape[-1],), (out_shape[-1],)]

    load_jax_params(port, params)
    xt = nchw(x).requires_grad_(True)
    got = port(xt, NoiseSource(given=[torch.from_numpy(d) for d in draws]), train=True, component=component)
    (got * nchw(cot)).sum().backward()
    assert_close(got.detach().numpy(), nchw(np.asarray(want)).numpy(), **TOL, err_msg="output")
    assert_close(xt.grad.numpy(), nchw(np.asarray(gx)).numpy(), **TOL, err_msg="input grad")
    ref = _grads_to_port(gp)
    for name, p in port.named_parameters():
        assert_close(p.grad.numpy(), ref[name], **TOL, err_msg=name)


@functools.lru_cache(maxsize=None)
def _rank1_resnet():
    """JAX's Rank-1 ResNet-20 (4 components) at eval, its parameters and
    input, jitted once for the four components (the component a traced
    argument)."""
    jmodel = JaxModel(JaxResNet20(10, "swish", "frn", conv_kind="rank1", components=4))
    params = random_jax_params(jmodel.module, (2, 32, 32, 3), seed=4)
    x = np.random.RandomState(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    apply = jax.jit(lambda p, c: jmodel.apply(p, {}, jax.random.key(6), jnp.asarray(x), train=False, component=c)[0])
    return params, x, apply


@pytest.mark.parametrize("component", [0, 1, 2, 3])
def test_resnet20_rank1_logits_per_component_match_jax(component, draws):
    """The eval logits of each of the 4 components: every layer of the
    forward runs the one component (the joint component of JAX
    ``methods/ensemble.py:85-94``)."""
    params, x, apply = _rank1_resnet()
    want = np.asarray(apply(params, component))
    jax.effects_barrier()
    assert len(draws) == 2 * 22

    net = load_jax_params(ResNet20(10, "swish", "frn", "rank1", components=4, generator=GEN), params)
    with torch.no_grad():
        got = net(nchw(x), NoiseSource(given=[torch.from_numpy(d) for d in draws]), train=False, component=component)
    assert_close(got.numpy(), want, atol=1e-5, rtol=0, err_msg=f"component {component}")


CONFIG = {**jax_cifar.DEFAULT_CONFIG, "model": "rank1", "members": 1, "prior_std": 0.1, "rank1_components": 4,
          "rank1_l2_scale": 0.0003, "rank1_kl_rescaling": 1.0, "epochs": 2, "dataset_size": 1000, "augment": False}


def test_three_rank1_bbb_steps_match_jax(draws):
    """``bbb_method(components=4, mc_samples=2, l2_scale=3e-4)``, jitted in
    JAX: three steps run the components (0, 1), (2, 3), (0, 1) (base =
    step * mc % C), the loss divides the data term by mc * C, the KL covers
    all four components and the L2 the plain parameters."""
    jmodel = jax_cifar._resnet(CONFIG, conv_kind="rank1", components=4)
    method = jax_bbb_method(
        jax_cifar._xent_loss_fn(jmodel, augment=False), jax_cifar._base_tx(CONFIG, 1),
        JaxGaussianPrior(0.0, CONFIG["prior_std"]), dataset_size=CONFIG["dataset_size"],
        mc_samples=2, components=4, kl_rescaling=1.0, l2_scale=0.0003,
    )
    params = random_jax_params(jmodel.module, (2, 32, 32, 3), seed=7)
    params = jax.tree_util.tree_map_with_path(  # the +-1 factor means
        lambda path, v: jnp.sign(v) if str(path[-1].key) in ("s__gmean", "r__gmean") else v, params)
    state = method.init(jax.random.key(0), params, {})
    rng = np.random.RandomState(8)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32), rng.randint(0, 10, 4)) for _ in range(3)]
    update = jax.jit(method.update)
    want = []
    for i, (x, y) in enumerate(batches):
        state, m = update(state, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        want.append({k: float(v) for k, v in m.items()})
    jax.effects_barrier()
    assert len(draws) == 3 * 2 * 44

    built = cifar.build(CONFIG, torch.Generator().manual_seed(0), 1, device="cpu")
    assert isinstance(built.state, MixtureState)
    load_jax_params(built.state.params, params)
    noise = NoiseSource(given=[torch.from_numpy(d) for d in draws])
    for (x, y), ref in zip(batches, want):
        built.state, m = built.method.update(built.state, noise, (nchw(x), torch.from_numpy(y)))
        for k in ("loss", "data_loss", "kl"):
            assert_close(float(m[k]), ref[k], rtol=1e-5, err_msg=k)
    assert noise.draws == len(draws) and int(built.state.updates) == 3 == int(state.step)
    ref = flat_jax(state.params)
    for k, p in built.state.params.named_parameters():
        assert_close(p.detach().numpy(), ref[k], atol=1e-6, rtol=0, err_msg=k)


class JaxMLP(fnn.Module):
    components: int

    @fnn.compact
    def __call__(self, x, train: bool = True, component=None):
        h = jax.nn.relu(jax_rank1.Rank1Dense(8, components=self.components)(x, train, component))
        return jax_rank1.Rank1Dense(3, components=self.components)(h, train, component)


class TorchMLP(torch.nn.Module):
    def __init__(self, components):
        super().__init__()
        add_auto_named(self, Rank1Dense(4, 8, components, generator=GEN))
        add_auto_named(self, Rank1Dense(8, 3, components, generator=GEN))

    def forward(self, x, noise, train=True, component=None):
        h = torch.relu(self.Rank1Dense_0(x, noise, train, component))
        return self.Rank1Dense_1(h, noise, train, component)


@pytest.mark.parametrize("n_samples", [3, 6])
def test_predict_with_components_matches_jax(n_samples, draws):
    """``predict(..., components=4)`` of a sample-in-forward method: sample
    i runs component i % 4 in both layers, each sample its own draws."""
    jmodel = JaxModel(JaxMLP(4))
    params = random_jax_params(jmodel.module, (5, 4), seed=9)
    x = np.random.RandomState(10).standard_normal((5, 4)).astype(np.float32)

    def apply_fn(p, ms, key, xx, component=None):
        return jax.nn.log_softmax(jmodel.apply(p, ms, key, xx, train=False, component=component)[0], axis=-1)

    jmethod = jax_map_method(None, optax.sgd(0.1))
    state = jmethod.init(jax.random.key(0), params, {})
    want = jax.jit(lambda s, k: jax_predict(jmethod, s, apply_fn, jnp.asarray(x), n_samples, k, components=4))(
        state, jax.random.key(11))
    jax.effects_barrier()
    sites = 4  # s and r of each layer
    assert len(draws) == sites * n_samples
    per_sample = [torch.from_numpy(draws[site * n_samples + i]) for i in range(n_samples) for site in range(sites)]

    net = load_jax_params(TorchMLP(4), params)
    model = Model(net)
    method = map_method(None, lambda p: (SGD(p, 0.1), None))

    def port_apply(p, ms, noise, xx, component=None):
        return torch.log_softmax(model.apply(p, ms, noise, xx, train=False, component=component)[0], dim=-1)

    with torch.no_grad():
        got = predict(method, method.init(net), port_apply, torch.from_numpy(x), n_samples,
                      NoiseSource(given=per_sample), components=4)
    assert got.shape == (n_samples, 5, 3)
    assert_close(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6, err_msg="predict")


def test_components_come_from_the_device_counter():
    """The step's components come from ``updates`` (a device tensor the
    update advances), not the host ``step`` that a runner sets back after
    its warm-up: with ``step`` reset to 0 after every update, four updates
    still run components 0 .. 3 twice over (mc 2), and a skipped (NaN)
    update counts."""
    seen = []

    def loss_fn(params, model_state, noise, batch, component=None):
        seen.append(component.clone())
        out = params(batch[0], noise, train=True, component=component)
        return LossOutput(loss=torch.mean(out ** 2))

    net = TorchMLP(4)
    method = bbb_method(loss_fn, lambda p: (SGD(p, 0.1), None), GaussianPrior(0.0, 1.0), 100, mc_samples=2,
                        components=4)
    state = method.init(net)
    x = torch.randn(3, 4, generator=GEN)
    for i in range(4):
        xb = torch.full_like(x, float("nan")) if i == 1 else x
        state, _ = method.update(state, NoiseSource.seeded(i), (xb,))
        state.step = 0
    assert [int(c) for c in seen] == [0, 1, 2, 3, 0, 1, 2, 3] and int(state.updates) == 4
    assert all(c.dtype == torch.int64 and c.ndim == 0 for c in seen)
    with pytest.raises(ValueError, match="explicit component"):
        net(x, NoiseSource.seeded(0))


class JaxPlainMLP(fnn.Module):
    kind: str

    @fnn.compact
    def __call__(self, x, train: bool = True):
        from beyond_deep_ensembles_tpu.models.layers import call_layer, make_dense

        h = jax.nn.relu(call_layer(make_dense(self.kind, 8), x, train))
        return call_layer(make_dense(self.kind, 8), h, train)


def _torch_mlp(kind):
    from beyond_deep_ensembles_tpu_torch.models.layers import make_dense

    net = torch.nn.Module()
    add_auto_named(net, make_dense(kind, 4, 8, generator=GEN))
    add_auto_named(net, make_dense(kind, 8, 8, generator=GEN))
    return net


def _converted(kind, arch):
    """(the port's converted state_dict, the JAX package's merged tree in
    the port's layout) for ``kind`` in bbb/rank1 over ``arch`` in
    mlp/resnet."""
    components = 4 if kind == "rank1" else 1
    if arch == "mlp":
        jplain, jbayes, shape = JaxPlainMLP("plain"), JaxPlainMLP(kind), (2, 4)
        plain, bayes = _torch_mlp("plain"), _torch_mlp(kind)
    else:
        jplain = JaxResNet20(10, "swish", "frn")
        jbayes = JaxResNet20(10, "swish", "frn", conv_kind=kind, components=components)
        shape = (2, 32, 32, 3)
        plain = ResNet20(10, "swish", "frn", "plain", generator=GEN)
        bayes = ResNet20(10, "swish", "frn", kind, components=components, generator=GEN)
    plain_params, bayes_params = random_jax_params(jplain, shape, seed=12), random_jax_params(jbayes, shape, seed=13)
    fn = jax_convert.init_bbb_from_plain if kind == "bbb" else jax_convert.init_rank1_from_plain
    want = flat_jax(fn(bayes_params, plain_params))
    load_jax_params(plain, plain_params)
    load_jax_params(bayes, bayes_params)
    port_fn = convert.init_bbb_from_plain if kind == "bbb" else convert.init_rank1_from_plain
    return {k: v.numpy() for k, v in port_fn(bayes, plain).state_dict().items()}, want, dict(plain.state_dict())


@pytest.mark.parametrize("arch", ["mlp", "resnet"])
@pytest.mark.parametrize("kind", ["bbb", "rank1"])
def test_convert_from_plain_matches_jax(kind, arch):
    """``init_bbb_from_plain`` / ``init_rank1_from_plain``: the port's
    converted state_dict equals the JAX package's merged tree, converted.
    One difference, on BBB ResNet-20: the JAX rule takes same-shape plain
    leaves in its sorted-key order, where the stem ``BBBConv_0`` comes
    before every block but ``Conv_0`` after them, so the 16-wide conv
    biases shift by one layer (the stem's mean takes the first block's
    bias); the port takes them in the module's order, each layer its own
    (ROADMAP queue 3)."""
    got, want, plain = _converted(kind, arch)
    assert got.keys() == want.keys()
    shifted = set()
    if kind == "bbb" and arch == "resnet":
        shifted = {k for k in got if k.endswith("bias__gmean") and got[k].shape == (16,)}
        assert len(shifted) == 7  # the stem and the two convs of the first three blocks
        for k in shifted:
            np.testing.assert_array_equal(got[k], plain[k.replace("BBBConv", "Conv").replace("__gmean", "")], err_msg=k)
            assert not np.array_equal(got[k], want[k])
    for k in got.keys() - shifted:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if kind == "rank1":  # a bias row per component from a plain [out] bias
        layer = Rank1Dense(2, 3, components=4, generator=GEN)
        src = {"bias": torch.arange(3.0), "kernel": torch.ones(3, 2)}
        convert.init_rank1_from_plain(layer, src)
        assert torch.equal(layer.bias, torch.arange(3.0).expand(4, 3)) and torch.equal(layer.kernel, src["kernel"])
