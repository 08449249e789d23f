"""PyTorch port, nn/bbb.py, nn/frn.py, nn/convops.py, models/layers.py:
BBBConv (3x3 pad 1 with bias; 1x1 stride 2 without), BBBDense, FRN and
variational FRN held against the JAX layers on converted weights and the same
noise, in train and eval; the plain Conv and Dense of ``make_conv`` /
``make_dense`` the same way, and their lecun-normal init against flax's.
Outputs, and gradients with respect to every parameter (mean and rho) and
the input.

Tolerance: fp32, 1e-5 relative and absolute (convolutions and their weight
gradients sum in another order on each side)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_jax, install_feed, load_jax_params, nchw, torch_noise
from beyond_deep_ensembles_tpu.models import layers as jax_layers
from beyond_deep_ensembles_tpu.nn import bbb as jax_bbb
from beyond_deep_ensembles_tpu.nn import frn as jax_frn
from beyond_deep_ensembles_tpu_torch.models import layers
from beyond_deep_ensembles_tpu_torch.nn import bbb, convops, frn
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

TOL = dict(rtol=1e-5, atol=1e-5)
GEN = torch.Generator().manual_seed(0)

LAYERS = {
    "conv3x3_pad1_bias": (
        lambda: jax_bbb.BBBConv(6, (3, 3), strides=1, padding=1),
        lambda: bbb.BBBConv(4, 6, (3, 3), strides=1, padding=1, generator=GEN),
        (2, 8, 8, 4),
    ),
    "conv1x1_stride2_nobias": (
        lambda: jax_bbb.BBBConv(6, (1, 1), strides=2, padding=0, use_bias=False),
        lambda: bbb.BBBConv(4, 6, (1, 1), strides=2, padding=0, use_bias=False, generator=GEN),
        (2, 8, 8, 4),
    ),
    "dense": (
        lambda: jax_bbb.BBBDense(5),
        lambda: bbb.BBBDense(7, 5, generator=GEN),
        (3, 7),
    ),
    "frn": (
        lambda: jax_frn.FilterResponseNorm(),
        lambda: frn.FilterResponseNorm(4),
        (2, 5, 5, 4),
    ),
    "vfrn": (
        lambda: jax_frn.VariationalFilterResponseNorm(),
        lambda: frn.VariationalFilterResponseNorm(4, generator=GEN),
        (2, 5, 5, 4),
    ),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_jax(monkeypatch, name, train):
    make_jax, make_port, shape = LAYERS[name]
    rng = np.random.RandomState(0)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    params = jmod.init({"params": jax.random.key(0), "noise": jax.random.key(1)}, jnp.asarray(x))["params"]
    # move every leaf off its initializer so zeros/ones inits are exercised too
    params = jax.tree.map(lambda p: p + 0.1 * jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)

    feed = install_feed(monkeypatch)
    out_shape = jmod.apply({"params": params}, jnp.asarray(x), train=train).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    feed.draws.clear()

    def f(p, xx):
        out = jmod.apply({"params": p}, xx, train=train)
        return jnp.sum(out * g), out

    (_, ref), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    port = load_jax_params(make_port(), params)
    xt = nchw(x).requires_grad_(True)
    noise = torch_noise(feed.draws)
    out = port(xt, noise, train=train)
    assert noise.draws == len(feed.draws)
    assert_close(out.detach().numpy(), nchw(np.asarray(ref)).numpy(), **TOL)
    (out * nchw(g)).sum().backward()
    assert_close(xt.grad.numpy(), nchw(np.asarray(gx)).numpy(), **TOL)
    want = flat_jax(gp)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert grads.keys() == want.keys()
    for k in want:
        assert_close(grads[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize(
    "padding,strides",
    [(1, (1, 1)), ("VALID", (1, 1)), ("SAME", (2, 2)), (((1, 2), (0, 1)), (1, 2))],
)
def test_conv2d_padding_forms(padding, strides):
    from beyond_deep_ensembles_tpu.nn.convops import conv2d as jax_conv2d

    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 9, 7, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    jpad = [(padding, padding)] * 2 if isinstance(padding, int) else padding
    ref = jax_conv2d(jnp.asarray(x), jnp.asarray(w), strides, jpad)
    got = convops.conv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), strides, padding)
    assert_close(got.numpy(), nchw(np.asarray(ref)).numpy(), **TOL)


def test_sampling_parameters_mode_not_ported():
    """``sampling="parameters"`` builds and draws (held against JAX in
    tests/test_torch_lowrank_params.py); an unknown mode raises."""
    layer = bbb.BBBDense(3, 2, sampling="parameters", generator=GEN)
    assert layer(torch.randn(4, 3), NoiseSource.seeded(0)).shape == (4, 2)
    with pytest.raises(ValueError):
        bbb.BBBDense(3, 2, sampling="weights", generator=GEN)


PLAIN = {
    "conv3x3_pad1_bias": (
        lambda: jax_layers.make_conv("plain", 6, (3, 3), strides=1, padding=1),
        lambda: layers.make_conv("plain", 4, 6, (3, 3), strides=1, padding=1, generator=GEN),
        (2, 8, 8, 4),
    ),
    "conv1x1_stride2_nobias": (
        lambda: jax_layers.make_conv("plain", 6, (1, 1), strides=2, padding=0, use_bias=False),
        lambda: layers.make_conv("plain", 4, 6, (1, 1), strides=2, padding=0, use_bias=False, generator=GEN),
        (2, 8, 8, 4),
    ),
    "dense": (
        lambda: jax_layers.make_dense("plain", 5),
        lambda: layers.make_dense("plain", 7, 5, generator=GEN),
        (3, 7),
    ),
}


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_layer_matches_jax(name):
    make_jax, make_port, shape = PLAIN[name]
    rng = np.random.RandomState(2)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = make_jax()
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda p: p + 0.1 * jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)
    out_shape = jmod.apply({"params": params}, jnp.asarray(x)).shape
    g = rng.standard_normal(out_shape).astype(np.float32)

    def f(p, xx):
        out = jmod.apply({"params": p}, xx)
        return jnp.sum(out * g), out

    (_, ref), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    port = load_jax_params(make_port(), params)
    xt = nchw(x).requires_grad_(True)
    out = layers.call_layer(port, xt, None, train=True)
    assert_close(out.detach().numpy(), nchw(np.asarray(ref)).numpy(), **TOL)
    (out * nchw(g)).sum().backward()
    assert_close(xt.grad.numpy(), nchw(np.asarray(gx)).numpy(), **TOL)
    want = flat_jax(gp)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert grads.keys() == want.keys()
    for k in want:
        assert_close(grads[k], want[k], err_msg=k, **TOL)


def test_plain_init_is_flax_lecun_normal():
    """Kernels: truncated at two standard deviations, variance 1/fan_in, as
    flax draws them (std within 3 %, over 36,864 and 40,960 draws); biases
    zero."""
    conv = layers.Conv(64, 64, (3, 3), generator=torch.Generator().manual_seed(0))
    dense = layers.Dense(64, 640, generator=torch.Generator().manual_seed(1))
    jconv = jax_layers.Conv(64, (3, 3)).init(jax.random.key(0), jnp.zeros((1, 8, 8, 64)))["params"]
    jdense = jax_layers.make_dense("plain", 640).init(jax.random.key(1), jnp.zeros((1, 64)))["params"]
    for port, ref, fan_in in ((conv, jconv, 576), (dense, jdense, 64)):
        w = port.kernel.detach().numpy()
        std = fan_in**-0.5
        edge = 2 * std / 0.87962566103423978
        assert np.abs(w).max() <= edge and np.abs(w).max() > 0.95 * edge
        assert abs(w.std() / std - 1) < 0.03
        assert abs(w.std() / np.asarray(ref["kernel"]).std() - 1) < 0.03
        assert not port.bias.detach().any() and not np.asarray(ref["bias"]).any()
