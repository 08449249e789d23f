"""PyTorch port, models/resnet.py (``PreResNet20``, ``PreBasicBlock``,
ResNet-20's ``head_kind`` and ``features_only``), held against the JAX
package's models on converted weights and the same draws, on the CPU
(plain, BBB and MC-Dropout in training and at eval, Rank-1 in training).
MidasTiramisu: tests/test_torch_tiramisu.py.

Tolerance: PreResNet-20 and ResNet-20 logits and features within 1e-4
absolute (fp32 through 21 convolutions, as tests/test_torch_resnet.py holds
ResNet-20's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, install_feed, load_jax_params, nchw, random_jax_params,
                           record_jax_normals, torch_noise)
from beyond_deep_ensembles_tpu.models.resnet import PreResNet20 as JaxPreResNet20
from beyond_deep_ensembles_tpu.models.resnet import ResNet20 as JaxResNet20
from beyond_deep_ensembles_tpu.nn import rank1 as jax_rank1
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.models import PreResNet20, ResNet20
from beyond_deep_ensembles_tpu_torch.models.resnet import PreBasicBlock
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

P = 0.1
GEN = torch.Generator().manual_seed(0)


class BernoulliFeed:
    """Stands in for ``jax.random.bernoulli``: masks from a seeded numpy
    generator, recorded in call order."""

    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)
        self.masks = []

    def __call__(self, key, p=0.5, shape=None):
        del key
        mask = self.rng.rand(*shape) < p
        self.masks.append(mask)
        return jnp.asarray(mask)


def _x(shape=(3, 32, 32, 3), seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind, train", [(kind, train) for kind in ("plain", "bbb", "rank1", "mcd")
                                         for train in (True, False) if kind != "rank1" or train],
                         ids=lambda v: v if isinstance(v, str) else ("train" if v else "eval"))
def test_preresnet20_logits_match_jax(kind, train, monkeypatch):
    conv_kind = "plain" if kind == "mcd" else kind
    dropout_p = P if kind == "mcd" else None
    components = 2 if kind == "rank1" else 1
    module = JaxPreResNet20(classes=10, conv_kind=conv_kind, dropout_p=dropout_p, components=components)
    params = random_jax_params(module, (2, 32, 32, 3), seed=3)
    x = _x()
    kwargs = {"component": 1} if kind == "rank1" else {}
    draws = None
    if kind == "bbb":
        feed = install_feed(monkeypatch, seed=4)
    elif kind == "rank1":
        draws = record_jax_normals(monkeypatch, jax_rank1)
    elif kind == "mcd":
        feed = BernoulliFeed(seed=5)
        monkeypatch.setattr(jax.random, "bernoulli", feed)
    # jitted: the numpy feeds run once, at trace time, and their draws are the
    # program's constants
    want, _, _ = jax.jit(lambda p, x: JaxModel(module).apply(p, {}, jax.random.key(2), x, train=train, **kwargs))(
        params, jnp.asarray(x))
    jax.effects_barrier()
    if kind == "bbb":
        noise = torch_noise(feed.draws)
        assert len(feed.draws) == 22
    elif kind == "rank1":
        noise = NoiseSource(given=[torch.from_numpy(np.array(d)) for d in draws])
    elif kind == "mcd":
        noise = NoiseSource(given=[nchw(m) for m in feed.masks])
        assert len(feed.masks) == 9 * 2 + 2  # two per block, the two projection skips
    else:
        noise = NoiseSource.seeded(0)
    net = load_jax_params(PreResNet20(10, conv_kind=conv_kind, dropout_p=dropout_p, components=components,
                                      generator=GEN), params)
    with torch.no_grad():
        got = net(nchw(x), noise, train=train, **kwargs)
    if kind != "plain":
        assert noise.draws == len(noise._given)
    assert_close(got.numpy(), np.asarray(want), rtol=0, atol=1e-4, err_msg=f"PreResNet20 {kind} train={train}")


@pytest.mark.parametrize("arch", ["resnet20", "preresnet20"])
@pytest.mark.parametrize("size", [32, 16])
def test_features_only_and_the_32_pixel_rule(arch, size):
    """``features_only`` returns the pooled features from 32 pixels up and
    the unpooled ones (NHWC order) below, as JAX does."""
    if arch == "resnet20":
        jmod = JaxResNet20(classes=10, activation="swish", norm="frn", features_only=True)
        net = ResNet20(10, "swish", "frn", "plain", features_only=True, generator=GEN)
    else:
        jmod = JaxPreResNet20(classes=10, features_only=True)
        net = PreResNet20(10, features_only=True, generator=GEN)
    params = random_jax_params(jmod, (2, size, size, 3), seed=6)
    x = _x((2, size, size, 3), seed=7)
    want, _, _ = jax.jit(lambda p, x: JaxModel(jmod).apply(p, {}, None, x, train=True))(params, jnp.asarray(x))
    load_jax_params(net, params)
    with torch.no_grad():
        got = net(nchw(x), NoiseSource.seeded(0), train=True)
    assert got.shape == want.shape == (2, 64 if size >= 32 else 64 * (size // 4) ** 2)
    assert_close(got.numpy(), np.asarray(want), rtol=0, atol=1e-4, err_msg=f"{arch} features at {size}")


@pytest.mark.parametrize("arch", ["resnet20", "preresnet20"])
def test_head_kind(arch, monkeypatch):
    """A plain trunk under a BBB head (``head_kind``): one draw, the head's."""
    if arch == "resnet20":
        jmod = JaxResNet20(classes=10, activation="swish", norm="frn", head_kind="bbb")
        net = ResNet20(10, "swish", "frn", "plain", head_kind="bbb", generator=GEN)
    else:
        jmod = JaxPreResNet20(classes=10, head_kind="bbb")
        net = PreResNet20(10, head_kind="bbb", generator=GEN)
    params = random_jax_params(jmod, (2, 32, 32, 3), seed=8)
    x = _x(seed=9)
    feed = install_feed(monkeypatch, seed=10)
    want, _, _ = jax.jit(lambda p, x: JaxModel(jmod).apply(p, {}, jax.random.key(0), x, train=True))(
        params, jnp.asarray(x))
    assert [d.shape for d in feed.draws] == [(3, 10)]
    assert any(k.startswith("BBBDense_0") for k in net.state_dict())
    load_jax_params(net, params)
    with torch.no_grad():
        got = net(nchw(x), torch_noise(feed.draws), train=True)
    assert_close(got.numpy(), np.asarray(want), rtol=0, atol=1e-4, err_msg=f"{arch} bbb head")


def test_preresnet20_flax_names():
    names = list(PreResNet20(10, dropout_p=P, generator=GEN).state_dict())
    assert names[:2] == ["Conv_0.kernel", "Conv_0.bias"]
    assert "PreBasicBlock_3.Conv_2.kernel" in names and "PreBasicBlock_3.Conv_2.bias" not in names
    assert "_Norm_0.StaticBatchNorm_0.scale" in names and "Dense_0.kernel" in names
    assert isinstance(PreResNet20(10, generator=GEN).PreBasicBlock_0, PreBasicBlock)
