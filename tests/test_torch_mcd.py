"""PyTorch port, MC-Dropout on CIFAR: ``ResNet20(dropout_p)`` (a
``FixableDropout`` after the stem and after each conv of each block, the
skip's included) held against the JAX package's model on the CPU, fed the
JAX package's masks (``jax.random.bernoulli`` replaced, for the test, by a
seeded numpy feed whose masks the port is handed in the same order, NHWC
-> NCHW), and the key-mode masks a captured step draws.

Tolerances: logits atol 1e-5 (train, rescaled masks; frozen eval, one
unrescaled mask per batch). Key-mode masks: the keep rate within 1e-3 of
1 - p over 2,097,152 elements (five standard deviations is 1.1e-3), and
equality for repeats from one key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401 (one_cpu_thread: a fixture)
    assert_close, load_jax_params, nchw, one_cpu_thread, random_jax_params)
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods import predict
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20
from beyond_deep_ensembles_tpu_torch.nn.dropout import FixableDropout
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

P = 0.1
DROPOUT_LAYERS = 1 + 9 * 2 + 2  # the stem, two per block, the two projection skips


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


@pytest.mark.parametrize("train", [True, False])
def test_resnet20_dropout_logits_match_jax(monkeypatch, train):
    model = jax_cifar._resnet({}, dropout_p=P)
    params = random_jax_params(jax_cifar._resnet({}).module, (2, 32, 32, 3))  # dropout adds no parameter
    x = np.random.RandomState(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    feed = BernoulliFeed(seed=2)
    monkeypatch.setattr(jax.random, "bernoulli", feed)
    want, _, _ = model.apply(params, {}, jax.random.key(0), jnp.asarray(x), train=train)
    assert len(feed.masks) == DROPOUT_LAYERS
    assert feed.masks[0].shape == ((3, 32, 32, 16) if train else (32, 32, 16))

    net = load_jax_params(ResNet20(10, "swish", "frn", "plain", dropout_p=P, generator=torch.Generator()), params)
    noise = NoiseSource(given=[nchw(m) for m in feed.masks])
    with torch.no_grad():
        got = net(nchw(x), noise, train=train)
    assert noise.draws == DROPOUT_LAYERS
    assert_close(got.numpy(), np.asarray(want), rtol=0, atol=1e-5, err_msg=f"logits, train={train}")


def test_dropout_layers_registered_under_flax_names():
    net = ResNet20(10, "swish", "frn", "plain", dropout_p=P, generator=torch.Generator())
    names = [n for n, m in net.named_modules() if isinstance(m, FixableDropout)]
    assert len(names) == DROPOUT_LAYERS
    assert names[:4] == ["FixableDropout_0", "BasicBlock_0.FixableDropout_0", "BasicBlock_0.FixableDropout_1",
                         "BasicBlock_1.FixableDropout_0"]
    assert "BasicBlock_3.FixableDropout_2" in names and "BasicBlock_6.FixableDropout_2" in names
    plain = ResNet20(10, "swish", "frn", "plain", generator=torch.Generator())
    assert net.state_dict().keys() == plain.state_dict().keys()


def test_key_mode_masks():
    """The stage-1 mask at batch 128 (2,097,152 elements, more than one
    normal pool chunk): keep rate 1 - p; the same key and draw index give
    the same bits, another key or the next draw other bits."""
    shape = (128, 16, 32, 32)
    key = keys.as_key(keys.fold_in(0, 5), "cpu")
    source = NoiseSource(key=key)
    a = source.keep_mask(shape, "cpu", P)
    b = source.keep_mask(shape, "cpu", P)
    assert a.shape == shape and a.dtype == torch.bool and source.draws == 2
    assert abs(float(a.float().mean()) - (1 - P)) < 1e-3
    assert torch.equal(a, NoiseSource(key=key).keep_mask(shape, "cpu", P))
    assert not torch.equal(a, b)
    assert not torch.equal(a, NoiseSource(key=keys.as_key(keys.fold_in(0, 6), "cpu")).keep_mask(shape, "cpu", P))


def test_key_mode_dropout_frozen_and_train():
    """Frozen eval: one mask of the per-example shape for the whole batch,
    not rescaled; training: a mask per element, the kept values / (1 - p)."""
    x = torch.randn(4, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    layer = FixableDropout(P)
    key = keys.as_key(7, "cpu")
    frozen = layer(x, NoiseSource(key=key), train=False)
    kept = frozen != 0
    assert torch.equal(kept, kept[:1].expand_as(kept)) and torch.equal(frozen[kept], x[kept])
    assert torch.equal(frozen, layer(x, NoiseSource(key=key), train=False))
    live = layer(x, NoiseSource(key=key), train=True)
    kept = live != 0
    assert not torch.equal(kept, kept[:1].expand_as(kept))
    torch.testing.assert_close(live[kept], x[kept] / (1 - P), rtol=0, atol=0)


def test_mcd_build_and_predict_draw_fresh_masks():
    """``mcd`` builds ResNet-20 with ``dropout_p = p`` under MAP; in key mode
    the S eval samples draw different masks and a repeat from the same key
    the same ones."""
    built = cifar.build({**cifar.DEFAULT_CONFIG, "model": "mcd"}, torch.Generator().manual_seed(0), 1, device="cpu")
    assert sum(isinstance(m, FixableDropout) for m in built.state.params.modules()) == DROPOUT_LAYERS
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    key = keys.as_key(3, "cpu")
    with torch.no_grad():
        out = predict(built.method, built.state, built.apply_fn, x, 3, NoiseSource(key=key))
        again = predict(built.method, built.state, built.apply_fn, x, 3, NoiseSource(key=key))
    assert torch.equal(out, again)
    assert not torch.equal(out[0], out[1]) and not torch.equal(out[1], out[2])
