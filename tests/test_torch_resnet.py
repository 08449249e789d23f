"""PyTorch port, models/resnet.py + models/layers.py + nn/base.py: BBB
ResNet-20 (FRN, swish) logits on converted weights and the same 76 noise
draws, batch 2, train and eval, and plain ResNet-20 (FRN, swish; the SVGD
particle) logits on converted weights, held against the JAX ResNet20.

Tolerance: 1e-4 absolute on the logits (fp32 through 21 convolutions whose
sums run in another order on each side)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, install_feed, load_jax_params, nchw, random_jax_params, torch_noise
from beyond_deep_ensembles_tpu.models.resnet import ResNet20 as JaxResNet20
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20, ResNet50
from beyond_deep_ensembles_tpu_torch.nn.base import Model
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

DRAWS_PER_FORWARD = 22 + 18 * 3  # BBB layers + three per variational FRN


@pytest.fixture(scope="module")
def jax_model_and_params():
    module = JaxResNet20(classes=10, activation="swish", norm="frn", conv_kind="bbb")
    return JaxModel(module), random_jax_params(module, (2, 32, 32, 3))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_resnet20_bbb_logits_match_jax(monkeypatch, jax_model_and_params, train):
    model, params = jax_model_and_params
    x = np.random.RandomState(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    feed = install_feed(monkeypatch, seed=1)
    with jax.disable_jit():
        ref, _, _ = model.apply(params, {}, jax.random.key(2), jnp.asarray(x), train=train)
    assert len(feed.draws) == DRAWS_PER_FORWARD

    net = ResNet20(10, "swish", "frn", "bbb", generator=torch.Generator().manual_seed(0))
    load_jax_params(net, params)
    noise = torch_noise(feed.draws)
    with torch.no_grad():
        out, kl, state = Model(net).apply(net, {}, noise, nchw(x), train=train)
    assert noise.draws == DRAWS_PER_FORWARD
    assert float(kl) == 0.0 and state == {}
    assert_close(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_resnet20_plain_logits_match_jax():
    module = JaxResNet20(classes=10, activation="swish", norm="frn", conv_kind="plain")
    params = random_jax_params(module, (2, 32, 32, 3), seed=5)
    x = np.random.RandomState(6).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref, _, _ = JaxModel(module).apply(params, {}, jax.random.key(0), jnp.asarray(x), train=True)

    net = ResNet20(10, "swish", "frn", "plain", generator=torch.Generator().manual_seed(0))
    load_jax_params(net, params)  # strict: the flax paths Conv_k / Dense_0 / _Norm_k
    with torch.no_grad():
        out, kl, state = Model(net).apply(net, {}, NoiseSource.seeded(0), nchw(x), train=True)
    assert float(kl) == 0.0 and state == {}
    assert_close(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert sum(p.numel() for p in net.parameters()) == 273_610


def test_state_dict_keys_are_flax_paths(jax_model_and_params):
    _, params = jax_model_and_params
    net = ResNet20(10, "swish", "frn", "bbb", generator=torch.Generator().manual_seed(0))
    converted = params_from_jax(params)
    assert set(converted) == set(net.state_dict())
    for key, value in net.state_dict().items():
        assert tuple(converted[key].shape) == tuple(value.shape), key
    # HWIO -> OIHW and [in, out] -> [out, in]
    stem = np.asarray(params["BBBConv_0"]["kernel__gmean"])
    np.testing.assert_array_equal(converted["BBBConv_0.kernel__gmean"].numpy(), stem.transpose(3, 2, 0, 1))
    head = np.asarray(params["BBBDense_0"]["kernel__grho"])
    np.testing.assert_array_equal(converted["BBBDense_0.kernel__grho"].numpy(), head.T)


def test_not_ported_kinds_raise():
    """relu and batch_static are ported with ResNet-50 (tests/test_torch_resnet50.py);
    the norm 'none' (the JAX package's benchmark knob) and ResNet-50's remat are not."""
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        ResNet20(10, "relu", "none", "rank1", components=4, generator=gen)
    with pytest.raises(NotImplementedError):
        ResNet50(10, stage_sizes=(1, 1), remat="stage", generator=gen)
