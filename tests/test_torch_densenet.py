"""PyTorch port, nn/norm.py and models/densenet.py against the JAX package's
``StaticBatchNorm`` and ``DenseNetClassifier``, at the tiny width (growth 4,
blocks (2, 2), 8 initial features, bn_size 2) on 32x32 inputs, with JAX's
weights (``models/jax_convert.py``) and JAX's draws (the plain and BBB
kinds here, the others in tests/test_torch_densenet_kinds.py;
``_torch_densenet_parity.check_case``); and the port's DenseNet options held
equal to its plain form.

Tolerances: the norm's outputs and gradients 1e-5 (fp32, reductions in
another order); DenseNet logits 1e-4 and parameter gradients 1e-4 of the
largest gradient (fp32 through 12 convolutions and 10 batch norms whose sums
run in another order on each side). The options: outputs bit for bit;
gradients bit for bit under ``concat_mode`` and ``remat`` (live dropout and
BBB noise included), and within 1e-6 of the largest gradient under
``incremental_bn``, whose cached statistics are the same values reached
through another autograd graph (the gradient's sums run in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_densenet_parity import CLASSES, TINY, check_case, example
from _torch_parity import assert_close, nchw
from beyond_deep_ensembles_tpu.nn.norm import StaticBatchNorm as JaxStaticBatchNorm
from beyond_deep_ensembles_tpu.nn.norm import channel_stats as jax_channel_stats
from beyond_deep_ensembles_tpu_torch.models.densenet import DenseNetClassifier
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.nn.norm import StaticBatchNorm, channel_stats

@pytest.mark.parametrize("given_stats", [False, True], ids=["batch", "given"])
def test_static_batch_norm_matches_jax(given_stats):
    rng = np.random.RandomState(3)
    x = (1.5 + 2.0 * rng.standard_normal((6, 5, 5, 7))).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(7)).astype(np.float32), (0.1 * rng.standard_normal(7)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jax_loss(xx, sc, bi):
        stats = jax_channel_stats(xx) if given_stats else None
        y = JaxStaticBatchNorm().apply({"params": {"scale": sc, "bias": bi}}, xx, stats=stats)
        return jnp.sum(y * w), y

    (_, ref), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(x, scale, bias)
    jm, jv = jax_channel_stats(jnp.asarray(x))

    bn = StaticBatchNorm(7)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = nchw(x).requires_grad_(True)
    mean, var = channel_stats(xt)
    assert_close(mean.detach().numpy(), np.asarray(jm), rtol=0, atol=1e-5, err_msg="mean")
    assert_close(var.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-5, err_msg="var")
    y = bn(xt, (mean, var) if given_stats else None)
    torch.sum(y * nchw(w)).backward()
    assert_close(y.detach().numpy(), nchw(np.asarray(ref)).numpy(), rtol=0, atol=1e-5, err_msg="output")
    assert_close(xt.grad.numpy(), nchw(np.asarray(grads[0])).numpy(), rtol=0, atol=1e-5, err_msg="dx")
    assert_close(bn.scale.grad.numpy(), np.asarray(grads[1]), rtol=0, atol=1e-5, err_msg="dscale")
    assert_close(bn.bias.grad.numpy(), np.asarray(grads[2]), rtol=0, atol=1e-5, err_msg="dbias")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", ["plain", "bbb"])
def test_densenet_matches_jax(case, train, monkeypatch):
    check_case(case, train, monkeypatch)


def _port_run(seed_net=0, kind="plain", dropout_p=None, key=None, **options):
    net = DenseNetClassifier(CLASSES, conv_kind=kind, dropout_p=dropout_p, dropout_freeze_eval=False,
                             generator=torch.Generator().manual_seed(seed_net), **TINY, **options)
    noise = None if key is None else NoiseSource(key=torch.tensor(key))
    out = net(nchw(example(2)), noise, train=True)
    torch.sum(out * out).backward()
    return out.detach(), torch.cat([p.grad.reshape(-1) for p in net.parameters()])


@pytest.mark.parametrize("options", [
    {"incremental_bn": False},
    {"concat_mode": "buffer"},
    {"remat": "layer"},
    {"remat": "block"},
    {"remat": "layer", "concat_mode": "buffer"},
], ids=["no-incremental-bn", "buffer", "remat-layer", "remat-block", "remat-layer-buffer"])
def test_densenet_options_give_the_plain_result(options):
    out, grad = _port_run()
    got_out, got_grad = _port_run(**options)
    assert torch.equal(got_out, out)
    if "incremental_bn" in options:
        assert_close(got_grad.numpy(), grad.numpy(), rtol=0, atol=1e-6 * float(grad.abs().max()),
                     err_msg="incremental_bn gradients")
    else:
        assert torch.equal(got_grad, grad)


@pytest.mark.parametrize("remat", ["layer", "block"])
@pytest.mark.parametrize("kind,dropout_p", [("plain", 0.2), ("bbb", None)], ids=["dropout", "bbb"])
def test_densenet_remat_draws_the_forwards_noise(remat, kind, dropout_p):
    """Under remat the recompute in the backward replays the forward's
    draws (``NoiseSource.replay``): the gradient from one key equals the
    no-remat gradient, bit for bit."""
    out, grad = _port_run(kind=kind, dropout_p=dropout_p, key=11)
    got_out, got_grad = _port_run(kind=kind, dropout_p=dropout_p, key=11, remat=remat)
    assert torch.equal(got_out, out)
    assert torch.equal(got_grad, grad)
    _, other = _port_run(kind=kind, dropout_p=dropout_p, key=12)
    assert not torch.equal(other, grad)  # the key reaches the draws


@pytest.mark.parametrize("options", [{"static_bn": False}, {"norm_off": True}])
def test_densenet_unported_options_raise(options):
    """Both options, which raised before, build and run: running statistics
    give every norm a ``BatchNorm_0`` with ``mean`` and ``var`` buffers
    (tests/test_torch_running_bn.py holds it against JAX), ``norm_off``
    leaves no norm at all."""
    kwargs = dict(options)
    if "static_bn" in kwargs:
        kwargs = {"track_running_stats": not kwargs.pop("static_bn")}
    net = DenseNetClassifier(CLASSES, generator=torch.Generator(), **TINY, **kwargs)
    names = list(net.state_dict())
    if "track_running_stats" in kwargs:
        assert any(k.endswith("BatchNorm_0.mean") for k in names)
        assert not any("StaticBatchNorm" in k for k in names)
    else:
        assert not any("_BN_" in k for k in names)
    out = net(torch.randn(2, 3, 32, 32), None, train=True)
    assert out.shape == (2, CLASSES) and bool(torch.isfinite(out).all())
