"""PyTorch port, nn/norm.py::BatchNorm and the running-statistics DenseNet
(``track_running_stats``, the WILDS engine's ``static_bn: false``), held
against flax's ``nn.BatchNorm(use_running_average=not train)`` and the JAX
package's ``DenseNetClassifier`` on the CPU.

Tolerances: the layer's train and eval outputs and its ``mean`` / ``var``
after three forwards within rtol 1e-5 and 1e-6 of their largest entry; the
tiny DenseNet's logits and ``batch_stats`` after two train forwards, and its
eval logits from those statistics, within 1e-4 (the logits, as
tests/test_torch_densenet.py holds them) and 2e-6 (the statistics); the
remat modes against ``none`` bit for bit in outputs, gradients and
statistics (the recompute steps no statistics)."""
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, nchw, random_jax_params
from beyond_deep_ensembles_tpu.models.densenet import DenseNetClassifier as JaxDenseNet
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.models.densenet import DenseNetClassifier
from beyond_deep_ensembles_tpu_torch.models.jax_convert import (
    batch_stats_to_jax, buffers_from_jax, params_from_jax)
from beyond_deep_ensembles_tpu_torch.nn.norm import BatchNorm, recomputing

TINY = dict(growth_rate=4, block_config=(2, 2), init_features=8, bn_size=2)
CLASSES = 3


def _batches(n=3, shape=(6, 5, 5, 7), seed=0):
    rs = np.random.RandomState(seed)
    return [(2.0 + 3.0 * rs.standard_normal(shape)).astype(np.float32) for _ in range(n)]


def _close(got, want, what):
    want = np.asarray(want)
    assert_close(np.asarray(got), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax(dtype):
    """Three train forwards (outputs and the buffers after each), then an
    eval forward from the buffers; the scale and bias away from their
    init. Under bf16 both return fp32."""
    c = 7
    rs = np.random.RandomState(3)
    scale, bias = (1 + 0.3 * rs.standard_normal(c)).astype(np.float32), (0.2 * rs.standard_normal(c)).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    port = BatchNorm(c)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for i, x in enumerate(_batches()):
        want, updated = flax_bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])
        variables = {**variables, **updated}
        got = port(nchw(x).to(tdt), train=True)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        _close(got.detach().permute(0, 2, 3, 1).numpy(), want, f"train output {i}")
        _close(port.mean.numpy(), variables["batch_stats"]["mean"], f"mean after {i + 1}")
        _close(port.var.numpy(), variables["batch_stats"]["var"], f"var after {i + 1}")
    x = _batches(1, seed=5)[0]
    want = fnn.BatchNorm(use_running_average=True).apply(variables, jnp.asarray(x, jdt))
    before = port.mean.clone()
    got = port(nchw(x).to(tdt), train=False)
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want, "eval output")
    assert torch.equal(port.mean, before)


def test_batchnorm_steps_buffers_in_place():
    """The buffers keep their storage (a captured graph and the runners'
    save and restore hold their addresses)."""
    bn = BatchNorm(4)
    ptrs = (bn.mean.data_ptr(), bn.var.data_ptr())
    bn(torch.randn(3, 4, 2, 2), train=True)
    assert (bn.mean.data_ptr(), bn.var.data_ptr()) == ptrs
    assert not torch.equal(bn.var, torch.ones(4))


def test_recompute_mark_is_on_the_layers_it_names():
    """A recompute in progress (``recomputing``) holds the statistics of the
    layers it names only: another model's BatchNorm, stepped on another
    thread meanwhile (a rank of a threaded world), steps as usual."""
    recomputed, other = BatchNorm(4), BatchNorm(4)
    x = torch.randn(3, 4, 2, 2, generator=torch.Generator().manual_seed(3))
    with recomputing([torch.nn.Sequential(recomputed)]):
        worker = threading.Thread(target=lambda: other(x, train=True))
        worker.start()
        worker.join()
        recomputed(x, train=True)
    assert torch.equal(recomputed.mean, torch.zeros(4)) and torch.equal(recomputed.var, torch.ones(4))
    assert not torch.equal(other.mean, torch.zeros(4))
    recomputed(x, train=True)
    assert torch.equal(recomputed.mean, other.mean) and torch.equal(recomputed.var, other.var)


def _jax_model():
    return JaxModel(JaxDenseNet(classes=CLASSES, track_running_stats=True, **TINY))


def _port_model(**kw):
    return DenseNetClassifier(CLASSES, track_running_stats=True, generator=torch.Generator().manual_seed(0),
                              **TINY, **kw)


def _jax_weights():
    params = random_jax_params(_jax_model().module, (2, 32, 32, 3), seed=4)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1.0 + leaf if getattr(path[-1], "key", None) == "scale" else leaf, params)


def test_running_stats_densenet_matches_jax():
    """Two train forwards from JAX's init statistics (each stepping every
    norm's buffers), then an eval forward that reads them."""
    model = _jax_model()
    params = _jax_weights()
    _, ms = model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)))
    assert set(ms) == {"batch_stats"}
    port = _port_model()
    port.load_state_dict({**params_from_jax(jax.tree.map(np.asarray, params)),
                          **buffers_from_jax(jax.tree.map(np.asarray, dict(ms)))})
    fwd = jax.jit(lambda p, s, x, train: model.apply(p, s, None, x, train=train), static_argnums=3)
    for i, x in enumerate(_batches(2, (4, 32, 32, 3), seed=11)):
        out, _, ms = fwd(params, ms, jnp.asarray(x), True)
        got = port(nchw(x), None, train=True)
        assert_close(got.detach().numpy(), np.asarray(out), atol=1e-4, err_msg=f"train logits {i}")
    want_stats = buffers_from_jax(jax.tree.map(np.asarray, dict(ms)))
    assert set(want_stats) == {k for k, _ in port.named_buffers()}
    for k, v in port.named_buffers():
        assert_close(v.numpy(), want_stats[k].numpy(), atol=2e-6, err_msg=k)
    back = batch_stats_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, ms["batch_stats"]))
    x = _batches(1, (4, 32, 32, 3), seed=12)[0]
    out, _, same = fwd(params, ms, jnp.asarray(x), False)
    got = port(nchw(x), None, train=False)
    assert_close(got.detach().numpy(), np.asarray(out), atol=1e-4, err_msg="eval logits")
    for k, v in port.named_buffers():
        assert_close(v.numpy(), want_stats[k].numpy(), atol=2e-6, err_msg=f"{k} after eval")


@pytest.mark.parametrize("remat", ["layer", "block"])
@pytest.mark.parametrize("concat_mode", ["concat", "buffer"])
def test_remat_steps_statistics_once(remat, concat_mode):
    """A rematerialized training step equals the plain one: logits,
    parameter gradients and running statistics (the backward's recompute
    must not step them a second time)."""
    x = nchw(_batches(1, (4, 32, 32, 3), seed=13)[0])
    runs = []
    for mode in ("none", remat):
        m = _port_model(remat=mode, concat_mode=concat_mode)
        out = m(x, None, train=True)
        out.square().sum().backward()
        runs.append((out.detach(), {k: p.grad for k, p in m.named_parameters()}, dict(m.named_buffers())))
    (o0, g0, b0), (o1, g1, b1) = runs
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


def test_norm_off_is_the_identity():
    """``norm_off`` (the JAX package's ``no_norm`` benchmark knob): no norm
    parameters, and the logits of JAX's ``norm_off`` DenseNet."""
    jmodel = JaxModel(JaxDenseNet(classes=CLASSES, norm_off=True, **TINY))
    params = random_jax_params(jmodel.module, (2, 32, 32, 3), seed=5)
    port = DenseNetClassifier(CLASSES, norm_off=True, generator=torch.Generator().manual_seed(0), **TINY)
    assert not any("BN" in k for k in port.state_dict())
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    x = _batches(1, (2, 32, 32, 3), seed=14)[0]
    out, _, _ = jax.jit(lambda p, x: jmodel.apply(p, {}, None, x, train=True))(params, jnp.asarray(x))
    assert_close(port(nchw(x), None).detach().numpy(), np.asarray(out), atol=1e-4, err_msg="norm_off logits")
