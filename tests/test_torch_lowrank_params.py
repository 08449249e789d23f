"""PyTorch port, nn/bbb.py: ``LowRankBBBDense`` (its output, gradients and
sown KL, which ``nn/base.py::Model.apply`` returns) and the BBB layers'
``sampling="parameters"`` (the kernel and bias drawn through K1's plain
twin on the CPU), held against the JAX package's layers with JAX's draws
given, on the CPU; and ``methods/bbb.py`` adding the sown KL to the
Gaussian KL in one update, as JAX ``methods/bbb.py:84`` does.

Tolerances: rtol 1e-5 with atol 1e-6 of each tensor's largest entry for the
low-rank layer (outputs, KL, gradients); rtol 1e-5, atol 1e-5 for the
parameter draws (K1 draws ``mean + sqrt(std^2) z``, one fp32 rounding from
``mean + std z``)."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close, nchw, record_jax_normals
from beyond_deep_ensembles_tpu.methods import GaussianPrior as JaxGaussianPrior
from beyond_deep_ensembles_tpu.methods import bbb_method as jax_bbb_method
from beyond_deep_ensembles_tpu.methods.api import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.nn import bbb as jax_bbb
from beyond_deep_ensembles_tpu.nn import gaussian as jax_gaussian
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior, LossOutput
from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.nn import LowRankBBBDense, blundell_mean_init, sow_kl
from beyond_deep_ensembles_tpu_torch.nn.base import Model, collecting_kl
from beyond_deep_ensembles_tpu_torch.nn.bbb import BBBConv, BBBDense
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

IN, OUT, RANK, BATCH = 6, 4, 3, 5
GEN = torch.Generator().manual_seed(0)


def _close(got, want, what, rtol=1e-5, atol_share=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert_close(got, want, rtol=rtol, atol=atol_share * max(np.abs(want).max(), 1e-30), err_msg=what)


def _lowrank_params(seed=0):
    rs = np.random.RandomState(seed)
    n = (IN + 1) * OUT
    return {"param_mean": (0.3 * rs.standard_normal(n)).astype(np.float32),
            "param_diag_rho": (-2.0 + 0.3 * rs.standard_normal(n)).astype(np.float32),
            "param_lr_vars": (0.2 * rs.standard_normal((RANK, n))).astype(np.float32)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_lowrank_bbb_dense_matches_jax(train, monkeypatch):
    """Output, KL (in training; none at eval but under ``kl_on_eval``) and
    the gradients of ``sum(out * w) + kl`` with JAX's two draws."""
    params = _lowrank_params()
    x = np.random.RandomState(1).standard_normal((BATCH, IN)).astype(np.float32)
    w = np.random.RandomState(2).standard_normal((BATCH, OUT)).astype(np.float32)
    model = JaxModel(jax_bbb.LowRankBBBDense(OUT, RANK, gamma=2.0, kl_on_eval=not train))
    draws = record_jax_normals(monkeypatch, jax_bbb)

    def loss(p):
        out, kl, _ = model.apply(p, {}, jax.random.key(3), jnp.asarray(x), train=train)
        return jnp.sum(out * w) + kl, (out, kl)

    (_, (want, want_kl)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jax.effects_barrier()
    frozen = not train
    assert [d.shape for d in draws] == ([(1, OUT), (RANK, 1, 1)] if frozen else [(BATCH, OUT), (RANK, BATCH, 1)])
    given = [torch.from_numpy(np.array(draws[0][0] if frozen else draws[0])), torch.from_numpy(np.array(draws[1]))]

    layer = LowRankBBBDense(IN, OUT, RANK, gamma=2.0, kl_on_eval=not train, generator=GEN)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    out, kl, _ = Model(layer).apply(layer, {}, NoiseSource(given=given), torch.from_numpy(x), train=train)
    (torch.sum(out * torch.from_numpy(w)) + kl).backward()
    _close(out.detach(), want, "low-rank output")
    _close(kl.detach(), want_kl, "low-rank KL")
    assert float(want_kl) != 0.0
    for name, p in layer.named_parameters():
        _close(p.grad, grads[name], f"low-rank grad {name}")


def test_kl_is_recorded_only_under_apply():
    """A forward outside ``Model.apply`` records nothing (flax's ``sow`` into
    an immutable collection), and ``sow_kl`` outside a forward is a no-op."""
    layer = LowRankBBBDense(IN, OUT, RANK, generator=GEN)
    x = torch.randn(BATCH, IN, generator=GEN)
    layer(x, NoiseSource.seeded(0), train=True)
    sow_kl(layer, torch.ones(()))
    _, kl, _ = Model(layer).apply(layer, {}, NoiseSource.seeded(0), x, train=False)
    assert float(kl) == 0.0
    _, kl, _ = Model(layer).apply(layer, {}, NoiseSource.seeded(0), x, train=True)
    assert float(kl.detach()) > 0.0


def test_kl_frames_are_per_thread():
    """A forward collecting its KL on one thread (a rank of a threaded
    world) records nothing of a forward another thread runs meanwhile."""
    layer = LowRankBBBDense(IN, OUT, RANK, generator=GEN)
    x = torch.randn(BATCH, IN, generator=GEN)
    with collecting_kl() as terms:
        worker = threading.Thread(target=lambda: layer(x, NoiseSource.seeded(1), train=True))
        worker.start()
        worker.join()
        assert terms == []
        layer(x, NoiseSource.seeded(0), train=True)
    assert len(terms) == 1


def test_blundell_mean_init():
    a = blundell_mean_init()((1000,), torch.Generator().manual_seed(0))
    assert a.shape == (1000,) and 0.08 < float(a.std()) < 0.12
    b = blundell_mean_init(0.5)((3, 4), torch.Generator().manual_seed(0))
    assert torch.equal(b, 0.5 * torch.randn((3, 4), generator=torch.Generator().manual_seed(0)))


def _bbb_params(shape_kernel, seed):
    rs = np.random.RandomState(seed)
    return {"kernel__gmean": (0.3 * rs.standard_normal(shape_kernel)).astype(np.float32),
            "kernel__grho": (-3.0 + 0.3 * rs.standard_normal(shape_kernel)).astype(np.float32),
            "bias__gmean": (0.3 * rs.standard_normal(shape_kernel[-1])).astype(np.float32),
            "bias__grho": (-3.0 + 0.3 * rs.standard_normal(shape_kernel[-1])).astype(np.float32)}


@pytest.mark.parametrize("layer", ["dense", "conv"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_parameter_sampling_matches_jax(layer, train, monkeypatch):
    """``sampling="parameters"``: a fresh kernel and bias draw at train and
    at eval (``freeze_on_eval`` left at its default), outputs and
    gradients with JAX's draws."""
    if layer == "dense":
        jmod, kshape, xshape = jax_bbb.BBBDense(OUT, sampling="parameters"), (IN, OUT), (BATCH, IN)
        port = BBBDense(IN, OUT, sampling="parameters", generator=GEN)
    else:
        jmod = jax_bbb.BBBConv(OUT, (3, 3), padding=1, sampling="parameters")
        kshape, xshape = (3, 3, IN, OUT), (2, 6, 6, IN)
        port = BBBConv(IN, OUT, (3, 3), padding=1, sampling="parameters", generator=GEN)
    params = _bbb_params(kshape, seed=4)
    x = np.random.RandomState(5).standard_normal(xshape).astype(np.float32)
    draws = record_jax_normals(monkeypatch, jax_gaussian)
    model = JaxModel(jmod)

    def loss(p):
        out, _, _ = model.apply(p, {}, jax.random.key(6), jnp.asarray(x), train=train)
        return jnp.sum(out * out), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jax.effects_barrier()
    assert [d.shape for d in draws] == [kshape, (OUT,)]
    kernel_z = params_from_jax({"kernel": np.array(draws[0])})["kernel"]
    given = NoiseSource(given=[kernel_z, torch.from_numpy(np.array(draws[1]))])
    port.load_state_dict(params_from_jax(params))
    got = port(nchw(x) if layer == "conv" else torch.from_numpy(x), given, train=train)
    torch.sum(got * got).backward()
    assert given.draws == 2
    got = got.detach().permute(0, 2, 3, 1) if layer == "conv" else got.detach()
    assert_close(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=f"{layer} output")
    port_grads = {k: p.grad for k, p in port.named_parameters()}
    for k, g in params_from_jax(jax.tree.map(np.asarray, grads)).items():
        assert_close(port_grads[k].numpy(), g.numpy(), rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                     err_msg=f"{layer} grad {k}")


def test_parameter_draws_are_fresh_at_eval():
    layer = BBBDense(IN, OUT, sampling="parameters", generator=GEN)
    x = torch.randn(BATCH, IN, generator=GEN)
    noise = NoiseSource.seeded(0)
    with torch.no_grad():
        a, b = layer(x, noise, train=False), layer(x, noise, train=False)
    assert not torch.equal(a, b)
    with pytest.raises(ValueError):
        BBBDense(IN, OUT, sampling="weights", generator=GEN)


def test_bbb_update_adds_the_sown_kl(monkeypatch):
    """One BBB update of a ``LowRankBBBDense`` regression: the loss, the KL
    (the layer's sown KL: it has no ``__gmean`` pair) and the updated
    parameters, JAX's against the port's."""
    params = _lowrank_params(seed=7)
    x = np.random.RandomState(8).standard_normal((BATCH, IN)).astype(np.float32)
    y = np.random.RandomState(9).standard_normal((BATCH, OUT)).astype(np.float32)
    jmodel = JaxModel(jax_bbb.LowRankBBBDense(OUT, RANK))

    def jloss(p, ms, key, batch, **kw):
        out, kl, new_ms = jmodel.apply(p, ms, key, batch[0], train=True)
        return JaxLossOutput(loss=jnp.mean((out - batch[1]) ** 2), kl=kl, model_state=new_ms)

    jmethod = jax_bbb_method(jloss, optax.sgd(0.1), JaxGaussianPrior(0.0, 1.0), dataset_size=50)
    draws = record_jax_normals(monkeypatch, jax_bbb)
    jstate = jmethod.init(jax.random.key(0), params, {})
    jstate, jmetrics = jax.jit(jmethod.update)(jstate, jax.random.key(1), (jnp.asarray(x), jnp.asarray(y)))
    jax.effects_barrier()

    layer = LowRankBBBDense(IN, OUT, RANK, generator=GEN)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    model = Model(layer)

    def loss(p, ms, noise, batch, **kw):
        out, kl, new_ms = model.apply(p, ms, noise, batch[0], train=True)
        return LossOutput(loss=torch.mean((out - batch[1]) ** 2), kl=kl, model_state=new_ms)

    method = bbb_method(loss, lambda ps: (SGD(ps, lr=0.1), None), GaussianPrior(0.0, 1.0), dataset_size=50)
    state = method.init(layer, {})
    noise = NoiseSource(given=[torch.from_numpy(np.array(d)) for d in draws])
    state, metrics = method.update(state, noise, (torch.from_numpy(x), torch.from_numpy(y)))
    assert float(metrics["kl"]) > 0.0
    for k in ("loss", "kl", "data_loss"):
        _close(metrics[k], jmetrics[k], f"update {k}")
    for k, p in layer.named_parameters():
        _close(p.detach(), jstate.params[k], f"updated {k}")
