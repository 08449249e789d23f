"""PyTorch port, the ``cosine_warmup`` schedule (utils/schedules.py::
cosine_with_warmup), Adam under it (utils/optim.py, ``schedule``) and iVON
with it (methods/ivon.py), held against the JAX package: rxrx1's
``lr_schedule_kind: cosine_warmup``, stepped per batch.

* ``cosine_with_warmup`` at every step of a run of 12 steps, 4 of them
  warmup, on a tensor of counts and on host integers, against JAX's: within
  2 ulp (the formula's operations in JAX's order in fp32; the cosine is each
  library's own, so the decay may differ by a rounding); the warmup's steps
  exactly, the first step's lr 0;
* the engine's ``_scheduled_lr`` against JAX's for ``cosine_warmup`` (its
  default ``warmup_steps``, ``steps_per_epoch * epochs // 20``, and a given
  one) and ``exponential``;
* ``Adam`` with the schedule (count -> lr) against ``optax.chain(
  add_decayed_weights, adam(cosine_with_warmup))`` over the 12 steps, and
  through the multi-step
  runner (on the CPU its steps run eagerly; on a card they are a CUDA graph
  whose lr comes from the device count): the parameters within 2e-7 of lr,
  the runner equal to the single steps bit for bit;
* ``ivon_method`` under the schedule against the JAX ``ivon_method`` with
  the same ``lr_fn``, from JAX's draws: the mean, momentum and precision
  after each of the 12 updates within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close
from _torch_wilds_parity import RECORDED, record_draws
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import ivon_method as jax_ivon_method
from beyond_deep_ensembles_tpu.utils.schedules import cosine_with_warmup as jax_cosine
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.methods.ivon import ivon_method
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.parallel.multistep import make_multi_step
from beyond_deep_ensembles_tpu_torch.utils.optim import Adam
from beyond_deep_ensembles_tpu_torch.utils.schedules import cosine_with_warmup

LR, WARMUP, STEPS, WD = 1e-2, 4, 12, 1e-3


def _jax_lrs(schedule, steps=STEPS + 2):
    return np.asarray([schedule(jnp.int32(c)) for c in range(steps)], np.float32)


def test_cosine_with_warmup_matches_jax():
    want = _jax_lrs(jax_cosine(LR, WARMUP, STEPS))
    port = cosine_with_warmup(LR, WARMUP, STEPS)
    got = port(torch.arange(0, STEPS + 2)).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert_close(got, want, rtol=0, atol=float(2 * ulp.max()), err_msg="lr by count")
    np.testing.assert_array_equal(got[:WARMUP], want[:WARMUP])
    assert got[0] == 0.0 and got[WARMUP] == np.float32(LR) and got[STEPS] == got[STEPS + 1] == 0.0
    assert [port(c) for c in range(STEPS + 2)] == pytest.approx(got.tolist(), abs=0)


@pytest.mark.parametrize("kind,extra", [("cosine_warmup", {}), ("cosine_warmup", {"warmup_steps": 3}),
                                        ("exponential", {"lr_decay_rate": 0.5})])
def test_scheduled_lr_matches_jax(kind, extra):
    config = {"lr_schedule_kind": kind, "steps_per_epoch": 5, "epochs": 9, **extra}
    want = _jax_lrs(jax_wilds._scheduled_lr(config, LR), 50)
    got = wilds_task._scheduled_lr(config, LR)(torch.arange(0, 50)).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert_close(got, want, rtol=0, atol=float(2 * ulp.max()), err_msg=f"{kind} lr")
    assert wilds_task._scheduled_lr({"lr_schedule_kind": "none"}, LR) == LR


def _grads(d=37):
    rng = np.random.RandomState(5)
    return rng.standard_normal(d).astype(np.float32), [rng.standard_normal(d).astype(np.float32) for _ in range(STEPS)]


def test_adam_with_cosine_matches_optax():
    p0, grads = _grads()
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(jax_cosine(LR, WARMUP, STEPS)))
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Adam([param], LR, weight_decay=WD, schedule=cosine_with_warmup(LR, WARMUP, STEPS))
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
        assert_close(param.detach().numpy(), np.asarray(jp), rtol=0, atol=2e-7 * LR, err_msg="parameters")
    assert int(opt.count) == STEPS


def test_cosine_reads_the_device_count_in_the_runner():
    p0, grads = _grads()

    def make():
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        return param, Adam([param], LR, weight_decay=WD, schedule=cosine_with_warmup(LR, WARMUP, STEPS))

    def update(state, noise, batch):
        param, opt = state
        del noise
        param.grad = batch[0].clone()
        opt.step()
        return state, {"loss": torch.zeros(())}

    single = make()
    for g in grads:
        update(single, None, (torch.from_numpy(g),))
    multi = make()
    runner = make_multi_step(update, STEPS)
    runner(multi, keys.fold_in(0, 1), (torch.from_numpy(np.stack(grads)),))
    assert torch.equal(multi[0].detach(), single[0].detach())
    assert int(multi[1].count) == STEPS


class _Vec(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.b = torch.nn.Parameter(torch.zeros(d))


def test_ivon_with_cosine_matches_jax(monkeypatch):
    d, n, mc = 6, 40, 2
    rng = np.random.RandomState(7)
    target = rng.standard_normal(d).astype(np.float32)
    weights = [rng.uniform(0.5, 2.0, d).astype(np.float32) for _ in range(STEPS)]

    def jax_loss(params, model_state, key, batch):
        loss = jnp.sum(batch * (params["b"] - target) ** 2)
        return JaxLossOutput(loss=loss, kl=jnp.float32(0.0), model_state=model_state, metrics={})

    def port_loss(params, model_state, noise, batch):
        loss = torch.sum(batch * (params.b - torch.from_numpy(target)) ** 2)
        return LossOutput(loss=loss, kl=torch.zeros(()), model_state=model_state, metrics={})

    jm = jax_ivon_method(jax_loss, lr=jax_cosine(LR, WARMUP, STEPS), prior_prec=1.0, dataset_size=n, mc_samples=mc)
    js = jm.init(jax.random.key(0), {"b": jnp.zeros(d)}, {})
    record_draws(monkeypatch)
    jstates = []
    update = jax.jit(jm.update)
    for i, w in enumerate(weights):
        js, _ = update(js, jax.random.key(i), jnp.asarray(w))
        jstates.append(jax.tree.map(np.asarray, (js.mean["b"], js.momentum["b"], js.precision["b"])))
    jax.effects_barrier()
    given = NoiseSource(given=[torch.from_numpy(np.array(a)) for _, a in RECORDED])

    pm = ivon_method(port_loss, lr=cosine_with_warmup(LR, WARMUP, STEPS), prior_prec=1.0, dataset_size=n,
                     mc_samples=mc)
    ps = pm.init(_Vec(d), {})
    for w, (mean, mom, prec) in zip(weights, jstates):
        ps, _ = pm.update(ps, given, torch.from_numpy(w))
        for got, want, name in ((ps.mean, mean, "mean"), (ps.momentum, mom, "momentum"), (ps.precision, prec, "precision")):
            assert_close(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=name)
    assert int(ps.count) == len(weights) and given.draws == len(given._given)
