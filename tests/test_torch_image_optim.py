"""PyTorch port, the exponential schedule (utils/schedules.py), Adam under it
(utils/optim.py) and iVON with a schedule (methods/ivon.py), held against the
JAX package: fmow's ``lr_schedule_kind: exponential``.

* ``Adam`` with ``exponential_schedule`` against ``optax.chain(
  add_decayed_weights(wd), adam(exponential_decay(lr, steps_per_epoch,
  decay, staircase=True)))`` over eight steps that cross two epoch
  boundaries (three steps an epoch): the parameters after each step within
  2e-7 of lr (the same fp32 formulas; the bias corrections and the power
  are each side's fp32 transcendental);
* the same Adam steps through the multi-step runner (``parallel/
  multistep.py``; on the CPU its steps run eagerly), whose lr comes from the
  device count, not a host number: equal to the single steps bit for bit;
* ``ivon_method`` with ``lr`` a function of the update count against the JAX
  ``ivon_method`` with ``lr_fn``, from JAX's draws: the mean, momentum and
  precision after each of seven updates within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close
from _torch_wilds_parity import RECORDED, record_draws
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import ivon_method as jax_ivon_method
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.methods.ivon import ivon_method
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.parallel.multistep import make_multi_step
from beyond_deep_ensembles_tpu_torch.utils.optim import Adam
from beyond_deep_ensembles_tpu_torch.utils.schedules import exponential_schedule

LR, DECAY, SPE, STEPS, WD = 1e-2, 0.5, 3, 8, 1e-3


def _staircase():
    """Adam's schedule (count -> lr): ``LR`` times the staircase factor of
    the epoch, as the WILDS engine's ``_scheduled_lr`` makes it."""
    factor = exponential_schedule(DECAY)
    return lambda count: LR * factor(count // SPE)


def _grads(d=37):
    rng = np.random.RandomState(5)
    return rng.standard_normal(d).astype(np.float32), [rng.standard_normal(d).astype(np.float32) for _ in range(STEPS)]


def test_exponential_schedule_is_optax_staircase():
    sched = optax.exponential_decay(LR, transition_steps=SPE, decay_rate=DECAY, staircase=True)
    factor = exponential_schedule(DECAY)
    counts = torch.arange(0, 10)
    got = (LR * factor(counts // SPE)).numpy()
    want = np.asarray([sched(c) for c in range(10)], np.float32)
    assert_close(got, want, rtol=1e-7, atol=0, err_msg="lr by count")
    assert got[SPE - 1] == np.float32(LR) and got[SPE] < got[SPE - 1]
    assert factor(2) == pytest.approx(DECAY**2)


def test_adam_with_schedule_matches_optax():
    p0, grads = _grads()
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(
        optax.exponential_decay(LR, transition_steps=SPE, decay_rate=DECAY, staircase=True)))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Adam([param], LR, weight_decay=WD, schedule=_staircase())
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
        assert_close(param.detach().numpy(), np.asarray(jp), rtol=0, atol=2e-7 * LR, err_msg="parameters")
    assert int(opt.count) == STEPS


def test_adam_schedule_reads_the_device_count_in_the_runner():
    """``make_multi_step`` over eight steps across two epoch boundaries
    equals eight single steps: the lr of each step comes from the count on
    the device (a CUDA graph replays the same program)."""
    p0, grads = _grads()

    def make():
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        return param, Adam([param], LR, weight_decay=WD, schedule=_staircase())

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


def test_ivon_with_schedule_matches_jax(monkeypatch):
    d, n, mc = 6, 40, 2
    rng = np.random.RandomState(7)
    target = rng.standard_normal(d).astype(np.float32)
    weights = [rng.uniform(0.5, 2.0, d).astype(np.float32) for _ in range(7)]
    sched = optax.exponential_decay(LR, transition_steps=SPE, decay_rate=DECAY, staircase=True)

    def jax_loss(params, model_state, key, batch):
        loss = jnp.sum(batch * (params["b"] - target) ** 2)
        return JaxLossOutput(loss=loss, kl=jnp.float32(0.0), model_state=model_state, metrics={})

    def port_loss(params, model_state, noise, batch):
        loss = torch.sum(batch * (params.b - torch.from_numpy(target)) ** 2)
        return LossOutput(loss=loss, kl=torch.zeros(()), model_state=model_state, metrics={})

    jm = jax_ivon_method(jax_loss, lr=sched, prior_prec=1.0, dataset_size=n, mc_samples=mc)
    js = jm.init(jax.random.key(0), {"b": jnp.zeros(d)}, {})
    record_draws(monkeypatch)
    jstates = []
    for i, w in enumerate(weights):
        js, _ = jax.jit(jm.update)(js, jax.random.key(i), jnp.asarray(w))
        jstates.append(jax.tree.map(np.asarray, (js.mean["b"], js.momentum["b"], js.precision["b"])))
    jax.effects_barrier()
    given = NoiseSource(given=[torch.from_numpy(np.array(a)) for _, a in RECORDED])

    factor = exponential_schedule(DECAY)
    pm = ivon_method(port_loss, lr=lambda count: LR * factor(count // SPE), prior_prec=1.0, dataset_size=n,
                     mc_samples=mc)
    ps = pm.init(_Vec(d), {})
    for w, (mean, mom, prec) in zip(weights, jstates):
        ps, _ = pm.update(ps, given, torch.from_numpy(w))
        for got, want, name in ((ps.mean, mean, "mean"), (ps.momentum, mom, "momentum"), (ps.precision, prec, "precision")):
            assert_close(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=name)
    assert int(ps.count) == len(weights) and given.draws == len(given._given)
