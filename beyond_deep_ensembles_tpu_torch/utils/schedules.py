"""Learning-rate schedules.

Counterpart of ``beyond_deep_ensembles_tpu/utils/schedules.py``: the Wilson
schedule, ``step_schedule`` and the staircase exponential decay of the WILDS
engine's ``lr_schedule_kind: exponential`` (JAX ``experiments/wilds_task.py::
_scheduled_lr``, an optax ``exponential_decay(staircase=True)``) as
epoch->factor functions, ``epoch_schedule_to_step`` to turn one into a
step->lr function; and as step->lr functions (optax's form)
``cosine_with_warmup`` (the ``cosine_warmup`` schedule stepped per batch),
the SG-MCMC schedules ``cyclical_cosine`` and
``constant_with_cosine_burnin``, and ``cosine_decay_schedule``, optax's
schedule of that name (the bnn-hmc ``run_sgd``'s). Each takes a Python number
(and gives a float) or an integer tensor (and gives an fp32 tensor on its
device, so that the port's optimizers compute their lr on the device, inside
a CUDA graph, as the JAX schedule is traced into the step). The arithmetic
is fp32 in the JAX function's order of operations, so both round alike; the
cosine is each library's own.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def wilson_schedule(pretrain_epochs: int, lr_init: float, swag_lr: Optional[float] = None):
    """Wilson et al. SWAG schedule (reference src/algos/util.py:43-54):
    flat, linear decay from 50% to 90%, then flat at the SWA LR."""
    lr_ratio = swag_lr / lr_init if swag_lr is not None else 0.01

    def factor(epoch):
        t = epoch / pretrain_epochs
        if isinstance(t, torch.Tensor):
            decay = 1.0 - (1.0 - lr_ratio) * (t - 0.5) / 0.4
            ratio = torch.full_like(t, lr_ratio)
            return torch.where(t <= 0.5, torch.ones_like(t), torch.where(t <= 0.9, decay, ratio))
        if t <= 0.5:
            return 1.0
        if t <= 0.9:
            return 1.0 - (1.0 - lr_ratio) * (t - 0.5) / 0.4
        return lr_ratio

    return factor


def exponential_schedule(decay_rate: float):
    """The staircase exponential decay as a factor of the epoch,
    ``decay_rate ** epoch`` in fp32 (optax ``exponential_decay(lr,
    transition_steps=steps_per_epoch, decay_rate, staircase=True)`` is ``lr``
    times this factor at ``epoch = count // steps_per_epoch``)."""

    def factor(epoch):
        if isinstance(epoch, torch.Tensor):
            return torch.pow(decay_rate, epoch.to(torch.float32))
        return float(torch.pow(torch.tensor(decay_rate, dtype=torch.float32), float(epoch)))

    return factor


def _fp32(x):
    """(value as an fp32 tensor, whether the caller gave a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32), True
    return torch.tensor(x, dtype=torch.float32), False


def _out(value: torch.Tensor, tensor: bool):
    return value if tensor else float(value)


def step_schedule(milestones: Sequence[int], gamma: float):
    """MultiStep decay (reference src/algos/util.py:29-41): ``gamma **
    (number of milestones <= epoch)``, in fp32."""
    ms = list(milestones)

    def factor(epoch):
        e, tensor = _fp32(epoch)
        passed = sum((e >= m).to(torch.float32) for m in ms) if ms else torch.zeros_like(e)
        return _out(torch.pow(gamma, passed), tensor)

    return factor


def epoch_schedule_to_step(factor_fn, steps_per_epoch: int, base_lr: float):
    """An epoch->factor schedule as a step->lr one: ``base_lr *
    factor_fn(step // steps_per_epoch)``."""

    def schedule(step):
        return base_lr * factor_fn(step // steps_per_epoch)

    return schedule


def cyclical_cosine(base_lr: float, cycle_steps: int, burnin_steps: int = 0):
    """Constant during burn-in, then cyclical cosine restarts: the cSG-MCMC
    schedule with the reference's ``- 1`` phase offset (bnn_hmc/utils/
    optim_utils.py:60-67): the first step after burn-in still runs at
    ``base_lr``, the cycle clock starting one step later."""

    def schedule(step):
        s, tensor = _fp32(step)
        t = torch.clamp(s - burnin_steps - 1, min=0.0) % cycle_steps
        return _out(0.5 * base_lr * (1.0 + torch.cos(math.pi * t / cycle_steps)), tensor)

    return schedule


def constant_with_cosine_burnin(init_lr: float, final_lr: float, burnin_steps: int):
    """A cosine ramp from ``init_lr`` to ``final_lr`` over burn-in, then
    constant (reference bnn_hmc/utils/optim_utils.py:30-42)."""

    def schedule(step):
        s, tensor = _fp32(step)
        t = torch.clamp(s / max(burnin_steps, 1), 0.0, 1.0)
        coef = 0.5 * (1.0 + torch.cos(math.pi * t))
        return _out(coef * init_lr + (1 - coef) * final_lr, tensor)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0):
    """optax ``cosine_decay_schedule``: ``init_value * ((1 - alpha) * (0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps))) ** exponent +
    alpha)``, in fp32."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c, tensor = _fp32(count)
        c = torch.clamp(c, max=float(decay_steps))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        decayed = (1 - alpha) * cosine_decay**exponent + alpha
        return _out(init_value * decayed, tensor)

    return schedule


def cosine_with_warmup(base_lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup then cosine decay, stepped per batch (reference
    rxrx1.py:128-170): the lr at ``step`` (an update count) is ``base_lr *
    min(step, warmup) / max(warmup, 1)`` before ``warmup_steps``, then
    ``base_lr * 0.5 * (1 + cos(pi * progress))`` with ``progress`` the share
    of ``total_steps - warmup_steps`` done, clipped to [0, 1]. In fp32, in
    the JAX function's order of operations (``base_lr`` times the step, then
    the division), so both round alike; the cosine is each library's own."""

    def schedule(step):
        tensor = isinstance(step, torch.Tensor)
        s = step if tensor else torch.tensor(step, dtype=torch.int64)
        warm = (base_lr * torch.clamp(s, max=warmup_steps).to(torch.float32)) / max(warmup_steps, 1)
        progress = torch.clamp((s - warmup_steps).to(torch.float32) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decay = (base_lr * 0.5) * (1.0 + torch.cos(math.pi * progress))
        lr = torch.where(s < warmup_steps, warm, decay)
        return lr if tensor else float(lr)

    return schedule
