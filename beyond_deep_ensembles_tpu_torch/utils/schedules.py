"""Learning-rate schedules.

Counterpart of ``beyond_deep_ensembles_tpu/utils/schedules.py``: the Wilson
schedule and the staircase exponential decay of the WILDS engine's
``lr_schedule_kind: exponential`` (JAX ``experiments/wilds_task.py::
_scheduled_lr``, an optax ``exponential_decay(staircase=True)``) as
epoch->factor functions, and ``cosine_with_warmup``, the ``cosine_warmup``
schedule stepped per batch, as a step->lr function (optax's form). Each
takes a Python number (and gives a float) or an integer tensor (and gives an
fp32 tensor on its device, so that the port's optimizers compute their lr on
the device, inside a CUDA graph, as the JAX schedule is traced into the
step). The other JAX schedules (``step_schedule``,
``epoch_schedule_to_step``, ``cyclical_cosine``,
``constant_with_cosine_burnin``) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

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
