"""Learning-rate schedules as epoch->factor functions.

Counterpart of ``beyond_deep_ensembles_tpu/utils/schedules.py``: the Wilson
schedule, and the staircase exponential decay of the WILDS engine's
``lr_schedule_kind: exponential`` (JAX ``experiments/wilds_task.py::
_scheduled_lr``, an optax ``exponential_decay(staircase=True)``); the
``cosine_warmup`` schedule is not ported yet. A factor takes a Python number (and gives a
float) or an integer tensor (and gives an fp32 tensor on its device, so that
the port's SGD computes its lr on the device, inside a CUDA graph, as the
JAX schedule is traced into the step).
"""
from __future__ import annotations

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
