"""Learning-rate schedules as epoch->factor functions.

Counterpart of ``beyond_deep_ensembles_tpu/utils/schedules.py``; only the
Wilson schedule is ported so far. A factor takes a Python number (and gives a
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
