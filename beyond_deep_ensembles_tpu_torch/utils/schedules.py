"""Learning-rate schedules as step->factor functions.

Counterpart of ``beyond_deep_ensembles_tpu/utils/schedules.py``; only the
Wilson schedule is ported so far. Factors are plain Python floats, fed to
``torch.optim.lr_scheduler.LambdaLR``.
"""
from __future__ import annotations

from typing import Optional


def wilson_schedule(pretrain_epochs: int, lr_init: float, swag_lr: Optional[float] = None):
    """Wilson et al. SWAG schedule (reference src/algos/util.py:43-54):
    flat, linear decay from 50% to 90%, then flat at the SWA LR."""
    lr_ratio = swag_lr / lr_init if swag_lr is not None else 0.01

    def factor(epoch: int) -> float:
        t = epoch / pretrain_epochs
        if t <= 0.5:
            return 1.0
        if t <= 0.9:
            return 1.0 - (1.0 - lr_ratio) * (t - 0.5) / 0.4
        return lr_ratio

    return factor
