"""MC-Dropout layer.

Counterpart of ``beyond_deep_ensembles_tpu/nn/dropout.py`` (reference
FixableDropout, src/algos/dropout.py:5-25): dropout stays active at
evaluation (that is MC-Dropout). With ``freeze_on_eval`` one mask of the
per-example shape is shared by the whole batch at eval and, faithfully to the
reference, is NOT rescaled by 1/(1-p) (dropout.py:18-20); otherwise every
element draws its own mask and the kept ones are rescaled, in train and eval.

The masks come from the forward's :class:`~.gaussian.NoiseSource`
(``keep_mask``): drawn on the device from its generator or, in key mode,
from counter-hash bits of the device key (so a captured step draws afresh
at each replay), or handed in, in call order, by a test.
"""
from __future__ import annotations

import torch
from torch import nn


def dropout(x: torch.Tensor, rate: float, noise) -> torch.Tensor:
    """Per-element dropout with the kept values rescaled by 1/(1-rate)
    (flax ``nn.Dropout``, and FixableDropout outside frozen eval)."""
    keep = noise.keep_mask(x.shape, x.device, rate)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class FixableDropout(nn.Module):
    def __init__(self, rate: float, freeze_on_eval: bool = True):
        super().__init__()
        self.rate = rate
        self.freeze_on_eval = freeze_on_eval

    def forward(self, x: torch.Tensor, noise, train: bool = True) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        if not train and self.freeze_on_eval:
            mask = noise.keep_mask(x.shape[1:], x.device, self.rate)
            return x * mask.to(x.dtype)
        return dropout(x, self.rate, noise)
