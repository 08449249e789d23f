"""GaussLayer: a scalar regression output as a (mean, std) pair.

Counterpart of ``beyond_deep_ensembles_tpu/nn/gauss.py`` (reference
src/architectures/gauss.py:5-24): output ``[..., 2]``, ``[..., 0]`` the mean
(the input), ``[..., 1]`` the std ``softplus(rho)`` broadcast over it. With
``learn_var`` rho is the parameter ``rho__mle``, initialized to
``log(expm1(std_init))``: the ``__mle`` suffix keeps it out of the SVGD and
iVON posteriors (``methods/api.py::non_mle_mask``) and sends it to the
separate SGD of the UCI optimizer (``utils/optim.py::mle_split``). Without
it rho is that constant.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..methods.api import MLE_SUFFIX


def _softplus_inverse(x: float) -> float:
    return math.log(math.expm1(x))


class GaussLayer(nn.Module):
    def __init__(self, std_init: float = 1.0, learn_var: bool = False):
        super().__init__()
        self.learn_var = learn_var
        self.rho_init = _softplus_inverse(std_init)
        if learn_var:
            self.register_parameter("rho" + MLE_SUFFIX, nn.Parameter(torch.full((1,), self.rho_init)))

    def forward(self, x: torch.Tensor, noise=None, train: bool = True) -> torch.Tensor:
        del noise, train
        if self.learn_var:
            rho = getattr(self, "rho" + MLE_SUFFIX)
        else:
            rho = torch.full((1,), self.rho_init, dtype=x.dtype, device=x.device)
        std = F.softplus(rho)
        return torch.stack([x, std.expand(x.shape)], dim=-1)
