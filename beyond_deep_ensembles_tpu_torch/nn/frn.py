"""Filter Response Normalization (https://arxiv.org/abs/1911.09737).

Counterpart of ``beyond_deep_ensembles_tpu/nn/frn.py``, in NCHW: statistics
over H and W (dims 2, 3), per-channel parameters, eps = 1e-6. The
variational version keeps the JAX package's fixes to the reference: normal
(not uniform) noise, beta's own sigma in its KL, and ``__gmean``/``__grho``
parameters so the BBB method collects their KL.
"""
from __future__ import annotations

import torch
from torch import nn

from .gaussian import NoiseSource, gaussian_mean_std, gaussian_param


def _c(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class FilterResponseNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.tau = nn.Parameter(torch.zeros(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.gamma = nn.Parameter(torch.ones(features))

    def forward(self, x, noise: NoiseSource = None, train: bool = True):
        del noise, train
        nu2 = torch.mean(torch.square(x), dim=(2, 3), keepdim=True)
        x = x * torch.rsqrt(nu2 + self.eps)
        y = _c(self.gamma) * x + _c(self.beta)
        return torch.maximum(y, _c(self.tau))


class VariationalFilterResponseNorm(nn.Module):
    """Per-example draws ``[B, C]`` of tau, beta and gamma, in that order,
    broadcast over H and W."""

    def __init__(
        self,
        features: int,
        eps: float = 1e-6,
        rho_init: float = -3.0,
        freeze_on_eval: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.eps = eps
        self.freeze_on_eval = freeze_on_eval
        for name, init in (("tau", 0.0), ("beta", 0.0), ("gamma", 1.0)):
            gaussian_param(self, name, (features,), generator, mean_init=init, rho_init=rho_init)

    def forward(self, x, noise: NoiseSource, train: bool = True):
        shape = (x.shape[0], x.shape[1])
        draws = []
        for name in ("tau", "beta", "gamma"):
            mean, std = gaussian_mean_std(self, name)
            eps = noise.normal(shape, x.device, train, self.freeze_on_eval)
            draws.append((mean + std * eps)[:, :, None, None])
        tau, beta, gamma = draws
        nu2 = torch.mean(torch.square(x), dim=(2, 3), keepdim=True)
        x = x * (nu2 + self.eps) ** -0.5
        y = gamma * x + beta
        return torch.maximum(y, tau)
