"""Normalization layers.

Counterpart of ``beyond_deep_ensembles_tpu/nn/norm.py``, in NCHW:
``StaticBatchNorm`` is BatchNorm without running statistics, batch
statistics at train and at eval (the reference's
``BatchNorm2d(track_running_stats=False)`` and its ``static_bn`` patch,
util.py:204-218). It holds a learned ``scale`` and ``bias`` and no buffer.
"""
from __future__ import annotations

import torch
from torch import nn


def channel_stats(x: torch.Tensor):
    """Per-channel batch statistics ``(mean, var)`` over every axis but the
    channel axis 1, in fp32 (or wider), the variance as ``E[x^2] - mean^2`` (the JAX
    package's formula: DenseNet's ``incremental_bn`` reuses stats computed
    where a slice of channels was made, so every path must compute them
    alike)."""
    axes = (0,) + tuple(range(2, x.ndim))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = torch.mean(xf, dim=axes)
    var = torch.mean(xf * xf, dim=axes) - mean * mean
    return mean, var


def _per_channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class StaticBatchNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with the batch's
    statistics, or ``stats``: precomputed ``(mean, var)`` that must be the
    statistics of ``x`` itself (DenseNet's cached stats)."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, stats=None) -> torch.Tensor:
        mean, var = channel_stats(x) if stats is None else stats
        nd = x.ndim
        y = (x.to(mean.dtype) - _per_channel(mean, nd)) * _per_channel(torch.rsqrt(var + self.epsilon), nd)
        return (y * _per_channel(self.scale, nd) + _per_channel(self.bias, nd)).to(x.dtype)
