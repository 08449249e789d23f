"""Normalization layers.

Counterpart of ``beyond_deep_ensembles_tpu/nn/norm.py``, in NCHW:
``StaticBatchNorm`` is BatchNorm without running statistics, batch
statistics at train and at eval (the reference's
``BatchNorm2d(track_running_stats=False)`` and its ``static_bn`` patch,
util.py:204-218). It holds a learned ``scale`` and ``bias`` and no buffer.
``BatchNorm`` is the one with running statistics (``static_bn: false``):
flax's ``nn.BatchNorm(use_running_average=not train)`` as the JAX DenseNet
uses it, its ``mean`` and ``var`` buffers the JAX ``batch_stats``
collection.

Under a data-parallel mesh (``parallel/mesh.py::use_mesh``) the statistics
are the whole batch's: the shard's mean and mean square averaged over the
data axis, with autograd, in training and at eval (the static BN takes
batch statistics in both), as the JAX package's global statistics make the
sharded step the one-device step (JAX ``wilds_task.py:686-688``).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

@contextlib.contextmanager
def recomputing(modules):
    """Within the block every :class:`BatchNorm` under ``modules`` normalizes
    as in training but leaves its running statistics as they are (the
    backward's recompute of a checkpointed forward steps them no second
    time). The mark is on the layers themselves, not a global or a
    thread-local: the autograd engine may run the recompute on a thread of
    its own, and two models run on two threads must not see each other's
    recompute."""
    norms = [m for root in modules for m in root.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputes += 1
    try:
        yield
    finally:
        for m in norms:
            m.recomputes -= 1


def channel_stats(x: torch.Tensor):
    """Per-channel batch statistics ``(mean, var)`` over every axis but the
    channel axis 1, in fp32 (or wider), the variance as ``E[x^2] - mean^2`` (the JAX
    package's formula: DenseNet's ``incremental_bn`` reuses stats computed
    where a slice of channels was made, so every path must compute them
    alike). Under a data-parallel mesh both means are the whole batch's, by
    one collective."""
    from ..parallel import mesh

    axes = (0,) + tuple(range(2, x.ndim))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = torch.mean(xf, dim=axes)
    square = torch.mean(xf * xf, dim=axes)
    if mesh.active() is not None:
        mean, square = mesh.all_reduce_mean(torch.stack([mean, square])).unbind(0)
    var = square - mean * mean
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


class BatchNorm(nn.Module):
    """BatchNorm with running statistics (flax ``nn.BatchNorm`` at its
    defaults: momentum 0.99, epsilon 1e-5, a learned ``scale`` and ``bias``).
    Training normalizes with the batch's statistics (:func:`channel_stats`,
    the variance biased, clipped at 0 as flax clips it) and steps the
    buffers ``mean`` and ``var`` by ``m * old + (1 - m) * batch`` with that
    same biased variance (torch's ``F.batch_norm`` steps ``running_var`` by
    the unbiased one, with momentum ``1 - m``); eval normalizes with the
    buffers. The buffers are written in place, so a CUDA graph that
    captured a step keeps stepping them and the runners' save and restore
    reach them. The output is the input's type promoted with fp32 (flax's
    ``canonicalize_dtype`` of the input and the fp32 scale and bias)."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.recomputes = 0  # > 0 inside :func:`recomputing`

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            mean, var = channel_stats(x)
            var = torch.clamp(var, min=0.0)
            if not self.recomputes:
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1 - m) * mean)
                    self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        nd = x.ndim
        y = x.to(torch.promote_types(x.dtype, torch.float32)) - _per_channel(mean, nd)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return y * _per_channel(mul, nd) + _per_channel(self.bias, nd)
