"""Plain (deterministic) layers with flax's initializers.

``Conv``, ``Dense`` and ``LayerNorm`` hold flax ``nn.Conv``'s, ``nn.Dense``'s
and ``nn.LayerNorm``'s parameters (kernels transposed to PyTorch's layouts);
``lecun_normal_`` is flax's default kernel init, which the Bayesian layers
use for their deterministic kernels too. ``dtype`` is flax's compute dtype:
``Conv`` and ``Dense`` cast their input, kernel and bias to it (flax's
``promote_dtype``; without one, to the promoted type of the three, so a bf16
input to an fp32 layer computes in fp32), ``LayerNorm`` takes its statistics
in fp32 and returns ``dtype`` (without one, the promoted type of the input
and its parameters). Parameters stay fp32. The model builders
(``models/layers.py``, ``models/bert.py``) and the heads in this package
import them from here.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
from torch import nn

from .convops import Padding, conv2d

# flax's lecun_normal: a normal truncated at two standard deviations, whose
# stddev is divided by this (the std of a unit normal truncated at +-2) so
# the draws have variance 1/fan_in
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``initializers.lecun_normal()``: truncated normal in [-2, 2]
    standard deviations, variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def promote_dtype(x: torch.Tensor, *params, dtype=None):
    """flax ``promote_dtype``: the dtype a layer computes in, ``dtype`` or
    else the promoted type of ``x`` and its parameters (None entries
    skipped)."""
    if dtype is not None:
        return dtype
    out = x.dtype
    for p in params:
        if p is not None:
            out = torch.promote_types(out, p.dtype)
    return out


class Conv(nn.Module):
    """Plain 2-D convolution (JAX ``models/layers.py::Conv``, flax
    ``nn.Conv``'s parameters): ``kernel`` OIHW with lecun-normal init at fan-in
    ``I * kh * kw``, ``bias`` zero. Computes through ``nn/convops.conv2d`` in
    ``dtype`` (the output's dtype too)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: Union[int, Sequence[int]] = 1,
        padding: Padding = 0,
        use_bias: bool = True,
        dtype=None,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.dtype = dtype
        kh, kw = kernel_size
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(features, in_features, kh, kw))
        lecun_normal_(self.kernel, in_features * kh * kw, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        dt = promote_dtype(x, self.kernel, self.bias, dtype=self.dtype)
        out = conv2d(x, self.kernel, self.strides, self.padding, dtype=dt)
        if self.bias is not None:
            out = out + self.bias.to(dt)[:, None, None]
        return out


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` ``[features, in_features]`` (flax's
    ``[in, out]`` transposed) with lecun-normal init, ``bias`` zero; computes in
    ``dtype``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        lecun_normal_(self.kernel, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        dt = promote_dtype(x, self.kernel, self.bias, dtype=self.dtype)
        out = x.to(dt) @ self.kernel.to(dt).T
        return out if self.bias is None else out + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (HF's is
    1e-12), the variance as E[x^2] - E[x]^2 clipped at 0, ``scale`` ones,
    ``bias`` zeros; statistics and arithmetic in fp32 (or wider), the output
    in ``dtype``."""

    def __init__(self, features: int, epsilon: float = 1e-6, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = promote_dtype(x, self.scale, self.bias, dtype=self.dtype)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return ((x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias).to(out)
