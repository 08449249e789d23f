"""Layer-type factories.

Counterpart of ``beyond_deep_ensembles_tpu/models/layers.py``: a kind string
selects the layer class so architectures stay agnostic. Ported: ``"plain"``
and ``"bbb"``; the other kinds raise.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
from torch import nn

from ..nn.bbb import BBBConv, BBBDense
from ..nn.convops import Padding, conv2d

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


class Conv(nn.Module):
    """Plain 2-D convolution (JAX ``models/layers.py::Conv``, flax
    ``nn.Conv``'s parameters): ``kernel`` OIHW with lecun-normal init at fan-in
    ``I * kh * kw``, ``bias`` zero. Computes through ``nn/convops.conv2d``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: Union[int, Sequence[int]] = 1,
        padding: Padding = 0,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self.kernel = nn.Parameter(torch.empty(features, in_features, kh, kw))
        lecun_normal_(self.kernel, in_features * kh * kw, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        out = conv2d(x, self.kernel, self.strides, self.padding)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` ``[features, in_features]`` (flax's
    ``[in, out]`` transposed) with lecun-normal init, ``bias`` zero."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        lecun_normal_(self.kernel, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        out = x @ self.kernel.T
        return out if self.bias is None else out + self.bias


def _not_ported(what: str, kind: str):
    return NotImplementedError(f"{what} kind {kind!r}: not ported yet")


def make_dense(
    kind: str,
    in_features: int,
    features: int,
    use_bias: bool = True,
    *,
    generator: torch.Generator,
    **kwargs,
) -> nn.Module:
    if kind == "plain":
        return Dense(in_features, features, use_bias=use_bias, generator=generator)
    if kind == "bbb":
        return BBBDense(in_features, features, use_bias=use_bias, generator=generator, **kwargs)
    raise _not_ported("dense", kind)


def make_conv(
    kind: str,
    in_features: int,
    features: int,
    kernel_size: Sequence[int],
    strides: Union[int, Sequence[int]] = 1,
    padding: Padding = 0,
    use_bias: bool = True,
    *,
    generator: torch.Generator,
    **kwargs,
) -> nn.Module:
    if kind == "plain":
        return Conv(
            in_features, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, generator=generator,
        )
    if kind == "bbb":
        return BBBConv(
            in_features, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, generator=generator, **kwargs,
        )
    raise _not_ported("conv", kind)


def call_layer(layer: nn.Module, x, noise, train: bool):
    """Invoke a factory-made layer with the right signature."""
    return layer(x, noise, train=train)
