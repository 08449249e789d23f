"""Layer-type factories.

Counterpart of ``beyond_deep_ensembles_tpu/models/layers.py``: a kind string
selects the layer class so architectures stay agnostic. Only ``"bbb"`` is
ported; the other kinds raise.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..nn.bbb import BBBConv, BBBDense
from ..nn.convops import Padding


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
    if kind == "bbb":
        return BBBConv(
            in_features, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, generator=generator, **kwargs,
        )
    raise _not_ported("conv", kind)


def call_layer(layer: nn.Module, x, noise, train: bool):
    """Invoke a factory-made layer with the right signature."""
    return layer(x, noise, train=train)
