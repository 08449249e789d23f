"""Layer-type factories.

Counterpart of ``beyond_deep_ensembles_tpu/models/layers.py``: a kind string
selects the layer class so architectures stay agnostic: ``"plain"``,
``"bbb"``, ``"rank1"`` (with ``components``) and ``"spectral"`` (with
``norm_bound``).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..nn.bbb import BBBConv, BBBDense
from ..nn.convops import Padding
from ..nn.plain import Conv, Dense
from ..nn.rank1 import Rank1Conv, Rank1Dense
from ..nn.spectral_norm import SpectralNormConv, SpectralNormDense


def make_dense(
    kind: str,
    in_features: int,
    features: int,
    use_bias: bool = True,
    components: int = 1,
    *,
    generator: torch.Generator,
    **kwargs,
) -> nn.Module:
    if kind == "plain":
        return Dense(in_features, features, use_bias=use_bias, generator=generator)
    if kind == "bbb":
        return BBBDense(in_features, features, use_bias=use_bias, generator=generator, **kwargs)
    if kind == "rank1":
        return Rank1Dense(in_features, features, components=components, use_bias=use_bias, generator=generator)
    if kind == "spectral":
        return SpectralNormDense(in_features, features, use_bias=use_bias, generator=generator, **kwargs)
    raise ValueError(f"unknown dense kind {kind!r}")


def make_conv(
    kind: str,
    in_features: int,
    features: int,
    kernel_size: Sequence[int],
    strides: Union[int, Sequence[int]] = 1,
    padding: Padding = 0,
    use_bias: bool = True,
    components: int = 1,
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
    if kind == "rank1":
        return Rank1Conv(
            in_features, features, kernel_size, strides=strides, padding=padding, components=components,
            use_bias=use_bias, generator=generator,
        )
    if kind == "spectral":
        return SpectralNormConv(
            in_features, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, generator=generator, **kwargs,
        )
    raise ValueError(f"unknown conv kind {kind!r}")


def call_layer(layer: nn.Module, x, noise, train: bool, component=None):
    """Invoke a factory-made layer with the right signature: a Rank-1 layer
    takes the mixture component."""
    if isinstance(layer, (Rank1Dense, Rank1Conv)):
        return layer(x, noise, train=train, component=component)
    return layer(x, noise, train=train)
