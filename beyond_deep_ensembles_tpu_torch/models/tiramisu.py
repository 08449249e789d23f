"""MidasTiramisu: a UNet-like monocular-depth net.

Counterpart of ``beyond_deep_ensembles_tpu/models/tiramisu.py`` (reference
src/architectures/densenet.py:9-94), in NCHW x OIHW: a 3x3 stem of 64
channels, four :class:`DenseNetBlock` encoders (growth 16; 4, 5, 7 and 10
layers, each a 1x1 conv over the grown tensor and a 2x2 max pool), a
decoder of ``features``-wide 3x3 projections, :class:`ResidualConvUnit` and
:class:`FeatureFusionBlock` stages with 2x bilinear upsampling, and a head
of 128, 32 and 1 channels under ReLU. Unused by the experiments of both
packages; the JAX package exports it. Submodules carry flax's scope names
(``Conv_k``, ``DenseNetBlock_k``, ``FeatureFusionBlock_k/
ResidualConvUnit_k``), so ``models/jax_convert.py`` maps the JAX parameters
by path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import add_auto_named
from ..nn.plain import Conv


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling (JAX ``jax.image.resize(..., "bilinear")``,
    half-pixel centres, the edge rows reading the edge): torch's
    ``align_corners=False`` without antialiasing."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False, antialias=False)


class DenseNetBlock(nn.Module):
    """``layers`` times: a 3x3 conv of ``growth_rate`` channels over the
    ReLU of the tensor, concatenated to it; then a 1x1 conv keeping the
    width and a 2x2 max pool."""

    def __init__(self, in_features: int, growth_rate: int, layers: int, *, generator: torch.Generator):
        super().__init__()
        convs, c = [], in_features
        for _ in range(layers):
            convs.append(add_auto_named(self, Conv(c, growth_rate, (3, 3), padding=1, generator=generator)))
            c += growth_rate
        self.out_features = c
        squeeze = add_auto_named(self, Conv(c, c, (1, 1), generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (tuple(convs), squeeze)

    def forward(self, x):
        convs, squeeze = self._layers
        for conv in convs:
            x = torch.cat([x, conv(F.relu(x))], dim=1)
        return F.max_pool2d(squeeze(x), 2, stride=2)


class ResidualConvUnit(nn.Module):
    """``x + conv(relu(conv(relu(x))))``, both 3x3 convs keeping the
    width."""

    def __init__(self, features: int, *, generator: torch.Generator):
        super().__init__()
        conv1 = add_auto_named(self, Conv(features, features, (3, 3), padding=1, generator=generator))
        conv2 = add_auto_named(self, Conv(features, features, (3, 3), padding=1, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (conv1, conv2)

    def forward(self, x):
        conv1, conv2 = self._layers
        return conv2(F.relu(conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """``upsample2x(rcu_1(decoder + rcu_0(encoder)))``."""

    def __init__(self, features: int, *, generator: torch.Generator):
        super().__init__()
        rcu0 = add_auto_named(self, ResidualConvUnit(features, generator=generator))
        rcu1 = add_auto_named(self, ResidualConvUnit(features, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (rcu0, rcu1)

    def forward(self, encoder_input, decoder_input):
        rcu0, rcu1 = self._layers
        return _upsample2x(rcu1(decoder_input + rcu0(encoder_input)))


class MidasTiramisu(nn.Module):
    """``forward(x, noise=None, train=True)`` -> a ``[B, 1, H, W]`` depth map
    (ReLU) for a ``[B, in_channels, H, W]`` image, H and W multiples of
    16."""

    def __init__(self, features: int = 256, in_channels: int = 3, *, generator: torch.Generator):
        super().__init__()
        f = features
        stem = add_auto_named(self, Conv(in_channels, 64, (3, 3), padding=1, generator=generator))
        encoders, c = [], 64
        for layers in (4, 5, 7, 10):
            enc = add_auto_named(self, DenseNetBlock(c, 16, layers, generator=generator))
            encoders.append(enc)
            c = enc.out_features
        widths = [e.out_features for e in encoders]  # 128, 208, 320, 480
        proj4 = add_auto_named(self, Conv(widths[3], f, (3, 3), padding=1, generator=generator))
        rcu = add_auto_named(self, ResidualConvUnit(f, generator=generator))
        fusions = []
        for width in (widths[2], widths[1], widths[0]):
            proj = add_auto_named(self, Conv(width, f, (3, 3), padding=1, generator=generator))
            fusions.append((proj, add_auto_named(self, FeatureFusionBlock(f, generator=generator))))
        head = (add_auto_named(self, Conv(f, 128, (3, 3), padding=1, generator=generator)),
                add_auto_named(self, Conv(128, 32, (3, 3), padding=1, generator=generator)),
                add_auto_named(self, Conv(32, 1, (1, 1), generator=generator)))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, tuple(encoders), proj4, rcu, tuple(fusions), head)

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        stem, encoders, proj4, rcu, fusions, head = self._layers
        h = stem(x)
        skips = []
        for enc in encoders:
            h = enc(h)
            skips.append(h)
        dec = _upsample2x(rcu(proj4(skips[3])))
        for (proj, fusion), skip in zip(fusions, (skips[2], skips[1], skips[0])):
            dec = fusion(proj(skip), dec)
        for conv in head:
            dec = F.relu(conv(dec))
        return dec
