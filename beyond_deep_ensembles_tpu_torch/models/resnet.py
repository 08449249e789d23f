"""CIFAR-style ResNet-20 with swappable layer kinds, norms and activations.

Counterpart of ``beyond_deep_ensembles_tpu/models/resnet.py`` (``BasicBlock``,
``ResNet20``), in NCHW. Ported: ``conv_kind`` ``"bbb"`` (variational FRN)
and ``"plain"`` (FRN) with ``norm="frn"`` and swish on 32x32 inputs; the
other activations, norms, dropout, other head kinds, smaller inputs and the
other architectures are not ported yet. As in JAX: no norm after the stem,
an 8x8 average pool, a dense head of the conv kind.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import add_auto_named
from ..nn.frn import FilterResponseNorm, VariationalFilterResponseNorm
from .layers import call_layer, make_conv, make_dense


def _activation(name: str):
    if name == "swish":
        return F.silu
    raise NotImplementedError(f"activation {name!r}: not ported yet")


class _Norm(nn.Module):
    """norm in {'frn', 'frn_variational'} (reference get_norm_layer,
    resnet.py:19-28); holds the norm under its flax name."""

    def __init__(self, kind: str, features: int, *, generator: torch.Generator):
        super().__init__()
        if kind == "frn":
            layer = FilterResponseNorm(features)
        elif kind == "frn_variational":
            layer = VariationalFilterResponseNorm(features, generator=generator)
        else:
            raise NotImplementedError(f"norm {kind!r}: not ported yet")
        # a tuple keeps the reference out of the state_dict (one key per parameter)
        self._layer = (add_auto_named(self, layer),)

    def forward(self, x, noise, train: bool = True):
        return self._layer[0](x, noise, train=train)


def _norm_kind(norm: str, conv_kind: str) -> str:
    # Variational FRN only for the BBB variant (reference resnet.py:23-26).
    if norm == "frn" and conv_kind == "bbb":
        return "frn_variational"
    return norm


class BasicBlock(nn.Module):
    """Reference BasicBlock (resnet.py:56-84): conv-norm-act-conv-norm, a 1x1
    stride-s projection skip of the conv kind, without bias, when the stride
    is not 1."""

    def __init__(
        self,
        in_features: int,
        features: int,
        stride: int,
        activation: str,
        norm: str,
        conv_kind: str,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)

        def conv(cin, kernel, s, padding, use_bias=True):
            layer = make_conv(
                conv_kind, cin, features, (kernel, kernel), strides=s, padding=padding,
                use_bias=use_bias, generator=generator,
            )
            return add_auto_named(self, layer)

        conv1 = conv(in_features, 3, stride, 1)
        norm1 = add_auto_named(self, _Norm(nk, features, generator=generator))
        conv2 = conv(features, 3, 1, 1)
        norm2 = add_auto_named(self, _Norm(nk, features, generator=generator))
        skip = conv(in_features, 1, stride, 0, use_bias=False) if stride != 1 else None
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (conv1, norm1, conv2, norm2, skip)

    def forward(self, x, noise, train: bool = True):
        conv1, norm1, conv2, norm2, skip = self._layers
        h = call_layer(conv1, x, noise, train)
        h = self.act(norm1(h, noise, train=train))
        h = call_layer(conv2, h, noise, train)
        h = norm2(h, noise, train=train)
        skip = x if skip is None else call_layer(skip, x, noise, train)
        return self.act(h + skip)


class ResNet20(nn.Module):
    """Reference ResNet20 (resnet.py:122-148); with norm='frn',
    activation='swish' the Wilson-HMC CIFAR architecture, for 32x32
    inputs."""

    def __init__(
        self,
        classes: int,
        activation: str,
        norm: str,
        conv_kind: str,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        stem = add_auto_named(
            self, make_conv(conv_kind, 3, 16, (3, 3), strides=1, padding=1, generator=generator)
        )
        widths = [(16, 1), (16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1)]
        blocks, cin = [], 16
        for features, stride in widths:
            blocks.append(add_auto_named(
                self,
                BasicBlock(cin, features, stride, activation, norm, conv_kind, generator=generator),
            ))
            cin = features
        head = add_auto_named(self, make_dense(conv_kind, 64, classes, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, tuple(blocks), head)

    def forward(self, x, noise, train: bool = True):
        stem, blocks, head = self._layers
        h = call_layer(stem, x, noise, train)
        for block in blocks:
            h = block(h, noise, train=train)
        h = F.avg_pool2d(h, 8).flatten(1)  # [B, 64, 1, 1] -> [B, 64]
        return call_layer(head, h, noise, train)
