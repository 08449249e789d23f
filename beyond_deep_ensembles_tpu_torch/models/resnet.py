"""CIFAR-style ResNet-20 with swappable layer kinds, norms and activations.

Counterpart of ``beyond_deep_ensembles_tpu/models/resnet.py`` (``BasicBlock``,
``ResNet20``), in NCHW. Ported: ``conv_kind`` ``"bbb"`` (variational FRN),
``"plain"``, ``"rank1"`` (``components``, plain FRN, a ``Rank1Dense`` head;
the forward's ``component`` goes to every layer, so one forward runs one
joint component) and ``"spectral"`` (bound 6.0) with ``norm="frn"`` and
swish on 32x32 inputs, and ``dropout_p`` (MC-Dropout: a ``FixableDropout(p)``
after the stem and after each conv of each block, the skip's included); the
other activations, norms, head kinds, smaller inputs and the other
architectures are not ported yet. As in JAX: no norm after the stem, an 8x8
average pool, a dense head of the conv kind.

:class:`SNGPResNet20` is the CIFAR SNGP model, which the JAX package keeps
in ``experiments/cifar.py`` (``SNGPResNet20``, ``_resnet20_features``): it
sits here, beside ``ResNet20``, whose trunk it shares.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional

from ..nn.base import add_auto_named
from ..nn.dropout import FixableDropout
from ..nn.frn import FilterResponseNorm, VariationalFilterResponseNorm
from ..nn.sngp import SNGPHead
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
    """Reference BasicBlock (resnet.py:56-84): conv-(dropout)-norm-act-conv-
    (dropout)-norm, a 1x1 stride-s projection skip of the conv kind, without
    bias and followed by its own dropout, when the stride is not 1."""

    def __init__(
        self,
        in_features: int,
        features: int,
        stride: int,
        activation: str,
        norm: str,
        conv_kind: str,
        dropout_p: Optional[float] = None,
        components: int = 1,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)

        def conv(cin, kernel, s, padding, use_bias=True):
            layer = make_conv(
                conv_kind, cin, features, (kernel, kernel), strides=s, padding=padding,
                use_bias=use_bias, components=components, generator=generator,
            )
            return add_auto_named(self, layer)

        def drop():
            return None if dropout_p is None else add_auto_named(self, FixableDropout(dropout_p))

        conv1, drop1 = conv(in_features, 3, stride, 1), drop()
        norm1 = add_auto_named(self, _Norm(nk, features, generator=generator))
        conv2, drop2 = conv(features, 3, 1, 1), drop()
        norm2 = add_auto_named(self, _Norm(nk, features, generator=generator))
        skip = drop3 = None
        if stride != 1:
            skip, drop3 = conv(in_features, 1, stride, 0, use_bias=False), drop()
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (conv1, drop1, norm1, conv2, drop2, norm2, skip, drop3)

    def forward(self, x, noise, train: bool = True, component=None):
        conv1, drop1, norm1, conv2, drop2, norm2, skip, drop3 = self._layers
        h = _drop(drop1, call_layer(conv1, x, noise, train, component), noise, train)
        h = self.act(norm1(h, noise, train=train))
        h = _drop(drop2, call_layer(conv2, h, noise, train, component), noise, train)
        h = norm2(h, noise, train=train)
        skip = x if skip is None else _drop(drop3, call_layer(skip, x, noise, train, component), noise, train)
        return self.act(h + skip)


def _drop(layer, h, noise, train: bool):
    return h if layer is None else layer(h, noise, train=train)


class ResNet20(nn.Module):
    """Reference ResNet20 (resnet.py:122-148); with norm='frn',
    activation='swish' the Wilson-HMC CIFAR architecture, for 32x32
    inputs. ``forward(x, noise, train, component)``: ``component`` is a
    Rank-1 model's mixture component, the same for every layer."""

    def __init__(
        self,
        classes: int,
        activation: str,
        norm: str,
        conv_kind: str,
        dropout_p: Optional[float] = None,
        components: int = 1,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        stem = _stem(self, conv_kind, components, generator)
        drop = None if dropout_p is None else add_auto_named(self, FixableDropout(dropout_p))
        blocks = _blocks(self, activation, norm, conv_kind, dropout_p, components, generator)
        head = add_auto_named(self, make_dense(conv_kind, 64, classes, components=components, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, drop, blocks, head)

    def forward(self, x, noise, train: bool = True, component=None):
        stem, drop, blocks, head = self._layers
        h = _drop(drop, call_layer(stem, x, noise, train, component), noise, train)
        return call_layer(head, _features(blocks, h, noise, train, component), noise, train, component)


def _stem(parent, conv_kind, components, generator, **kwargs):
    """The 3x3 stem conv, registered on ``parent``; ``kwargs`` go to the
    layer (SNGP's stem bound)."""
    return add_auto_named(parent, make_conv(conv_kind, 3, 16, (3, 3), strides=1, padding=1, components=components,
                                            generator=generator, **kwargs))


def _blocks(parent, activation, norm, conv_kind, dropout_p, components, generator):
    """The nine blocks, registered on ``parent``."""
    widths = [(16, 1), (16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1)]
    blocks, cin = [], 16
    for features, stride in widths:
        blocks.append(add_auto_named(parent, BasicBlock(
            cin, features, stride, activation, norm, conv_kind, dropout_p, components, generator=generator)))
        cin = features
    return tuple(blocks)


def _features(blocks, h, noise, train: bool, component=None):
    for block in blocks:
        h = block(h, noise, train=train, component=component)
    return F.avg_pool2d(h, 8).flatten(1)  # [B, 64, 1, 1] -> [B, 64]


class SNGPResNet20(nn.Module):
    """Spectral-normalized ResNet-20 trunk, 8x8 average pool, then
    ``SNGPHead(**sngp_kwargs)`` (JAX ``experiments/cifar.py::SNGPResNet20``,
    reference cifar/models.py:85-99). As in the JAX ``_resnet20_features``,
    ``spectral_norm_bound`` caps the stem conv only: the blocks keep
    ``SpectralNormConv``'s default bound of 6.0.

    ``forward(x, noise, train, n_samples)``: training logits ``[B, 10]``; at
    eval the head's output for ``n_samples`` (``SNGPHead``)."""

    def __init__(self, classes: int = 10, spectral_norm_bound: float = 6.0, sngp_kwargs: Optional[dict] = None,
                 *, generator: torch.Generator):
        super().__init__()
        stem = _stem(self, "spectral", 1, generator, norm_bound=spectral_norm_bound)
        blocks = _blocks(self, "swish", "frn", "spectral", None, 1, generator)
        head = add_auto_named(self, SNGPHead(64, classes, **(sngp_kwargs or {}), generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, blocks, head)

    def forward(self, x, noise=None, train: bool = True, n_samples: int = 1):
        stem, blocks, head = self._layers
        h = _features(blocks, call_layer(stem, x, noise, train), noise, train)
        return head(h, noise, train=train, n_samples=n_samples)
