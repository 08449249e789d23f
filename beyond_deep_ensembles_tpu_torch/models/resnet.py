"""ResNets with swappable layer kinds, norms and activations: the CIFAR
ResNet-20, the ResNet-18 of PovertyMap and the bottleneck ResNet-50 of
iWildCam and RxRx1.

Counterpart of ``beyond_deep_ensembles_tpu/models/resnet.py`` (``BasicBlock``,
``ResNet20``, ``ResNet18``, ``Bottleneck``, ``ResNet50``), in NCHW. Ported: ``conv_kind``
``"bbb"`` (variational FRN under ``norm="frn"``), ``"plain"``, ``"rank1"``
(``components``, plain FRN, a ``Rank1Dense`` head; the forward's
``component`` goes to every layer, so one forward runs one joint component)
and ``"spectral"`` (``norm_bound``); the norms ``frn`` and ``batch_static``
(``nn/norm.py``'s ``StaticBatchNorm``: batch statistics at train and at
eval) and the activations ``swish`` and ``relu``; ``dropout_p`` (MC-Dropout:
a ``FixableDropout(p)`` after the stem and after each conv of each block,
the skip's included). As in JAX, ResNet-20 has no norm after the stem, an
8x8 average pool and a dense head of the conv kind, on 32x32 inputs;
:class:`ResNet18` has a stride-1 stem, an unpadded max pool, a global mean
and ``features_only``. :class:`WilsonResNet20` is the bnn-hmc ResNet-20 of
the published Wilson et al. HMC samples. :class:`PreResNet20` is the
reference's pre-activation ResNet-20 (:class:`PreBasicBlock`), which the
JAX package exports and only its tests build. ResNet-20's and
PreResNet-20's ``head_kind`` and ``features_only`` are JAX's.

:class:`ResNet50` is the JAX package's corrected bottleneck ResNet-50 (a
7x7 stride-2 stem, a 3x3 stride-2 max pool, ``stage_sizes`` bottlenecks of
widths 64, 128, 256, 512 expanded 4 times, the stride on the 3x3 conv, a
1x1 projection skip whenever the shape changes, a global mean, a dense head
of ``head_kind``), with ``features_only`` (the 2048 pooled features),
``dropout_freeze_eval`` and ``torchvision`` (bias-free convs, a norm and the
activation after the stem, a norm after the projection: the topology a
torchvision ``resnet50`` state dict loads into, ``models/torch_convert.py``).
Submodules carry flax's scope names (``Conv_0``, ``_Norm_k/StaticBatchNorm_0``,
``Bottleneck_k`` numbered over the whole net, ``Dense_0``), so
``models/jax_convert.py`` maps the JAX parameters by path. ``remat``
``"block"`` or ``"stage"`` runs each bottleneck, or each stage, under
``torch.utils.checkpoint`` (``models/layers.py::rematerialized``: the
recompute replays the forward's draws, as the DenseNet's does), in a
training forward under autograd without a mixture ``component`` (JAX
skips it under one); the parameter names are those of ``"none"``. The norm
``"none"`` (the JAX package's benchmark knob ``no_norm``) is the identity.

``dtype`` is the compute dtype (bf16: parameters stay fp32): as in JAX it
reaches the plain and BBB convs only (``models/layers.py::kind_kwargs``),
which compute and return it; rank-1 and spectral layers, the norms and the
heads get none. So
where an fp32 parameter meets a bf16 tensor the result is fp32 (FRN's
``gamma * x``), a static batch norm returns its input's type with fp32
statistics, the next conv casts back to bf16, and the heads compute in fp32
from bf16 features.

:class:`SNGPResNet20` is the CIFAR SNGP model, which the JAX package keeps
in ``experiments/cifar.py`` (``SNGPResNet20``, ``_resnet20_features``): it
sits here, beside ``ResNet20``, whose trunk it shares; :class:`ResNet50SNGP`
is the WILDS engine's image SNGP model on ResNet-50 (JAX
``experiments/wilds_task.py::_make_sngp``'s ``ImageSNGP``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional, Sequence

from ..nn.base import add_auto_named
from ..nn.dropout import FixableDropout
from ..nn.frn import FilterResponseNorm, VariationalFilterResponseNorm
from ..nn.norm import StaticBatchNorm
from ..nn.plain import Conv, Dense
from ..nn.sngp import SNGPHead
from .layers import call_layer, kind_kwargs, make_conv, make_dense, rematerialized
from .lenet import flatten_nhwc


RESNET50_REMAT_MODES = ("none", "block", "stage")


def _activation(name: str):
    if name == "swish":
        return F.silu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


class _Norm(nn.Module):
    """norm in {'batch_static', 'frn', 'frn_variational', 'none'} (reference
    get_norm_layer, resnet.py:19-28; ``none`` the identity); holds the norm
    under its flax name."""

    def __init__(self, kind: str, features: int, *, generator: torch.Generator):
        super().__init__()
        if kind == "batch_static":
            layer = StaticBatchNorm(features)
        elif kind == "frn":
            layer = FilterResponseNorm(features)
        elif kind == "frn_variational":
            layer = VariationalFilterResponseNorm(features, generator=generator)
        elif kind == "none":
            layer = None  # no norm: the JAX package's benchmark knob (no_norm)
        else:
            raise ValueError(f"unknown norm {kind!r}")
        self.static = kind == "batch_static"
        # a tuple keeps the reference out of the state_dict (one key per parameter)
        self._layer = (None if layer is None else add_auto_named(self, layer),)

    def forward(self, x, noise, train: bool = True):
        layer = self._layer[0]
        if layer is None:
            return x
        if self.static:
            return layer(x)
        return layer(x, noise, train=train)


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
        norm_bound: float = 6.0,
        dtype=None,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)
        kw = kind_kwargs(conv_kind, dtype, norm_bound)

        def conv(cin, kernel, s, padding, use_bias=True):
            layer = make_conv(
                conv_kind, cin, features, (kernel, kernel), strides=s, padding=padding,
                use_bias=use_bias, components=components, generator=generator, **kw,
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


class PreBasicBlock(nn.Module):
    """Reference PreBasicBlock (resnet.py:217-242; JAX :128-180): the
    pre-activation order norm-act-(dropout)-conv twice, and, when the
    stride is not 1, a skip of dropout then a 1x1 stride-s conv without
    bias; no activation after the sum. As in JAX the convs take no compute
    dtype."""

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
        norm_bound: float = 6.0,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)
        kw = kind_kwargs(conv_kind, None, norm_bound)

        def conv(cin, kernel, s, padding, use_bias=True):
            return add_auto_named(self, make_conv(
                conv_kind, cin, features, (kernel, kernel), strides=s, padding=padding, use_bias=use_bias,
                components=components, generator=generator, **kw))

        def drop():
            return None if dropout_p is None else add_auto_named(self, FixableDropout(dropout_p))

        norm1 = add_auto_named(self, _Norm(nk, in_features, generator=generator))
        drop1, conv1 = drop(), conv(in_features, 3, stride, 1)
        norm2 = add_auto_named(self, _Norm(nk, features, generator=generator))
        drop2, conv2 = drop(), conv(features, 3, 1, 1)
        skip = drop3 = None
        if stride != 1:
            drop3, skip = drop(), conv(in_features, 1, stride, 0, use_bias=False)
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (norm1, drop1, conv1, norm2, drop2, conv2, drop3, skip)

    def forward(self, x, noise, train: bool = True, component=None):
        norm1, drop1, conv1, norm2, drop2, conv2, drop3, skip = self._layers
        h = _drop(drop1, self.act(norm1(x, noise, train=train)), noise, train)
        h = call_layer(conv1, h, noise, train, component)
        h = _drop(drop2, self.act(norm2(h, noise, train=train)), noise, train)
        h = call_layer(conv2, h, noise, train, component)
        if skip is not None:
            x = call_layer(skip, _drop(drop3, x, noise, train), noise, train, component)
        return h + x


def _head(parent, kind, classes, components, generator, features_only: bool):
    """The dense head over the 64 pooled features, registered on ``parent``,
    or None under ``features_only``."""
    if features_only:
        return None
    return add_auto_named(parent, make_dense(kind, 64, classes, components=components, generator=generator))


class ResNet20(nn.Module):
    """Reference ResNet20 (resnet.py:122-148); with norm='frn',
    activation='swish' the Wilson-HMC CIFAR architecture.
    ``forward(x, noise, train, component)``: ``component`` is a Rank-1
    model's mixture component, the same for every layer. ``head_kind``
    (default ``conv_kind``) is the head's kind; ``features_only`` returns
    the features: pooled by 8x8 from 32 pixels up, below that unpooled and
    flattened in NHWC order, as JAX does (the head takes the 64 pooled
    features, so a 32-pixel input)."""

    def __init__(
        self,
        classes: int,
        activation: str,
        norm: str,
        conv_kind: str,
        dropout_p: Optional[float] = None,
        components: int = 1,
        dtype=None,
        head_kind: Optional[str] = None,
        features_only: bool = False,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        stem = _stem(self, conv_kind, components, generator, **kind_kwargs(conv_kind, dtype))
        drop = None if dropout_p is None else add_auto_named(self, FixableDropout(dropout_p))
        blocks = _blocks(self, activation, norm, conv_kind, dropout_p, components, generator, dtype)
        head = _head(self, head_kind or conv_kind, classes, components, generator, features_only)
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, drop, blocks, head)

    def forward(self, x, noise, train: bool = True, component=None):
        stem, drop, blocks, head = self._layers
        h = _drop(drop, call_layer(stem, x, noise, train, component), noise, train)
        h = _features(blocks, h, noise, train, component)
        return h if head is None else call_layer(head, h, noise, train, component)


class PreResNet20(nn.Module):
    """Reference PreResNet20 (resnet.py:244-272; JAX :365-405): the 3x3
    stem, nine :class:`PreBasicBlock` of widths 16, 32, 64, a final norm and
    activation, the 8x8 pool from 32 pixels up and a dense head of
    ``head_kind`` (default ``conv_kind``), or the pooled features under
    ``features_only`` (unpooled below 32 pixels, as ResNet-20's). No stem
    dropout; the stem and blocks take no compute dtype, as in JAX."""

    def __init__(
        self,
        classes: int,
        activation: str = "relu",
        norm: str = "batch_static",
        dropout_p: Optional[float] = None,
        conv_kind: str = "plain",
        head_kind: Optional[str] = None,
        components: int = 1,
        features_only: bool = False,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        stem = _stem(self, conv_kind, components, generator)
        widths = [(16, 1), (16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1)]
        blocks, cin = [], 16
        for features, stride in widths:
            blocks.append(add_auto_named(self, PreBasicBlock(
                cin, features, stride, activation, norm, conv_kind, dropout_p, components, generator=generator)))
            cin = features
        final = add_auto_named(self, _Norm(_norm_kind(norm, conv_kind), 64, generator=generator))
        head = _head(self, head_kind or conv_kind, classes, components, generator, features_only)
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, tuple(blocks), final, head)

    def forward(self, x, noise, train: bool = True, component=None):
        stem, blocks, final, head = self._layers
        h = call_layer(stem, x, noise, train, component)
        for block in blocks:
            h = block(h, noise, train=train, component=component)
        h = _pool(self.act(final(h, noise, train=train)), x.shape[2])
        return h if head is None else call_layer(head, h, noise, train, component)


def _stem(parent, conv_kind, components, generator, **kwargs):
    """The 3x3 stem conv, registered on ``parent``; ``kwargs`` go to the
    layer (SNGP's stem bound)."""
    return add_auto_named(parent, make_conv(conv_kind, 3, 16, (3, 3), strides=1, padding=1, components=components,
                                            generator=generator, **kwargs))


def _blocks(parent, activation, norm, conv_kind, dropout_p, components, generator, dtype=None):
    """The nine blocks, registered on ``parent``."""
    widths = [(16, 1), (16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1)]
    blocks, cin = [], 16
    for features, stride in widths:
        blocks.append(add_auto_named(parent, BasicBlock(
            cin, features, stride, activation, norm, conv_kind, dropout_p, components, dtype=dtype,
            generator=generator)))
        cin = features
    return tuple(blocks)


def _features(blocks, h, noise, train: bool, component=None):
    size = h.shape[2]
    for block in blocks:
        h = block(h, noise, train=train, component=component)
    return _pool(h, size)


def _pool(h, input_size: int):
    """The 8x8 average pool from a 32-pixel input up (``[B, 64, 1, 1]`` ->
    ``[B, 64]``), else the features flattened in JAX's NHWC order."""
    if input_size >= 32:
        return F.avg_pool2d(h, 8).flatten(1)
    return h.permute(0, 2, 3, 1).flatten(1)


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


class ResNet18(nn.Module):
    """Reference ResNet18 (resnet.py:150-176; JAX ``models/resnet.py::
    ResNet18``): a 3x3 stride-1 stem of 64, its dropout, a 3x3 stride-2 max
    pool without padding, eight :class:`BasicBlock` of widths (64, 64, 128,
    128, 256, 256, 512, 512), the first of each width past 64 of stride 2, a
    global mean and a dense head of ``head_kind`` (default ``conv_kind``).
    PovertyMap runs it on 8 channels with one output. ``forward(x, noise,
    train, component)`` -> ``[B, classes]``, or the 512 pooled features
    under ``features_only``; the spectral kind's ``norm_bound`` caps the stem
    and every block."""

    WIDTHS = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1))

    def __init__(
        self,
        classes: int,
        activation: str = "relu",
        norm: str = "batch_static",
        dropout_p: Optional[float] = None,
        conv_kind: str = "plain",
        head_kind: Optional[str] = None,
        components: int = 1,
        features_only: bool = False,
        dtype=None,
        norm_bound: float = 6.0,
        in_channels: int = 8,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        stem = add_auto_named(self, make_conv(conv_kind, in_channels, 64, (3, 3), strides=1, padding=1,
                                              components=components, generator=generator,
                                              **kind_kwargs(conv_kind, dtype, norm_bound)))
        drop = None if dropout_p is None else add_auto_named(self, FixableDropout(dropout_p))
        blocks, cin = [], 64
        for features, stride in self.WIDTHS:
            blocks.append(add_auto_named(self, BasicBlock(
                cin, features, stride, activation, norm, conv_kind, dropout_p, components, norm_bound, dtype,
                generator=generator)))
            cin = features
        head = None
        if not features_only:
            head = add_auto_named(self, make_dense(head_kind or conv_kind, cin, classes, components=components,
                                                   generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, drop, tuple(blocks), head)

    def forward(self, x, noise, train: bool = True, component=None):
        stem, drop, blocks, head = self._layers
        h = _drop(drop, call_layer(stem, x, noise, train, component), noise, train)
        h = F.max_pool2d(h, 3, stride=2)
        for block in blocks:
            h = block(h, noise, train=train, component=component)
        h = torch.mean(h, dim=(2, 3))
        return h if head is None else call_layer(head, h, noise, train, component)


class Bottleneck(nn.Module):
    """The JAX package's bottleneck (1x1 reduce to ``features // 4``, 3x3 of
    stride ``stride``, 1x1 expand to ``features``; each conv followed by its
    dropout and a norm, the activation after the first two and after the
    sum), with a 1x1 stride-s projection skip without bias, and its own
    dropout, whenever the stride is not 1 or the channels change. Under
    ``torchvision`` the three convs are bias-free and a norm follows the
    projection (torchvision's ``resnet50`` block, v1.5 stride placement)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        stride: int = 1,
        activation: str = "relu",
        norm: str = "batch_static",
        dropout_p: Optional[float] = None,
        conv_kind: str = "plain",
        components: int = 1,
        torchvision: bool = False,
        dropout_freeze_eval: bool = True,
        dtype=None,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)
        width = features // 4
        bias = not torchvision
        kw = kind_kwargs(conv_kind, dtype)

        def conv(cin, cout, kernel, s, padding, use_bias):
            return add_auto_named(self, make_conv(
                conv_kind, cin, cout, (kernel, kernel), strides=s, padding=padding, use_bias=use_bias,
                components=components, generator=generator, **kw))

        def drop():
            if dropout_p is None:
                return None
            return add_auto_named(self, FixableDropout(dropout_p, freeze_on_eval=dropout_freeze_eval))

        def norm_layer(c):
            return add_auto_named(self, _Norm(nk, c, generator=generator))

        main = []
        for cin, cout, kernel, s, padding in ((in_features, width, 1, 1, 0), (width, width, 3, stride, 1),
                                             (width, features, 1, 1, 0)):
            main.append((conv(cin, cout, kernel, s, padding, bias), drop(), norm_layer(cout)))
        skip = None
        if stride != 1 or in_features != features:
            skip = (conv(in_features, features, 1, stride, 0, False), drop(),
                    norm_layer(features) if torchvision else None)
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (tuple(main), skip)

    def forward(self, x, noise, train: bool = True, component=None):
        main, skip = self._layers
        h = x
        for i, (conv, drop, norm) in enumerate(main):
            h = norm(_drop(drop, call_layer(conv, h, noise, train, component), noise, train), noise, train=train)
            if i < 2:
                h = self.act(h)
        if skip is not None:
            conv, drop, norm = skip
            x = _drop(drop, call_layer(conv, x, noise, train, component), noise, train)
            if norm is not None:
                x = norm(x, noise, train=train)
        return self.act(h + x)


class ResNet50(nn.Module):
    """The JAX package's corrected bottleneck ResNet-50 (see the module
    docstring): ``forward(x, noise, train, component)`` -> logits ``[B,
    classes]``, or the pooled features ``[B, 256 * 2 ** (len(stage_sizes) -
    1)]`` under ``features_only``. ``stage_sizes`` (3, 4, 6, 3) is ResNet-50,
    (1, 1) the WILDS engine's ``tiny`` cut. The spectral kind's
    ``norm_bound`` caps the stem only: the blocks keep ``SpectralNormConv``'s
    default 6.0, as the JAX ``ResNet50`` passes it to no ``Bottleneck``."""

    def __init__(
        self,
        classes: int,
        activation: str = "relu",
        norm: str = "batch_static",
        dropout_p: Optional[float] = None,
        conv_kind: str = "plain",
        head_kind: Optional[str] = None,
        components: int = 1,
        features_only: bool = False,
        dtype=None,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        torchvision: bool = False,
        dropout_freeze_eval: bool = True,
        norm_bound: float = 6.0,
        remat: str = "none",
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        if remat not in RESNET50_REMAT_MODES:
            raise ValueError(f"remat {remat!r} (want one of {RESNET50_REMAT_MODES})")
        self.remat, self.stage_sizes = remat, tuple(stage_sizes)
        self.act = _activation(activation)
        stem = add_auto_named(self, make_conv(conv_kind, 3, 64, (7, 7), strides=2, padding=3,
                                              use_bias=not torchvision, components=components, generator=generator,
                                              **kind_kwargs(conv_kind, dtype, norm_bound)))
        stem_norm = None
        if torchvision:
            stem_norm = add_auto_named(self, _Norm(_norm_kind(norm, conv_kind), 64, generator=generator))
        drop = None
        if dropout_p is not None:
            drop = add_auto_named(self, FixableDropout(dropout_p, freeze_on_eval=dropout_freeze_eval))
        blocks, cin = [], 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 256 * 2**stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(add_auto_named(self, Bottleneck(
                    cin, features, stride, activation, norm, dropout_p, conv_kind, components, torchvision,
                    dropout_freeze_eval, dtype, generator=generator)))
                cin = features
        self.out_features = cin
        head = None
        if not features_only:
            head = add_auto_named(self, make_dense(head_kind or conv_kind, cin, classes, components=components,
                                                   generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, stem_norm, drop, tuple(blocks), head)

    def forward(self, x, noise, train: bool = True, component=None):
        stem, stem_norm, drop, blocks, head = self._layers
        h = call_layer(stem, x, noise, train, component)
        if stem_norm is not None:
            h = self.act(stem_norm(h, noise, train=train))
        h = F.max_pool2d(_drop(drop, h, noise, train), 3, stride=2, padding=1)
        remat = self.remat if train and component is None and torch.is_grad_enabled() else "none"
        start = 0
        for n_blocks in self.stage_sizes:
            stage = blocks[start : start + n_blocks]
            start += n_blocks
            if remat == "stage":
                h = rematerialized(lambda x, stage=stage: _run_blocks(stage, x, noise, train), noise, h, modules=stage)
            elif remat == "block":
                for block in stage:
                    h = rematerialized(lambda x, block=block: block(x, noise, train=train), noise, h, modules=(block,))
            else:
                h = _run_blocks(stage, h, noise, train, component)
        h = torch.mean(h, dim=(2, 3))
        return h if head is None else call_layer(head, h, noise, train, component)


def _run_blocks(blocks, h, noise, train: bool, component=None):
    for block in blocks:
        h = block(h, noise, train=train, component=component)
    return h


class ResNet50SNGP(nn.Module):
    """The image SNGP model on ResNet-50 (JAX ``experiments/wilds_task.py::
    _make_sngp``'s ``ImageSNGP`` for iwildcam and rxrx1): a spectral
    ``ResNet50_0`` featurizer (``features_only``, the default
    ``batch_static`` norm and relu, never the torchvision topology) under
    ``SNGPHead_0(**sngp_kwargs)``. ``forward(x, noise, train, n_samples)``:
    training logits; at eval the head's output for ``n_samples``."""

    def __init__(self, classes: int, sngp_kwargs: Optional[dict] = None, *, generator: torch.Generator,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        net = add_auto_named(self, ResNet50(classes, conv_kind="spectral", features_only=True,
                                            stage_sizes=stage_sizes, generator=generator))
        head = add_auto_named(self, SNGPHead(net.out_features, classes, **(sngp_kwargs or {}), generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (net, head)

    def forward(self, x, noise=None, train: bool = True, n_samples: int = 1):
        net, head = self._layers
        return head(net(x, noise, train=train), noise, train=train, n_samples=n_samples)


def _he_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax ``variance_scaling(2.0, 'fan_in', 'truncated_normal')`` over a
    plain layer's lecun-normal draw: the same truncated normal, its
    standard deviation times sqrt(2)."""
    with torch.no_grad():
        return weight.mul_(math.sqrt(2.0))


class WilsonResNet20(nn.Module):
    """The bnn-hmc ResNet-20 (JAX ``models/resnet.py::WilsonResNet20``,
    reference google-bnn-hmc/bnn_hmc/utils/models.py:95-176 make_resnet_fn),
    the architecture of the published Wilson et al. HMC samples, in NCHW:
    a stem of conv + FRN + activation; three stacks of three blocks (16, 32,
    64 filters; the first block of the second and third stacks strided by
    2), each two 3x3 conv + FRN layers (the activation after the first), a
    biased 1x1 conv + FRN shortcut where the block strides, created after
    the block's two layers, and the activation after the sum; an 8x8 average
    pool and the dense head ``linear``. Every conv is SAME-padded with a
    bias; kernels he-normal. 107 parameter leaves. Modules are named
    ``conv_{i}`` / ``frn_{i}`` in creation order, as the JAX model (and
    haiku's ``conv2_d{,_i}`` / ``frn{,_i}``) numbers them, so a converted
    sample is a name map (``data/wilson.py``)."""

    def __init__(self, classes: int = 10, activation: str = "swish", width: int = 16, *,
                 generator: torch.Generator):
        super().__init__()
        self.act = _activation(activation)
        count = iter(range(100))

        def layer(cin, features, kernel=3, stride=1):
            i = next(count)
            conv = Conv(cin, features, (kernel, kernel), strides=stride, padding="SAME", generator=generator)
            _he_normal_(conv.kernel)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"frn_{i}", FilterResponseNorm(features))
            return i

        filters = width
        stem = layer(3, filters)
        blocks, cin = [], filters
        for stack in range(3):
            for block in range(3):
                stride = 2 if (stack > 0 and block == 0) else 1
                first, second = layer(cin, filters, stride=stride), layer(filters, filters)
                shortcut = layer(cin, filters, kernel=1, stride=stride) if stack > 0 and block == 0 else None
                blocks.append((first, second, shortcut))
                cin = filters
            filters *= 2
        self.linear = Dense(cin, classes, generator=generator)
        _he_normal_(self.linear.kernel)
        self._plan = (stem, tuple(blocks))

    def _layer(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"frn_{i}")(getattr(self, f"conv_{i}")(h))

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        stem, blocks = self._plan
        h = self.act(self._layer(stem, x))
        for first, second, shortcut in blocks:
            y = self._layer(second, self.act(self._layer(first, h)))
            if shortcut is not None:
                h = self._layer(shortcut, h)
            h = self.act(h + y)
        h = F.avg_pool2d(h, 8, 8)
        return self.linear(flatten_nhwc(h))
