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
and ``features_only``. The other architectures (``PreResNet20``,
``WilsonResNet20``) are not ported yet.

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
``models/jax_convert.py`` maps the JAX parameters by path. ``remat`` other
than ``"none"``, a reduced-precision ``dtype`` and the norm ``"none"`` (a
benchmark knob of the JAX package) raise.

:class:`SNGPResNet20` is the CIFAR SNGP model, which the JAX package keeps
in ``experiments/cifar.py`` (``SNGPResNet20``, ``_resnet20_features``): it
sits here, beside ``ResNet20``, whose trunk it shares; :class:`ResNet50SNGP`
is the WILDS engine's image SNGP model on ResNet-50 (JAX
``experiments/wilds_task.py::_make_sngp``'s ``ImageSNGP``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional, Sequence

from ..nn.base import add_auto_named
from ..nn.dropout import FixableDropout
from ..nn.frn import FilterResponseNorm, VariationalFilterResponseNorm
from ..nn.norm import StaticBatchNorm
from ..nn.sngp import SNGPHead
from .layers import call_layer, make_conv, make_dense


def _activation(name: str):
    if name == "swish":
        return F.silu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


class _Norm(nn.Module):
    """norm in {'batch_static', 'frn', 'frn_variational'} (reference
    get_norm_layer, resnet.py:19-28); holds the norm under its flax name."""

    def __init__(self, kind: str, features: int, *, generator: torch.Generator):
        super().__init__()
        if kind == "batch_static":
            layer = StaticBatchNorm(features)
        elif kind == "frn":
            layer = FilterResponseNorm(features)
        elif kind == "frn_variational":
            layer = VariationalFilterResponseNorm(features, generator=generator)
        elif kind == "none":
            raise NotImplementedError("norm 'none' (a benchmark knob of the JAX package, no_norm): not ported")
        else:
            raise ValueError(f"unknown norm {kind!r}")
        self.static = kind == "batch_static"
        # a tuple keeps the reference out of the state_dict (one key per parameter)
        self._layer = (add_auto_named(self, layer),)

    def forward(self, x, noise, train: bool = True):
        if self.static:
            return self._layer[0](x)
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
        norm_bound: float = 6.0,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)
        kw = {"norm_bound": norm_bound} if conv_kind == "spectral" else {}

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
        if dtype not in (None, torch.float32):
            raise NotImplementedError("a reduced-precision ResNet-18: not ported yet (ROADMAP item 13)")
        kw = {"norm_bound": norm_bound} if conv_kind == "spectral" else {}
        stem = add_auto_named(self, make_conv(conv_kind, in_channels, 64, (3, 3), strides=1, padding=1,
                                              components=components, generator=generator, **kw))
        drop = None if dropout_p is None else add_auto_named(self, FixableDropout(dropout_p))
        blocks, cin = [], 64
        for features, stride in self.WIDTHS:
            blocks.append(add_auto_named(self, BasicBlock(
                cin, features, stride, activation, norm, conv_kind, dropout_p, components, norm_bound,
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
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.act = _activation(activation)
        nk = _norm_kind(norm, conv_kind)
        width = features // 4
        bias = not torchvision

        def conv(cin, cout, kernel, s, padding, use_bias):
            return add_auto_named(self, make_conv(
                conv_kind, cin, cout, (kernel, kernel), strides=s, padding=padding, use_bias=use_bias,
                components=components, generator=generator))

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
        if remat != "none":
            raise NotImplementedError(f"ResNet-50 remat {remat!r}: not ported yet (ROADMAP, queue 1, waiting)")
        if dtype not in (None, torch.float32):
            raise NotImplementedError("a reduced-precision ResNet-50: not ported yet (ROADMAP item 13)")
        self.act = _activation(activation)
        kw = {"norm_bound": norm_bound} if conv_kind == "spectral" else {}
        stem = add_auto_named(self, make_conv(conv_kind, 3, 64, (7, 7), strides=2, padding=3,
                                              use_bias=not torchvision, components=components, generator=generator,
                                              **kw))
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
                    dropout_freeze_eval, generator=generator)))
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
        for block in blocks:
            h = block(h, noise, train=train, component=component)
        h = torch.mean(h, dim=(2, 3))
        return h if head is None else call_layer(head, h, noise, train, component)


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
