"""Config-driven DenseNet (the DenseNet-121 of Camelyon17 and FMoW).

Counterpart of ``beyond_deep_ensembles_tpu/models/densenet.py`` (reference
src/architectures/densenet.py:98-210), in NCHW x OIHW. Dense layers are
norm-relu-1x1 conv-norm-relu-3x3 conv with a bottleneck of ``bn_size *
growth_rate`` channels, transitions halve the channels with a 1x1 conv and a
2x2 average pool, and the features are the global mean of the last block's
normalized output. Every norm is ``StaticBatchNorm`` (batch statistics at
train and at eval, the ``static_bn`` setting of every yaml row). Submodules
carry flax's scope names (``DenseNet_0/Conv_0``, ``_BN_k/
StaticBatchNorm_0``, ``DenseLayer_i`` numbered over the whole net,
``Dense_0`` for the head), so ``models/jax_convert.py`` maps the JAX
parameters by path.

Three options change how the forward is computed and never what it computes
(each held equal to the plain form by tests/test_torch_densenet.py):

* ``incremental_bn``: layer j + 1's input is ``concat(input_j, new_j)``,
  whose per-channel statistics are those already computed for ``input_j``
  and those of ``new_j``, so each layer's input norm (and each transition's
  and the last) reduces over the new channels only;
* ``concat_mode`` ``"buffer"``: the block's final-width tensor is made once
  and each layer's channels are written into it (``slice_scatter``, a new
  tensor under autograd), where ``"concat"`` concatenates per layer;
* ``remat`` ``"layer"`` or ``"block"``: each dense layer, or each dense
  block, runs under ``torch.utils.checkpoint`` (non-reentrant, without
  saving the RNG state: every draw comes from the forward's
  ``NoiseSource``, which the recompute replays from the draw index where the
  forward began, ``NoiseSource.replay``). As in JAX it is skipped when a
  mixture ``component`` is passed, and outside a training forward under
  autograd (an eval forward has no backward; the Laplace GGN's
  ``torch.func.jacrev`` of one takes no checkpoint).

Options the yamls do not set raise: running statistics
(``track_running_stats``, ``static_bn: false``), ``norm_off`` (the JAX
package's benchmark knob) and a reduced-precision ``dtype`` (ROADMAP).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import add_auto_named
from ..nn.dropout import FixableDropout
from ..nn.norm import StaticBatchNorm, channel_stats
from ..nn.sngp import SNGPHead
from .layers import call_layer, make_conv, make_dense, rematerialized

REMAT_MODES = ("none", "layer", "block")
CONCAT_MODES = ("concat", "buffer")


class _BN(nn.Module):
    """The JAX ``_BN`` scope around its ``StaticBatchNorm_0``."""

    def __init__(self, features: int):
        super().__init__()
        self.StaticBatchNorm_0 = StaticBatchNorm(features)

    def forward(self, x, stats=None):
        return self.StaticBatchNorm_0(x, stats)


def _drop(layer, h, noise, train: bool):
    return h if layer is None else layer(h, noise, train=train)


class DenseLayer(nn.Module):
    """BN-ReLU-1x1 conv (``bn_size * growth_rate``), dropout, BN-ReLU-3x3
    conv (``growth_rate``), dropout; ``forward`` returns the new channels."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int, conv_kind: str = "plain",
                 components: int = 1, dropout_p: Optional[float] = None, dropout_freeze_eval: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        mid = bn_size * growth_rate

        def drop():
            if dropout_p is None:
                return None
            return add_auto_named(self, FixableDropout(dropout_p, freeze_on_eval=dropout_freeze_eval))

        bn1 = add_auto_named(self, _BN(in_features))
        conv1 = add_auto_named(self, make_conv(conv_kind, in_features, mid, (1, 1), use_bias=False,
                                               components=components, generator=generator))
        drop1 = drop()
        bn2 = add_auto_named(self, _BN(mid))
        conv2 = add_auto_named(self, make_conv(conv_kind, mid, growth_rate, (3, 3), padding=1, use_bias=False,
                                               components=components, generator=generator))
        drop2 = drop()
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (bn1, conv1, drop1, bn2, conv2, drop2)

    def forward(self, x, noise, train: bool = True, component=None, bn_stats=None):
        bn1, conv1, drop1, bn2, conv2, drop2 = self._layers
        h = F.relu(bn1(x, bn_stats))
        h = _drop(drop1, call_layer(conv1, h, noise, train, component), noise, train)
        h = F.relu(bn2(h))
        h = call_layer(conv2, h, noise, train, component)
        return _drop(drop2, h, noise, train)


class DenseNet(nn.Module):
    """The feature extractor: ``forward(x, noise, train, component)`` ->
    pooled features ``[B, out_features]`` (reference DenseNet,
    densenet.py:166-202). DenseNet-121: growth 32, blocks (6, 12, 24, 16),
    64 initial features, bn_size 4. ``dropout_p`` puts a ``FixableDropout``
    after the stem and after each conv of a dense layer (never in a
    transition); ``dropout_freeze_eval`` is camelyon17's frozen-mask eval,
    false for fmow (rescaled per-element masks at eval)."""

    def __init__(
        self,
        growth_rate: int = 32,
        block_config: Sequence[int] = (6, 12, 24, 16),
        init_features: int = 64,
        bn_size: int = 4,
        conv_kind: str = "plain",
        components: int = 1,
        dropout_p: Optional[float] = None,
        track_running_stats: bool = False,
        dropout_freeze_eval: bool = True,
        dtype=None,
        remat: str = "none",
        incremental_bn: bool = True,
        norm_off: bool = False,
        concat_mode: str = "concat",
        in_channels: int = 3,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        if track_running_stats:
            raise NotImplementedError("DenseNet BatchNorm with running statistics (static_bn: false): not ported yet")
        if norm_off:
            raise NotImplementedError("DenseNet norm_off (a benchmark knob of the JAX package): not ported")
        if dtype not in (None, torch.float32):
            raise NotImplementedError("a reduced-precision DenseNet: not ported yet (ROADMAP item 13)")
        if remat not in REMAT_MODES:
            raise ValueError(f"remat {remat!r} (want one of {REMAT_MODES})")
        if concat_mode not in CONCAT_MODES:
            raise ValueError(f"concat_mode {concat_mode!r} (want one of {CONCAT_MODES})")
        self.growth_rate, self.block_config = growth_rate, tuple(block_config)
        self.remat, self.incremental_bn, self.concat_mode = remat, incremental_bn, concat_mode
        stem = add_auto_named(self, make_conv(conv_kind, in_channels, init_features, (7, 7), strides=2, padding=3,
                                              use_bias=False, components=components, generator=generator))
        stem_bn = add_auto_named(self, _BN(init_features))
        stem_drop = None
        if dropout_p is not None:
            stem_drop = add_auto_named(self, FixableDropout(dropout_p, freeze_on_eval=dropout_freeze_eval))
        blocks, transitions, c = [], [], init_features
        for i, n_layers in enumerate(self.block_config):
            layers = []
            for _ in range(n_layers):
                layers.append(add_auto_named(self, DenseLayer(
                    c, growth_rate, bn_size, conv_kind, components, dropout_p, dropout_freeze_eval,
                    generator=generator)))
                c += growth_rate
            blocks.append(tuple(layers))
            if i != len(self.block_config) - 1:
                bn = add_auto_named(self, _BN(c))
                conv = add_auto_named(self, make_conv(conv_kind, c, c // 2, (1, 1), use_bias=False,
                                                      components=components, generator=generator))
                transitions.append((bn, conv))
                c //= 2
        final_bn = add_auto_named(self, _BN(c))
        self.out_features = c
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (stem, stem_bn, stem_drop, tuple(blocks), tuple(transitions), final_bn)

    def _block(self, layers, remat_layers: bool, noise, train: bool, component, h, stats):
        """One dense block from its input ``h`` and its stats (or None):
        the block's output and its per-channel stats (or None)."""
        c = h.shape[1]
        buffer = self.concat_mode == "buffer"
        if buffer:
            buf = torch.zeros((h.shape[0], c + len(layers) * self.growth_rate) + tuple(h.shape[2:]),
                              dtype=h.dtype, device=h.device)
            buf = buf.slice_scatter(h, dim=1, start=0, end=c)
        for layer in layers:
            cur = buf[:, :c] if buffer else h
            if remat_layers:
                new = rematerialized(
                    lambda x, s, layer=layer: layer(x, noise, train=train, component=component, bn_stats=s),
                    noise, cur, stats)
            else:
                new = layer(cur, noise, train=train, component=component, bn_stats=stats)
            if stats is not None:
                nm, nv = channel_stats(new)
                stats = (torch.cat([stats[0], nm]), torch.cat([stats[1], nv]))
            if buffer:
                buf = buf.slice_scatter(new, dim=1, start=c, end=c + new.shape[1])
            else:
                h = torch.cat([h, new], dim=1)
            c += new.shape[1]
        return (buf if buffer else h), stats

    def forward(self, x, noise, train: bool = True, component=None):
        stem, stem_bn, stem_drop, blocks, transitions, final_bn = self._layers
        h = F.relu(stem_bn(call_layer(stem, x, noise, train, component)))
        h = _drop(stem_drop, h, noise, train)
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        remat = self.remat if train and component is None and torch.is_grad_enabled() else "none"
        stats = None
        for i, layers in enumerate(blocks):
            stats0 = channel_stats(h) if self.incremental_bn else None
            if remat == "block":
                h, stats = rematerialized(
                    lambda x, s, layers=layers: self._block(layers, False, noise, train, component, x, s),
                    noise, h, stats0)
            else:
                h, stats = self._block(layers, remat == "layer", noise, train, component, h, stats0)
            if i < len(transitions):
                bn, conv = transitions[i]
                t = F.relu(bn(h, stats))
                h = F.avg_pool2d(call_layer(conv, t, noise, train, component), 2, stride=2)
        h = F.relu(final_bn(h, stats))
        return torch.mean(h, dim=(2, 3))


class DenseNetClassifier(nn.Module):
    """``DenseNet_0`` and a dense head of ``head_kind`` (reference
    densenet.py:204-210): ``forward(x, noise, train, component)`` ->
    logits ``[B, classes]``."""

    def __init__(self, classes: int, head_kind: Optional[str] = None, *, generator: torch.Generator,
                 components: int = 1, conv_kind: str = "plain", **densenet_kwargs):
        super().__init__()
        net = add_auto_named(self, DenseNet(conv_kind=conv_kind, components=components, generator=generator,
                                            **densenet_kwargs))
        head = add_auto_named(self, make_dense(head_kind or conv_kind, net.out_features, classes,
                                               components=components, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (net, head)

    def forward(self, x, noise, train: bool = True, component=None):
        net, head = self._layers
        return call_layer(head, net(x, noise, train=train, component=component), noise, train, component)


class DenseNetSNGP(nn.Module):
    """The image SNGP model on a DenseNet (JAX ``experiments/wilds_task.py::
    _make_sngp``'s ``ImageSNGP``): a spectral-normalized ``DenseNet_0``
    featurizer under ``SNGPHead_0(**sngp_kwargs)``. ``forward(x, noise,
    train, n_samples)``: training logits; at eval the head's output for
    ``n_samples``."""

    def __init__(self, classes: int, sngp_kwargs: Optional[dict] = None, *, generator: torch.Generator,
                 **densenet_kwargs):
        super().__init__()
        net = add_auto_named(self, DenseNet(conv_kind="spectral", generator=generator, **densenet_kwargs))
        head = add_auto_named(self, SNGPHead(net.out_features, classes, **(sngp_kwargs or {}), generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (net, head)

    def forward(self, x, noise=None, train: bool = True, n_samples: int = 1):
        net, head = self._layers
        return head(net(x, noise, train=train), noise, train=train, n_samples=n_samples)
