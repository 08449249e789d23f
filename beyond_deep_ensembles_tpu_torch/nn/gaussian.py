"""Gaussian variational parameters and the noise every stochastic layer draws.

Counterpart of ``beyond_deep_ensembles_tpu/nn/gaussian.py``. A parameter
``w`` becomes two ``nn.Parameter``s ``w__gmean`` and ``w__grho`` with
std = softplus(rho); methods discover them by suffix (``methods/api.py``).

The JAX layers draw their noise and dropout masks from flax RNG streams
(``eval_noise``, ``make_rng("dropout")``). Here each forward takes one
:class:`NoiseSource`, passed down to every
``BBBConv``/``BBBDense``/``VariationalFilterResponseNorm``, every dropout
layer and every attention with live dropout.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import keys
from ..methods.api import GMEAN_SUFFIX, GRHO_SUFFIX
from ..ops.attention import fused_dropout_attention
from ..ops.sampling import DeviceSeed, gaussian_sample

RHO_INIT = -3.0  # Blundell init (reference util.py:161-163)
MEAN_STD_INIT = 0.1
# key mode: per-example and frozen-row normals come from chunks of this many
# counter-hash normals per step, on the key's stream _POOL_STREAM + chunk
_POOL = 1 << 20
_POOL_STREAM = 1 << 31
# key mode: a normal draw of more than _POOL values takes the stream
# _BIG_STREAM + its index
_BIG_STREAM = 3 << 30
# key mode: attention draw d seeds K3 with key + ((d + 1) << _PANEL_SHIFT),
# its panels (b, h) with that plus b H + h < 2^_PANEL_SHIFT
_PANEL_SHIFT = 20


def sign_mean_init(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """+-1 with equal odds: the Rank-1 factors' mean init (JAX
    ``sign_mean_init``, reference util.py:165-168)."""
    return (torch.rand(tuple(shape), generator=generator) > 0.5).to(torch.float32) * 2.0 - 1.0


def gaussian_param(
    module: nn.Module,
    name: str,
    shape: Sequence[int],
    generator: torch.Generator,
    mean_init: Optional[Union[float, Callable]] = None,
    rho_init: float = RHO_INIT,
) -> None:
    """Register ``{name}__gmean`` and ``{name}__grho`` on ``module``. The mean
    is N(0, 0.1) from ``generator``, the constant ``mean_init``, or
    ``mean_init(shape, generator)`` (:func:`sign_mean_init`); rho is
    ``rho_init``."""
    if mean_init is None:
        mean = MEAN_STD_INIT * torch.randn(tuple(shape), generator=generator)
    elif callable(mean_init):
        mean = mean_init(shape, generator)
    else:
        mean = torch.full(tuple(shape), float(mean_init))
    module.register_parameter(name + GMEAN_SUFFIX, nn.Parameter(mean))
    module.register_parameter(
        name + GRHO_SUFFIX, nn.Parameter(torch.full(tuple(shape), float(rho_init)))
    )


def gaussian_mean_std(module: nn.Module, name: str):
    """(mean, std) of the Gaussian parameter ``name`` of ``module``."""
    mean = getattr(module, name + GMEAN_SUFFIX)
    return mean, F.softplus(getattr(module, name + GRHO_SUFFIX))


class NoiseSource:
    """The standard-normal noise and dropout masks of one or more forwards.

    Generator mode (``generator``, a CPU ``torch.Generator``): every BBB
    epilogue and every attention with live dropout takes a fresh 62-bit
    Philox seed from it. On CUDA the K1 and K3 kernels draw in-kernel from
    that seed; on the CPU their plain versions seed ``torch.randn`` or
    ``torch.rand`` with it. The per-example draws of
    ``VariationalFilterResponseNorm`` and the dropout layers' keep masks use a
    generator on the layer's device, seeded once from ``generator``.

    Given mode (``given``, a sequence of tensors): draws are handed out in
    call order, so a test can feed the JAX package's noise and masks to the
    port. A frozen-eval draw is one per-example tensor (the shape without
    batch); an attention's draw is its keep mask ``[B, H, L, L]``.

    Key mode (``key``, a 0-dim int64 tensor on the device; see ``keys.py``):
    every draw is a function of the key's value and the draw's index within
    the forwards, both read by the kernels or computed on the device, so a
    CUDA graph that captured the step draws afresh at each replay once the
    key has advanced, and an eager run from the same key gives the same
    bits. A BBB epilogue passes K1 the seed ``key + index``
    (:class:`DeviceSeed`); the per-example draws of
    ``VariationalFilterResponseNorm`` and frozen rows are taken in turn from
    chunks of :data:`_POOL` counter-hash normals (``keys.normal``, one chunk
    drawn per 2^20 values), and a draw of more than 2^20 values (SWAG's and
    iVON's over a whole DistilBERT) from a stream of its own; :meth:`crops`
    gives augmentation draws and :meth:`keep_mask` dropout masks, each from
    ``keys.bits`` on the key's stream of the draw's index (uniform bits, for
    any size). An attention
    with live dropout passes K3 the seed ``key + ((index + 1) << 20)``
    (a :class:`DeviceSeed`, which K3 reads from device memory): K3 keys its
    panel (b, h) by that seed plus ``b H + h``, so with the index in the high
    bits the panels of two draws, and the K1 seeds ``key + index``, never
    coincide (with ``key + index`` the next layer's panels would repeat this
    layer's, shifted by a few heads). On the CPU the mask is the top 24 of
    ``keys.bits`` on the key's stream of that seed's index.
    :meth:`member` gives an ensemble member its own source: in key mode one
    of the key ``fold_in(key, m)``, so no two members draw the same noise.

    At eval with ``freeze_on_eval`` one noise row is broadcast over the
    batch (reference bbb_layers.py:76-78), so one posterior sample behaves
    like one fixed network.
    """

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        given: Optional[Sequence[torch.Tensor]] = None,
        key: Optional[torch.Tensor] = None,
    ):
        if sum(x is not None for x in (generator, given, key)) != 1:
            raise ValueError("pass exactly one of generator=, given= and key=")
        if key is not None and (key.dtype != torch.int64 or key.numel() != 1):
            raise ValueError("a key is a one-element int64 tensor")
        self.generator = generator
        self._given = None if given is None else list(given)
        self.key = key
        self.draws = 0
        self._device_generators = {}
        self._pool, self._pool_used, self._chunks = None, 0, 0

    @classmethod
    def seeded(cls, seed: int) -> "NoiseSource":
        return cls(generator=torch.Generator().manual_seed(seed))

    def _take(self, shape) -> torch.Tensor:
        if self.draws >= len(self._given):
            raise IndexError(f"given noise exhausted after {self.draws} draws")
        eps = self._given[self.draws]
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(
                f"given noise draw {self.draws} has shape {tuple(eps.shape)}, "
                f"the layer asks for {tuple(shape)}"
            )
        self.draws += 1
        return eps

    def seed(self) -> int:
        """A fresh Philox seed for one kernel launch."""
        return int(torch.randint(0, 2**62, (1,), generator=self.generator))

    def member(self, index: int) -> "NoiseSource":
        """The source of ensemble member ``index``: in key mode a new source
        on the device key ``fold_in(key, index)`` (the JAX ensemble splits
        its step key per member); in generator and given mode this source,
        whose draws the members then take in turn."""
        if self.key is None:
            return self
        return NoiseSource(key=keys.fold_in(self.key.reshape(()), index))

    def _pooled(self, numel: int) -> torch.Tensor:
        """The next ``numel`` normals of the key's pool (key mode)."""
        if numel > _POOL:
            raise ValueError(f"a key-mode normal draw takes at most {_POOL} values, got {numel}")
        if self._pool is None or self._pool_used + numel > _POOL:
            self._pool = keys.normal(self.key.reshape(()), _POOL_STREAM + self._chunks, _POOL)
            self._pool_used, self._chunks = 0, self._chunks + 1
        out = self._pool[self._pool_used : self._pool_used + numel]
        self._pool_used += numel
        return out

    def mark(self) -> tuple:
        """Where the draws stand: the next draw's index, the key mode's pool,
        the generators' states. :meth:`replay` draws again from here."""
        gen_state = None if self.generator is None else self.generator.get_state()
        devices = {k: (g, g.get_state()) for k, g in self._device_generators.items()}
        return self.draws, self._pool, self._pool_used, self._chunks, gen_state, devices

    def _restore(self, mark: tuple) -> None:
        self.draws, self._pool, self._pool_used, self._chunks, gen_state, devices = mark
        if gen_state is not None:
            self.generator.set_state(gen_state)
        self._device_generators = {}
        for k, (g, state) in devices.items():
            g.set_state(state)
            self._device_generators[k] = g

    @contextlib.contextmanager
    def replay(self, mark: tuple):
        """Within the block the draws start again at ``mark`` and repeat what
        was drawn from there (a rematerialized forward recomputed in the
        backward draws the masks and noise of the forward it stands for);
        afterwards they stand where they stood before the block."""
        now = self.mark()
        self._restore(mark)
        try:
            yield self
        finally:
            self._restore(now)

    def crops(self, batch: int, device) -> tuple:
        """Random-crop offsets ``[batch, 2]`` in [0, 8] and flip bits
        ``[batch]`` for ``data/cifar.py::augment``: from the generator (on the
        CPU, as the generator mode always drew them), or, in key mode, from
        ``keys.bits`` on the key's stream of this draw's index."""
        if self.key is None:
            offsets = torch.randint(0, 9, (batch, 2), generator=self.generator)
            return offsets, torch.rand(batch, generator=self.generator) < 0.5
        h = keys.bits(self.key.reshape(()), self.draws, 3 * batch)
        self.draws += 1
        return (h[: 2 * batch] % 9).reshape(batch, 2), (h[2 * batch :] & 1) == 1

    def _device_generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        gen = self._device_generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.seed())
            self._device_generators[key] = gen
        return gen

    def normal(self, shape, device, train: bool, freeze_on_eval: bool) -> torch.Tensor:
        """N(0, 1) of ``shape`` (batch first), one row broadcast over the
        batch at frozen eval."""
        frozen = not train and freeze_on_eval
        draw_shape = tuple(shape[1:]) if frozen else tuple(shape)
        if self._given is not None:
            eps = self._take(draw_shape).to(device)
        elif self.key is not None:
            numel = math.prod(draw_shape)
            if numel > _POOL:  # one draw of its own stream (a SWAG or iVON draw over a whole model)
                eps = keys.normal(self.key.reshape(()), _BIG_STREAM + self.draws, numel).reshape(draw_shape)
            else:
                eps = self._pooled(numel).reshape(draw_shape)
            self.draws += 1
        else:
            eps = torch.randn(
                draw_shape, generator=self._device_generator(device), device=device
            )
            self.draws += 1
        return eps.expand(tuple(shape)) if frozen else eps

    def gaussian(self, act_mean, act_var, b_mean, b_var, train: bool, freeze_on_eval: bool):
        """The local-reparameterization epilogue of a BBB layer through K1:
        ``(act_mean + b_mean) + sqrt(act_var + b_var) * eps``."""
        frozen = not train and freeze_on_eval
        if self._given is not None:
            shape = act_mean.shape[1:] if frozen else act_mean.shape
            eps = self._take(shape).to(device=act_mean.device, dtype=act_mean.dtype)
            return gaussian_sample(act_mean, act_var, b_mean, b_var, eps=eps.contiguous())
        seed = DeviceSeed(self.key, self.draws) if self.key is not None else self.seed()
        self.draws += 1
        return gaussian_sample(act_mean, act_var, b_mean, b_var, seed=seed, frozen=frozen)

    def keep_mask(self, shape, device, rate: float) -> torch.Tensor:
        """A dropout layer's keep mask of ``shape``: bool, each element kept
        with probability 1 - ``rate`` (``u >= rate`` for u uniform: on the
        device's generator, or, in key mode, the top 24 of ``keys.bits``
        on the key's stream of this draw's index), or the next given mask."""
        if self._given is not None:
            return self._take(shape).to(device=device, dtype=torch.bool)
        if self.key is not None:
            mask = keys.keep_mask(self.key.reshape(()), self.draws, shape, rate)
            self.draws += 1
            return mask
        self.draws += 1
        return torch.rand(tuple(shape), generator=self._device_generator(device), device=device) >= rate

    def attention(self, q, k, v, key_mask, rate: float):
        """Self-attention with dropout ``rate`` on the probabilities through
        K3 (``ops/attention.py``): a fresh Philox seed, in key mode the device
        seed of this draw's index, or the next given keep mask ``[B, H, L,
        L]``."""
        b, l, h, _ = q.shape
        if self._given is not None:
            keep = self._take((b, h, l, l)).to(device=q.device, dtype=torch.bool)
            return fused_dropout_attention(q, k, v, key_mask, dropout_p=rate, keep=keep)
        if self.key is None:
            seed = self.seed()
        else:
            if b * h >= 1 << _PANEL_SHIFT or self.draws + 1 >= 1 << (31 - _PANEL_SHIFT):
                raise ValueError(f"a key-mode attention takes B H < 2^{_PANEL_SHIFT} panels and fewer than "
                                 f"{(1 << (31 - _PANEL_SHIFT)) - 1} draws of one source")
            seed = DeviceSeed(self.key.reshape(()), (self.draws + 1) << _PANEL_SHIFT)
        self.draws += 1
        return fused_dropout_attention(q, k, v, key_mask, dropout_p=rate, seed=seed)
