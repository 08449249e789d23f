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
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

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


def blundell_mean_init(std: float = MEAN_STD_INIT) -> Callable:
    """``init(shape, generator)``: N(0, std^2), the variational means' init
    (JAX ``blundell_mean_init``)."""

    def init(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
        return std * torch.randn(tuple(shape), generator=generator)

    return init


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

    Data-parallel shards (``rows = (offset, total)``, set by
    ``parallel/pipelines.py::ParallelTrainer`` on a rank that holds rows
    ``[offset, offset + B)`` of a batch of ``total``): every draw made per
    example (K1's train-mode epilogue, K3's mask, the dropout layers' and
    FRN's train-mode draws, the crops, SNGP's sample noise) is those rows of
    the whole batch's draw, bit for bit, in every mode. K1, K3 and the key
    mode's keep masks take the offset; the other draws are made at the whole
    batch's shape and cut (a generator's stream, or the key mode's pooled
    normals, depends on the shape drawn); a given draw has the whole
    batch's shape and is cut. Draws of one row or of the parameters' shape
    are made whole on every rank, alike.

    Given mode with a mapping ``{member: draws}`` gives member ``m`` the
    draws ``given[m]`` (:meth:`member`), so that members split over ranks
    each take their own.
    """

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        given: Optional[Union[Sequence[torch.Tensor], Mapping[int, Sequence[torch.Tensor]]]] = None,
        key: Optional[torch.Tensor] = None,
        rows: Optional[Tuple[int, int]] = None,
    ):
        if sum(x is not None for x in (generator, given, key)) != 1:
            raise ValueError("pass exactly one of generator=, given= and key=")
        if key is not None and (key.dtype != torch.int64 or key.numel() != 1):
            raise ValueError("a key is a one-element int64 tensor")
        self.generator = generator
        self._members = dict(given) if isinstance(given, Mapping) else None
        self._given = None if given is None else ([] if self._members is not None else list(given))
        self.key = key
        self.rows = rows
        self.draws = 0
        self._device_generators = {}
        self._pool, self._pool_used, self._chunks = None, 0, 0

    @classmethod
    def seeded(cls, seed: int) -> "NoiseSource":
        return cls(generator=torch.Generator().manual_seed(seed))

    def _take(self, shape, batch_axis: Optional[int] = None) -> torch.Tensor:
        """The next given draw; per example (``batch_axis``) at ``rows`` a
        draw of the whole batch's shape, cut to the rows."""
        if self.draws >= len(self._given):
            raise IndexError(f"given noise exhausted after {self.draws} draws")
        eps = self._given[self.draws]
        want = self._whole(shape, batch_axis)
        if tuple(eps.shape) != want:
            raise ValueError(
                f"given noise draw {self.draws} has shape {tuple(eps.shape)}, "
                f"the layer asks for {want}"
            )
        self.draws += 1
        return self._cut(eps, shape, batch_axis)

    def _sharded(self, shape, batch_axis: Optional[int]) -> bool:
        return self.rows is not None and batch_axis is not None and self.rows[1] != shape[batch_axis]

    def _whole(self, shape, batch_axis: Optional[int]) -> tuple:
        """The whole batch's shape of a draw of ``shape``."""
        shape = tuple(shape)
        if not self._sharded(shape, batch_axis):
            return shape
        return shape[:batch_axis] + (self.rows[1],) + shape[batch_axis + 1:]

    def _cut(self, whole: torch.Tensor, shape, batch_axis: Optional[int]) -> torch.Tensor:
        """This shard's rows of a draw of the whole batch's shape."""
        if not self._sharded(shape, batch_axis):
            return whole
        return whole.narrow(batch_axis, self.rows[0], shape[batch_axis])

    def seed(self) -> int:
        """A fresh Philox seed for one kernel launch."""
        return int(torch.randint(0, 2**62, (1,), generator=self.generator))

    @property
    def per_member(self) -> bool:
        """Whether :meth:`member` gives each member draws of its own (key
        mode, or given draws per member) rather than this source's in turn."""
        return self.key is not None or self._members is not None

    def member(self, index: int) -> "NoiseSource":
        """The source of ensemble member ``index``: in key mode a new source
        on the device key ``fold_in(key, index)`` (the JAX ensemble splits
        its step key per member); in generator and given mode this source,
        whose draws the members then take in turn, or, given a mapping, a
        source of ``given[index]``. The rows carry over."""
        if self._members is not None:
            return NoiseSource(given=self._members[index], rows=self.rows)
        if self.key is None:
            return self
        return NoiseSource(key=keys.fold_in(self.key.reshape(()), index), rows=self.rows)

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
        ``keys.bits`` on the key's stream of this draw's index. At ``rows``
        the rows of the whole batch's draws."""
        whole = self._whole((batch,), 0)[0]
        if self.key is None:
            offsets = torch.randint(0, 9, (whole, 2), generator=self.generator)
            flips = torch.rand(whole, generator=self.generator) < 0.5
        else:
            h = keys.bits(self.key.reshape(()), self.draws, 3 * whole)
            self.draws += 1
            offsets, flips = (h[: 2 * whole] % 9).reshape(whole, 2), (h[2 * whole :] & 1) == 1
        return self._cut(offsets, (batch, 2), 0), self._cut(flips, (batch,), 0)

    def _device_generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        gen = self._device_generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.seed())
            self._device_generators[key] = gen
        return gen

    def normal(self, shape, device, train: bool, freeze_on_eval: bool, batch_axis: Optional[int] = None
               ) -> torch.Tensor:
        """N(0, 1) of ``shape``, one row broadcast over the batch (axis 0) at
        frozen eval; ``batch_axis``: the axis of a per-example draw's
        examples (cut to ``rows``), None for a draw of parameters."""
        frozen = not train and freeze_on_eval
        if frozen:
            draw_shape, batch_axis = tuple(shape[1:]), None
        else:
            draw_shape = tuple(shape)
        if self._given is not None:
            return self._expand(self._take(draw_shape, batch_axis).to(device), shape, frozen)
        local_shape, draw_shape = draw_shape, self._whole(draw_shape, batch_axis)
        if self.key is not None:
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
        return self._expand(self._cut(eps, local_shape, batch_axis), shape, frozen)

    @staticmethod
    def _expand(eps, shape, frozen: bool):
        return eps.expand(tuple(shape)) if frozen else eps

    def gaussian(self, act_mean, act_var, b_mean, b_var, train: bool, freeze_on_eval: bool):
        """The local-reparameterization epilogue of a BBB layer through K1:
        ``(act_mean + b_mean) + sqrt(act_var + b_var) * eps``."""
        frozen = not train and freeze_on_eval
        if self._given is not None:
            shape = act_mean.shape[1:] if frozen else act_mean.shape
            # z stays fp32 for bf16 planes: K1 draws and adds in fp32
            eps = self._take(shape, None if frozen else 0).to(
                device=act_mean.device, dtype=torch.promote_types(act_mean.dtype, torch.float32))
            return gaussian_sample(act_mean, act_var, b_mean, b_var, eps=eps.contiguous())
        seed = DeviceSeed(self.key, self.draws) if self.key is not None else self.seed()
        self.draws += 1
        return gaussian_sample(act_mean, act_var, b_mean, b_var, seed=seed, frozen=frozen,
                               rows=None if frozen else self.rows)

    def parameter(self, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        """One draw of a parameter, ``mean + sqrt(var) * z`` with a fresh z of
        ``mean``'s shape at train and eval alike (a BBB layer's
        ``sampling="parameters"``), through K1 (a 1-D parameter as one row):
        a draw of parameters, never cut to ``rows``."""
        flat = mean.reshape(1, -1) if mean.ndim == 1 else mean
        var = var.reshape(flat.shape)
        if self._given is not None:
            eps = self._take(tuple(mean.shape), None).to(device=mean.device, dtype=torch.float32)
            return gaussian_sample(flat, var, None, None, eps=eps.reshape(flat.shape).contiguous()).reshape(mean.shape)
        seed = DeviceSeed(self.key, self.draws) if self.key is not None else self.seed()
        self.draws += 1
        return gaussian_sample(flat, var, None, None, seed=seed).reshape(mean.shape)

    def keep_mask(self, shape, device, rate: float, batch_axis: Optional[int] = None) -> torch.Tensor:
        """A dropout layer's keep mask of ``shape``: bool, each element kept
        with probability 1 - ``rate`` (``u >= rate`` for u uniform: on the
        device's generator, or, in key mode, the top 24 of ``keys.bits``
        on the key's stream of this draw's index), or the next given mask;
        ``batch_axis`` (0 or None) as :meth:`normal`'s."""
        shape = tuple(shape)
        if self._given is not None:
            return self._take(shape, batch_axis).to(device=device, dtype=torch.bool)
        if self.key is not None:
            offset = self.rows[0] * math.prod(shape[1:]) if self._sharded(shape, batch_axis) else 0
            mask = keys.keep_mask(self.key.reshape(()), self.draws, shape, rate, offset=offset)
            self.draws += 1
            return mask
        self.draws += 1
        whole = torch.rand(self._whole(shape, batch_axis), generator=self._device_generator(device), device=device)
        return self._cut(whole, shape, batch_axis) >= rate

    def attention(self, q, k, v, key_mask, rate: float):
        """Self-attention with dropout ``rate`` on the probabilities through
        K3 (``ops/attention.py``): a fresh Philox seed, in key mode the device
        seed of this draw's index, or the next given keep mask ``[B, H, L,
        L]``."""
        b, l, h, _ = q.shape
        if self._given is not None:
            keep = self._take((b, h, l, l), 0).to(device=q.device, dtype=torch.bool)
            return fused_dropout_attention(q, k, v, key_mask, dropout_p=rate, keep=keep)
        rows = self.rows if self._sharded((b,), 0) else None
        if self.key is None:
            seed = self.seed()
        else:
            if self._whole((b,), 0)[0] * h >= 1 << _PANEL_SHIFT or self.draws + 1 >= 1 << (31 - _PANEL_SHIFT):
                raise ValueError(f"a key-mode attention takes B H < 2^{_PANEL_SHIFT} panels and fewer than "
                                 f"{(1 << (31 - _PANEL_SHIFT)) - 1} draws of one source")
            seed = DeviceSeed(self.key.reshape(()), (self.draws + 1) << _PANEL_SHIFT)
        self.draws += 1
        return fused_dropout_attention(q, k, v, key_mask, dropout_p=rate, seed=seed, rows=rows)
