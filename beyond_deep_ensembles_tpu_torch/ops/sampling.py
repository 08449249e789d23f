"""K1: the local-reparameterization epilogue of every BBB layer, as Triton
kernels for Hopper, forward and backward.

Replaces the TPU kernel ``beyond_deep_ensembles_tpu/ops/sampling.py``
``_sample_kernel`` (launched by ``_sample_2d``, public entry
``fused_gaussian_sample``), which draws ``mean + sqrt(var) * z`` with
in-kernel random numbers. Here it sits where that kernel was written for,
the end of ``BBBConv``/``BBBDense`` (JAX: ``nn/bbb.py:89-95``, ``:163-170``).
One launch per layer per forward computes

    out = (act_mean + b_mean[c]) + sqrt(act_var + b_var[c]) * z

with ``act_mean``/``act_var`` the layer's mean and variance planes (conv or
matmul outputs without bias), ``b_mean``/``b_var`` the optional per-channel
bias mean and variance (the layer has applied its clamps), ``c`` the index
along dim 1, and z ~ N(0, 1) in one of three modes:

  * train: a fresh z per element i (the flat index);
  * frozen eval: z at i = the position in the row (C*H*W), one noise row
    shared by the whole batch (JAX ``nn/gaussian.py:74-76``);
  * given: z read from a tensor of the full shape or of one row.

The seed of a draw is a host int, or a :class:`DeviceSeed`: an int64 key in
device memory plus the draw's static index, which the kernel loads and adds
(the TPU kernel reads its seed from SMEM too). A CUDA graph that captures a
launch then draws afresh at every replay after the key has moved on, where
a host int would be frozen into the graph. Both forms give the same z for
the same value, key + index.

The draw. One Philox-4x32-10 call gives four normals (``tl.randn4x``: two
Box-Muller pairs, cos and sin). z_i is output ``lane`` of the call at
``counter``, by the map of :func:`philox_slot`: a function of (seed, i)
alone, so the forward and the backward draw the same z whatever their
grids. A program of the train mode covers 4 x ``_GROUP`` contiguous
elements as four coalesced sub-blocks, one per output. A frozen program
draws its ``4 x _GROUP`` row positions once and reuses them over its
examples (a 2-D grid of row chunks x batch chunks, :func:`frozen_plan`).

Backward, one launch per layer per forward as well:
``d act_var = g * z * 0.5 / sqrt(act_var + b_var[c])``, with z regenerated
from (seed, i) through the same map or read from the given ``eps``;
``d act_mean = g`` passes through and the bias gradients are channel sums
(``torch.sum``). The forward keeps ``act_var`` (and ``b_var``, ``eps``)
for it, never ``act_mean`` or the output. The JAX ``_bwd`` recovers z as
``(out - mean) / std``; regenerating it is the same function without that
rounding, and makes the Philox-mode gradients equal the given-mode
gradients at the same z bit for bit.

Bound: device memory. Per element the forward reads the two planes and
writes the sample, the backward reads g and ``act_var`` and writes
``d act_var``: 12 bytes each in fp32 (the bias vectors stay in cache). z
lives only in registers. A train program issues its loads before the draw,
so the memory traffic runs under Philox and Box-Muller; what is left above
the bound is each launch's fixed cost (about 2.5 us, the size of the
1,280-element head's whole launch) and, at frozen eval, a program's
examples taken one after the other.

The random stream differs from ``jax.random``, as the TPU kernel's did;
both are iid N(0, 1), which is all the algorithms need.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import torch
from torch.autograd.function import once_differentiable

# G of the Philox map: a program of the train mode spans 4G elements, four
# sub-blocks of G (8 warps: 2 contiguous fp32 a thread per sub-block). G
# fixes which normals are drawn; changing it changes the random stream.
_GROUP = 512
_FLAT_WARPS = 8
_FROZEN_WARPS = 8
# a frozen launch aims at about this many programs, each reusing its draw
# over batch * row chunks / this examples
_FROZEN_PROGRAMS = 1024
_MAX_GRID_Y = 65535
_MAX_ELEMENTS = 2**31 - 4 * _GROUP  # int32 offsets, ragged program included

# Bound to ``triton.language`` by ``_build`` before the kernels are
# compiled: Triton resolves the kernels' globals from this module, and
# importing triton here would break importing the module on a host without
# it. The helpers ``_bias``, ``_load`` and ``_store`` are rebound to their
# jitted versions there.
tl = None


class DeviceSeed(NamedTuple):
    """The seed ``key + index`` of one draw: ``key`` a 0-dim (or one-element)
    int64 tensor on the planes' device, read when the kernel runs; ``index``
    the draw's static index within a step (< 2^31). The key must not change
    between a forward and its backward (autograd saves it and raises if it
    was written in place)."""

    key: torch.Tensor
    index: int


Seed = Union[int, DeviceSeed]


def philox_slot(i):
    """(counter, lane) of element index ``i`` (an int, a numpy array or a
    tensor): z_i is output ``lane`` of ``randn4x(seed, counter)``. Contiguous
    runs of G indices share a lane, so a program over 4G elements loads four
    coalesced sub-blocks."""
    return (i // (4 * _GROUP)) * _GROUP + i % _GROUP, (i // _GROUP) % 4


def frozen_plan(batch: int, row: int):
    """The frozen mode's launch: ``(width, lanes, row_chunks, per_program,
    batch_chunks)``. Program (r, b) draws row positions ``r * 4G + lane * G
    + [0, width)`` for ``lane < lanes`` and applies them to examples
    ``[b * per_program, min((b + 1) * per_program, batch))``. A row of at
    most G positions (the dense head's 10) has them all in lane 0 of
    counters 0..row-1, so one lane of the next power of two covers it."""
    if row <= _GROUP:
        width, lanes, row_chunks = 1 << (row - 1).bit_length(), 1, 1
    else:
        width, lanes, row_chunks = _GROUP, 4, -(-row // (4 * _GROUP))
    per_program = max(1, batch * row_chunks // _FROZEN_PROGRAMS, -(-batch // _MAX_GRID_Y))
    return width, lanes, row_chunks, per_program, -(-batch // per_program)


def _bias(bmean_ptr, bvar_ptr, pos, mask, hw, channels, HAS_BIAS: tl.constexpr, BACKWARD: tl.constexpr):
    """The bias mean and variance of flat position ``pos`` (channel
    ``(pos // hw) % channels``); zeros without a bias."""
    if HAS_BIAS:
        c = (pos // hw) % channels
        bv = tl.load(bvar_ptr + c, mask=mask, other=0.0)
        if BACKWARD:
            bm = bv  # unused: the backward reads no bias mean
        else:
            bm = tl.load(bmean_ptr + c, mask=mask, other=0.0)
    else:
        bm = 0.0
        bv = 0.0
    return bm, bv


def _load(a_ptr, var_ptr, offs, mask, bm, bv, HAS_BIAS: tl.constexpr, BACKWARD: tl.constexpr):
    """(a, std): forward a = act_mean + bm, backward a = g; std = sqrt(var
    + bv), correctly rounded."""
    a = tl.load(a_ptr + offs, mask=mask, other=0.0)
    var = tl.load(var_ptr + offs, mask=mask, other=1.0)
    if HAS_BIAS:
        var = var + bv
        if not BACKWARD:
            a = a + bm
    return a, tl.sqrt_rn(var)


def _store(out_ptr, offs, mask, a, std, z, BACKWARD: tl.constexpr):
    """Forward ``a + std * z``; backward ``a * z * 0.5 / std``. Given and
    drawn z go through the same expression in the same order."""
    if BACKWARD:
        res = a * z * 0.5 / std
    else:
        res = a + std * z
    tl.store(out_ptr + offs, res, mask=mask)


def _seed(seed_ptr, seed, DEVICE_SEED: tl.constexpr):
    """The draw's seed: the key in device memory plus the index ``seed``, or
    the host int ``seed``."""
    if DEVICE_SEED:
        return tl.load(seed_ptr) + seed
    else:
        return seed


def _flat_kernel(
    a_ptr, var_ptr, bmean_ptr, bvar_ptr, eps_ptr, out_ptr, seed_ptr,
    n, hw, channels, eps_n, seed,
    HAS_BIAS: tl.constexpr, GIVEN: tl.constexpr, BACKWARD: tl.constexpr, GROUP: tl.constexpr,
    DEVICE_SEED: tl.constexpr,
):
    """Train and given modes: program p covers elements [4Gp, 4G(p+1)),
    lane l the sub-block 4Gp + lG + [0, G), drawn at counters Gp + [0, G).
    The loads are issued before the draw, so the memory traffic runs under
    the Philox and Box-Muller arithmetic."""
    pid = tl.program_id(0)
    cols = tl.arange(0, GROUP)
    o0 = pid * (4 * GROUP) + cols
    o1 = o0 + GROUP
    o2 = o0 + 2 * GROUP
    o3 = o0 + 3 * GROUP
    m0 = o0 < n
    m1 = o1 < n
    m2 = o2 < n
    m3 = o3 < n
    bm0, bv0 = _bias(bmean_ptr, bvar_ptr, o0, m0, hw, channels, HAS_BIAS, BACKWARD)
    bm1, bv1 = _bias(bmean_ptr, bvar_ptr, o1, m1, hw, channels, HAS_BIAS, BACKWARD)
    bm2, bv2 = _bias(bmean_ptr, bvar_ptr, o2, m2, hw, channels, HAS_BIAS, BACKWARD)
    bm3, bv3 = _bias(bmean_ptr, bvar_ptr, o3, m3, hw, channels, HAS_BIAS, BACKWARD)
    a0, s0 = _load(a_ptr, var_ptr, o0, m0, bm0, bv0, HAS_BIAS, BACKWARD)
    a1, s1 = _load(a_ptr, var_ptr, o1, m1, bm1, bv1, HAS_BIAS, BACKWARD)
    a2, s2 = _load(a_ptr, var_ptr, o2, m2, bm2, bv2, HAS_BIAS, BACKWARD)
    a3, s3 = _load(a_ptr, var_ptr, o3, m3, bm3, bv3, HAS_BIAS, BACKWARD)
    if GIVEN:
        z0 = tl.load(eps_ptr + o0 % eps_n, mask=m0, other=0.0)
        z1 = tl.load(eps_ptr + o1 % eps_n, mask=m1, other=0.0)
        z2 = tl.load(eps_ptr + o2 % eps_n, mask=m2, other=0.0)
        z3 = tl.load(eps_ptr + o3 % eps_n, mask=m3, other=0.0)
    else:
        z0, z1, z2, z3 = tl.randn4x(_seed(seed_ptr, seed, DEVICE_SEED), pid * GROUP + cols)
    _store(out_ptr, o0, m0, a0, s0, z0, BACKWARD)
    _store(out_ptr, o1, m1, a1, s1, z1, BACKWARD)
    _store(out_ptr, o2, m2, a2, s2, z2, BACKWARD)
    _store(out_ptr, o3, m3, a3, s3, z3, BACKWARD)


def _frozen_kernel(
    a_ptr, var_ptr, bmean_ptr, bvar_ptr, out_ptr, seed_ptr,
    row, hw, channels, batch, per_program, seed,
    HAS_BIAS: tl.constexpr, BACKWARD: tl.constexpr, WIDTH: tl.constexpr, LANES: tl.constexpr,
    GROUP: tl.constexpr, DEVICE_SEED: tl.constexpr,
):
    """Frozen eval: program (r, b) draws its row positions once (i = the
    position, the train mode's map) and loops over its examples with z, the
    bias and the masks in registers, one sub-block at a time."""
    pid_r = tl.program_id(0)
    cols = tl.arange(0, WIDTH)
    z0, z1, z2, z3 = tl.randn4x(_seed(seed_ptr, seed, DEVICE_SEED), pid_r * GROUP + cols)
    r0 = pid_r * (4 * GROUP) + cols
    m0 = r0 < row
    bm0, bv0 = _bias(bmean_ptr, bvar_ptr, r0, m0, hw, channels, HAS_BIAS, BACKWARD)
    if LANES == 4:
        r1 = r0 + GROUP
        r2 = r0 + 2 * GROUP
        r3 = r0 + 3 * GROUP
        m1 = r1 < row
        m2 = r2 < row
        m3 = r3 < row
        bm1, bv1 = _bias(bmean_ptr, bvar_ptr, r1, m1, hw, channels, HAS_BIAS, BACKWARD)
        bm2, bv2 = _bias(bmean_ptr, bvar_ptr, r2, m2, hw, channels, HAS_BIAS, BACKWARD)
        bm3, bv3 = _bias(bmean_ptr, bvar_ptr, r3, m3, hw, channels, HAS_BIAS, BACKWARD)
    first = tl.program_id(1) * per_program
    last = tl.minimum(first + per_program, batch)
    for b in range(first, last):
        base = b * row
        a0, s0 = _load(a_ptr, var_ptr, base + r0, m0, bm0, bv0, HAS_BIAS, BACKWARD)
        _store(out_ptr, base + r0, m0, a0, s0, z0, BACKWARD)
        if LANES == 4:
            a1, s1 = _load(a_ptr, var_ptr, base + r1, m1, bm1, bv1, HAS_BIAS, BACKWARD)
            _store(out_ptr, base + r1, m1, a1, s1, z1, BACKWARD)
            a2, s2 = _load(a_ptr, var_ptr, base + r2, m2, bm2, bv2, HAS_BIAS, BACKWARD)
            _store(out_ptr, base + r2, m2, a2, s2, z2, BACKWARD)
            a3, s3 = _load(a_ptr, var_ptr, base + r3, m3, bm3, bv3, HAS_BIAS, BACKWARD)
            _store(out_ptr, base + r3, m3, a3, s3, z3, BACKWARD)


@functools.cache
def _build():
    global tl, _bias, _load, _store, _seed
    import triton
    import triton.language

    tl = triton.language
    _bias, _load, _store, _seed = (triton.jit(f) for f in (_bias, _load, _store, _seed))
    flat = triton.jit(do_not_specialize=["seed"])(_flat_kernel)
    frozen = triton.jit(do_not_specialize=["seed", "batch", "per_program"])(_frozen_kernel)
    return flat, frozen


def _per_channel(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.reshape((-1,) + (1,) * (like.dim() - 2))


def _add_bias(x: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return x if b is None else x + _per_channel(b, x)


def _channel_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum(dim=[d for d in range(t.dim()) if d != 1])


def gaussian_sample_plain(act_mean, act_var, b_mean, b_var, z):
    """The plain PyTorch version of K1, in the JAX layers' order of
    operations. ``z`` has the full shape or one row (broadcast)."""
    mean = _add_bias(act_mean, b_mean)
    var = _add_bias(act_var, b_var)
    return (mean + torch.sqrt(var) * z).to(act_mean.dtype)


def _launch(a, act_var, b_mean, b_var, eps, seed, frozen, backward):
    """One launch of the forward (``a`` = act_mean) or the backward (``a`` =
    g, no bias mean) kernel; returns the output plane."""
    flat, frozen_kernel = _build()
    device_seed = isinstance(seed, DeviceSeed)
    seed_ptr, seed = (seed.key, seed.index) if device_seed else (a, seed)
    out = torch.empty_like(a)
    n = a.numel()
    batch, channels = a.shape[0], a.shape[1]
    row = n // batch
    has_bias = b_var is not None
    bm = b_mean if b_mean is not None else act_var
    bv = b_var if has_bias else act_var
    if eps is None and frozen:
        width, lanes, row_chunks, per_program, batch_chunks = frozen_plan(batch, row)
        frozen_kernel[(row_chunks, batch_chunks)](
            a, act_var, bm, bv, out, seed_ptr, row, row // channels, channels, batch, per_program, seed,
            HAS_BIAS=has_bias, BACKWARD=backward, WIDTH=width, LANES=lanes, GROUP=_GROUP,
            DEVICE_SEED=device_seed, num_warps=_FROZEN_WARPS,
        )
    else:
        flat[(-(-n // (4 * _GROUP)),)](
            a, act_var, bm, bv, eps if eps is not None else a, out, seed_ptr,
            n, row // channels, channels, eps.numel() if eps is not None else 1,
            seed if seed is not None else 0,
            HAS_BIAS=has_bias, GIVEN=eps is not None, BACKWARD=backward, GROUP=_GROUP,
            DEVICE_SEED=device_seed, num_warps=_FLAT_WARPS,
        )
    return out


def _cpu_noise(like, seed, frozen):
    """The CPU path's z: ``torch.randn`` from a generator seeded with the
    seed's value (a device seed's key is read: it lies on the CPU here)."""
    if isinstance(seed, DeviceSeed):
        seed = int(seed.key) + seed.index
    shape = like.shape[1:] if frozen else like.shape
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=like.dtype)


def gaussian_sample_backward(
    g: torch.Tensor,
    act_var: torch.Tensor,
    b_var: Optional[torch.Tensor] = None,
    *,
    eps: Optional[torch.Tensor] = None,
    seed: Optional[Seed] = None,
    frozen: bool = False,
) -> torch.Tensor:
    """``d act_var = g * z * 0.5 / sqrt(act_var + b_var[c])``, the gradient
    of :func:`gaussian_sample` with respect to its variance plane, for the
    same ``eps`` or ``seed`` and ``frozen``. CUDA tensors go through K1's
    backward kernel, which regenerates z, and count one launch in
    ``gaussian_sample_backward.launches``; CPU tensors take the plain
    expression with z drawn again from the CPU generator."""
    if g.shape != act_var.shape or g.dtype != act_var.dtype or g.device != act_var.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match act_var {tuple(act_var.shape)} {act_var.dtype}")
    g = g.contiguous()
    if g.is_cuda:
        out = _launch(g, act_var, None, b_var, eps, seed, frozen, backward=True)
        gaussian_sample_backward.launches += 1
        return out
    z = eps if eps is not None else _cpu_noise(g, seed, frozen)
    return g * z * 0.5 / torch.sqrt(_add_bias(act_var, b_var))


gaussian_sample_backward.launches = 0


class _GaussianSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act_mean, act_var, b_mean, b_var, eps, seed, frozen):
        if act_mean.is_cuda:
            out = _launch(act_mean, act_var, b_mean, b_var, eps, seed, frozen, backward=False)
            gaussian_sample.launches += 1
        else:
            z = eps if eps is not None else _cpu_noise(act_mean, seed, frozen)
            out = gaussian_sample_plain(act_mean, act_var, b_mean, b_var, z)
        # a device seed's key is saved as a tensor, so that the backward reads
        # the same key and autograd raises if it was written in between
        key = seed.key if isinstance(seed, DeviceSeed) else None
        ctx.seed = seed.index if key is not None else seed
        ctx.frozen = frozen
        ctx.save_for_backward(act_var, b_var, eps, key)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a kernel's gradient carries no graph: a second derivative raises
        act_var, b_var, eps, key = ctx.saved_tensors
        seed = DeviceSeed(key, ctx.seed) if key is not None else ctx.seed
        d_var = gaussian_sample_backward(g, act_var, b_var, eps=eps, seed=seed, frozen=ctx.frozen)
        d_bmean = _channel_sum(g) if ctx.needs_input_grad[2] else None
        d_bvar = _channel_sum(d_var) if ctx.needs_input_grad[3] else None
        return g, d_var, d_bmean, d_bvar, None, None, None


def _check(act_mean, act_var, b_mean, b_var, eps, seed):
    if (eps is None) == (seed is None):
        raise ValueError("pass exactly one of eps= and seed=")
    if act_mean.dtype != torch.float32 or act_var.dtype != torch.float32:
        raise TypeError("the planes must be float32")
    if act_mean.shape != act_var.shape or act_mean.dim() < 2:
        raise ValueError(f"plane shapes {act_mean.shape}, {act_var.shape}")
    if act_mean.device != act_var.device:
        raise ValueError("the planes lie on different devices")
    if not (act_mean.is_contiguous() and act_var.is_contiguous()):
        raise ValueError("the planes must be contiguous")
    if act_mean.numel() > _MAX_ELEMENTS:
        raise ValueError(f"more than {_MAX_ELEMENTS} elements")
    if (b_mean is None) != (b_var is None):
        raise ValueError("pass both bias vectors or neither")
    for b in (b_mean, b_var):
        if b is not None and (
            b.shape != (act_mean.shape[1],)
            or b.dtype != torch.float32
            or b.device != act_mean.device
            or not b.is_contiguous()
        ):
            raise ValueError(f"bias must be a contiguous float32 [{act_mean.shape[1]}] vector")
    if isinstance(seed, DeviceSeed) and (
        seed.key.dtype != torch.int64
        or seed.key.numel() != 1
        or seed.key.device != act_mean.device
        or not 0 <= seed.index < 2**31
    ):
        raise ValueError("a device seed is a one-element int64 key on the planes' device and an index below 2^31")
    if eps is not None and (
        eps.shape not in (act_mean.shape, act_mean.shape[1:])
        or eps.dtype != torch.float32
        or eps.device != act_mean.device
        or not eps.is_contiguous()
    ):
        raise ValueError("eps must be a contiguous float32 tensor of the full shape or one row")


def gaussian_sample(
    act_mean: torch.Tensor,
    act_var: torch.Tensor,
    b_mean: Optional[torch.Tensor] = None,
    b_var: Optional[torch.Tensor] = None,
    *,
    eps: Optional[torch.Tensor] = None,
    seed: Optional[Seed] = None,
    frozen: bool = False,
) -> torch.Tensor:
    """``(act_mean + b_mean[c]) + sqrt(act_var + b_var[c]) * z``,
    differentiable in all four tensors.

    z is ``eps`` when given (full shape, or one row broadcast over the
    batch), else drawn from the Philox stream ``seed`` (a host int or a
    :class:`DeviceSeed`); ``frozen`` then draws one row for the whole batch. CUDA tensors go through the K1 kernel
    and count one launch in ``gaussian_sample.launches`` (the backward
    counts in ``gaussian_sample_backward.launches``); CPU tensors go
    through :func:`gaussian_sample_plain`.
    """
    _check(act_mean, act_var, b_mean, b_var, eps, seed)
    return _GaussianSample.apply(act_mean, act_var, b_mean, b_var, eps, seed, frozen)


gaussian_sample.launches = 0
