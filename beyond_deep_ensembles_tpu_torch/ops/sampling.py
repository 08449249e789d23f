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

The planes and the bias vectors are fp32 or, in a bf16 layer, bf16 (the
JAX layers' ``acc_t``): the kernels read them in their type, do the
arithmetic in fp32 and round the sample once to the planes' type, the TPU
kernel's rule (JAX ``ops/sampling.py:58-59``); z is fp32 either way. The
backward reads g and ``act_var`` in their type and writes ``d act_var`` in
it. fp32 planes go through the Triton kernels below; bf16 planes through
the CUDA C++ kernels of ``csrc/gaussian_sample_bf16.cu`` (see "bf16
planes").

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
``d act_var``: 12 bytes each in fp32, 6 in bf16 (the bias vectors stay in
cache). z
lives only in registers. A train program issues its loads before the draw,
so the memory traffic runs under Philox and Box-Muller; what is left above
the bound is each launch's fixed cost (about 2.5 us, the size of the
1,280-element head's whole launch) and, at frozen eval, a program's
examples taken one after the other.

Rows at an offset (``rows=(offset, total)``, a data-parallel rank's
shard of a batch of ``total`` examples, ``parallel/mesh.py``): a
train-mode draw of rows ``[offset, offset + B)`` is those rows of the whole
batch's draw, bit for bit. The kernel takes the element offset ``offset *
row``: its programs stay aligned to the 4G blocks of the global index (the
first and last programs masked at the shard's ends), so counter and lane
come from the global index. The CPU path draws the global shape and takes
the rows. A frozen draw is one row for every example and needs no offset.

bf16 planes (``csrc/gaussian_sample_bf16.cu``, CUDA C++ for ``sm_90a``,
built by ``ops/_cuda_build.py``). At 6 bytes an element the Triton kernel's
issued instructions, not its bytes, set its time (four normals a Philox
call, libdevice's precise log, sin and cos, a division for the channel);
the bf16 kernels draw eight normals a call, at :func:`philox_slot_bf16`'s
map: z_i is normal ``i % 8`` of the Philox-4x32-10 call at counter ``i //
8`` (the seed's low and high 32 bits its key). Word ``w = i % 8 // 2`` is a
Box-Muller pair split 20 / 12: its top 20 bits the radial uniform ``u = (k +
1/2) 2^-20``, its low 12 the angle ``theta = 2 pi (j + 1/2) 2^-12 - pi``; z
= r cos(theta) at an even i and r sin(theta) at an odd one, r = sqrt(-2 ln
u). The smallest u, 2^-21, caps |z| at sqrt(42 ln 2) = 5.396 (the fp32
draw's cap is 5.68, Triton's u >= 1e-7); 4096 angles of a continuous-looking
radius match the Gaussian far below what a test of 10^7 draws sees. ln, the
radius's sqrt, sin and cos are the special-function unit's approximations,
within :func:`noise_bf16_tolerance` of the exact map, :func:`normals_bf16_plain`
(the twin: Philox in torch integer ops, Box-Muller in float64, used by the
tests and by ``chip_smoke.py``; never on the main path). A thread takes the
8 elements of one call with 16-byte loads and stores; the channel comes from
a host-made magic multiplier (:func:`_divider`). Frozen eval is a 2-D grid
(:func:`frozen_plan_bf16`); a shard at an offset keeps the global index's
groups of 8, the ragged ends element by element. :func:`noise_bf16` reads the
kernel's own z back (its ``noise`` mode; not counted). The sample's
arithmetic is the fp32 path's: the correctly rounded sqrt and one fused
multiply-add forward; the backward multiplies by an approximate reciprocal
square root, within one bf16 ulp of the plain division.

The random stream differs from ``jax.random``, as the TPU kernel's did;
both are iid N(0, 1), which is all the algorithms need.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from . import _cuda_build

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
PLANE_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 kernels (csrc/gaussian_sample_bf16.cu): a thread takes the 8
# normals of one Philox call, a block of 256 threads 2048 elements
_BF16_PER = 8
_BF16_BLOCK = 256 * _BF16_PER
_BF16_FORWARD, _BF16_BACKWARD, _BF16_NOISE, _BF16_WORDS = 0, 1, 2, 3
# Philox-4x32-10's multipliers and key increments (Salmon et al., SC 2011)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF

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
# (offset, total): a shard's first row and the whole batch's row count
Rows = Tuple[int, int]


def philox_slot(i):
    """(counter, lane) of element index ``i`` (an int, a numpy array or a
    tensor): z_i is output ``lane`` of ``randn4x(seed, counter)``. Contiguous
    runs of G indices share a lane, so a program over 4G elements loads four
    coalesced sub-blocks."""
    return (i // (4 * _GROUP)) * _GROUP + i % _GROUP, (i // _GROUP) % 4


def philox_slot_bf16(i):
    """(counter, lane) of element index ``i`` in the bf16 kernels' draw: z_i
    is normal ``lane`` of the Philox call at ``counter`` (word ``lane // 2``,
    its cos at an even lane, its sin at an odd one). A thread's 8 contiguous
    elements are one call."""
    return i // _BF16_PER, i % _BF16_PER


def frozen_plan_bf16(batch: int, row: int):
    """The bf16 frozen launch: ``(row_chunks, per_program, batch_chunks)``.
    Block (x, y) draws row positions ``[x 2048, (x + 1) 2048)`` (8 a thread,
    the train draw of example 0) and applies them to examples ``[y
    per_program, min((y + 1) per_program, batch))``."""
    row_chunks = -(-row // _BF16_BLOCK)
    per_program = max(1, batch * row_chunks // _FROZEN_PROGRAMS, -(-batch // _MAX_GRID_Y))
    return row_chunks, per_program, -(-batch // per_program)


def _divider(d: int):
    """``(magic, shift)`` with ``n // d == (n * magic) >> shift`` for every
    ``0 <= n < 2^31`` (Granlund and Montgomery: shift = 31 + ceil(log2 d),
    magic = floor(2^shift / d) + 1 < 2^32): the bf16 kernels' channel
    index, a multiply and a shift in place of a division."""
    if d < 1:
        raise ValueError(f"divisor {d} < 1")
    shift = 31 + (d - 1).bit_length()
    magic = (1 << shift) // d + 1
    if magic >= 2**32:
        raise ValueError(f"no 32-bit magic for {d}")
    return magic, shift


def _mulhilo(m: int, c: torch.Tensor):
    """(high, low) 32 bits of the product of the 32-bit constant ``m`` and
    ``c`` (an int64 tensor of 32-bit values), in 16-bit halves so that no
    int64 product overflows."""
    low_part = m * (c & 0xFFFF)
    high_part = m * (c >> 16)
    return (high_part + (low_part >> 16)) >> 16, (low_part + ((high_part & 0xFFFF) << 16)) & _U32


def philox4x32_plain(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 in plain PyTorch integer ops: the four 32-bit output
    words (int64 tensors) of counter (c0, c1, c2, c3) under key (k0, k1),
    each an int or an int64 tensor of 32-bit values. Random123's round: the
    products of c0 and c2 with the two multipliers, the high halves xored
    with c1, c3 and the key, the key bumped between rounds."""
    c0, c1, c2, c3, k0, k1 = (torch.as_tensor(v, dtype=torch.int64) for v in (c0, c1, c2, c3, k0, k1))
    for round_ in range(10):
        if round_:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_value(seed: "Seed") -> int:
    """The seed's value as the kernels read it: a host int, or a device
    seed's key + index (the key read back)."""
    return int(seed.key) + seed.index if isinstance(seed, DeviceSeed) else int(seed)


def normals_bf16_plain(seed: "Seed", n: int, start: int = 0, device=None, with_radius: bool = False):
    """The plain PyTorch twin of the bf16 kernels' draw: z at global element
    indices ``[start, start + n)`` under ``seed``, fp32 (the Philox words in
    torch integer ops, Box-Muller in float64 from the same bits); with
    ``with_radius`` also each element's radius r (float64), which
    :func:`noise_bf16_tolerance` takes. The kernels' z is within that
    tolerance of it; a frozen row is ``n = row``, ``start = 0``."""
    value = _seed_value(seed) & (2**64 - 1)
    first, last = start // _BF16_PER, (start + n + _BF16_PER - 1) // _BF16_PER
    counters = torch.arange(first, last, dtype=torch.int64, device=device)
    words = torch.stack(philox4x32_plain(counters, 0, 0, 0, value & _U32, value >> 32), dim=-1)
    u = ((words >> 12).double() + 0.5) * 2.0**-20
    theta = 2.0 * math.pi * (((words & 0xFFF).double() + 0.5) * 2.0**-12) - math.pi
    r = torch.sqrt(-2.0 * torch.log(u))
    z = torch.stack((r * torch.cos(theta), r * torch.sin(theta)), dim=-1).reshape(-1)
    cut = slice(start - first * _BF16_PER, start - first * _BF16_PER + n)
    z = z[cut].float()
    if not with_radius:
        return z
    return z, r.repeat_interleave(2, dim=-1).reshape(-1)[cut]


def noise_bf16_tolerance(radius: torch.Tensor) -> torch.Tensor:
    """The stated bound on |kernel z - :func:`normals_bf16_plain`'s z| for an
    element of radius r: ``2^-21 / r + 2^-18 r``, about twice the errors the
    PTX approximations are documented with (lg2: 2^-22 absolute near 1, which
    moves r by ln 2 2^-22 / r; sqrt and the multiply: 2^-22 of r; the angle's
    fp32 constants and sin / cos: 2^-20.9 absolute, times r)."""
    return 2.0**-21 / radius + 2.0**-18 * radius


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
        bv = tl.load(bvar_ptr + c, mask=mask, other=0.0).to(tl.float32)
        if BACKWARD:
            bm = bv  # unused: the backward reads no bias mean
        else:
            bm = tl.load(bmean_ptr + c, mask=mask, other=0.0).to(tl.float32)
    else:
        bm = 0.0
        bv = 0.0
    return bm, bv


def _load(a_ptr, var_ptr, offs, mask, bm, bv, HAS_BIAS: tl.constexpr, BACKWARD: tl.constexpr):
    """(a, std): forward a = act_mean + bm, backward a = g; std = sqrt(var
    + bv), correctly rounded; in fp32 whatever the planes' type."""
    a = tl.load(a_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.load(var_ptr + offs, mask=mask, other=1.0).to(tl.float32)
    if HAS_BIAS:
        var = var + bv
        if not BACKWARD:
            a = a + bm
    return a, tl.sqrt_rn(var)


def _store(out_ptr, offs, mask, a, std, z, BACKWARD: tl.constexpr):
    """Forward ``a + std * z``; backward ``a * z * 0.5 / std``, rounded once
    to the output's type. Given and drawn z go through the same expression
    in the same order."""
    if BACKWARD:
        res = a * z * 0.5 / std
    else:
        res = a + std * z
    tl.store(out_ptr + offs, res.to(out_ptr.dtype.element_ty), mask=mask)


def _seed(seed_ptr, seed, DEVICE_SEED: tl.constexpr):
    """The draw's seed: the key in device memory plus the index ``seed``, or
    the host int ``seed``."""
    if DEVICE_SEED:
        return tl.load(seed_ptr) + seed
    else:
        return seed


def _flat_kernel(
    a_ptr, var_ptr, bmean_ptr, bvar_ptr, eps_ptr, out_ptr, seed_ptr,
    n, hw, channels, eps_n, seed, blk0, shift,
    HAS_BIAS: tl.constexpr, GIVEN: tl.constexpr, BACKWARD: tl.constexpr, GROUP: tl.constexpr,
    DEVICE_SEED: tl.constexpr,
):
    """Train and given modes: program p covers the global elements
    [4G(blk0 + p), 4G(blk0 + p + 1)), lane l the sub-block 4G(blk0 + p) +
    lG + [0, G), drawn at counters G(blk0 + p) + [0, G); the local element
    is the global one less the offset 4G blk0 + ``shift`` (both 0 for a
    whole batch), masked outside [0, n). The loads are issued before the
    draw, so the memory traffic runs under the Philox and Box-Muller
    arithmetic."""
    pid = tl.program_id(0)
    cols = tl.arange(0, GROUP)
    o0 = pid * (4 * GROUP) + cols - shift
    o1 = o0 + GROUP
    o2 = o0 + 2 * GROUP
    o3 = o0 + 3 * GROUP
    m0 = (o0 >= 0) & (o0 < n)
    m1 = (o1 >= 0) & (o1 < n)
    m2 = (o2 >= 0) & (o2 < n)
    m3 = (o3 >= 0) & (o3 < n)
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
        z0, z1, z2, z3 = tl.randn4x(_seed(seed_ptr, seed, DEVICE_SEED), (blk0 + pid) * GROUP + cols)
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
    flat = triton.jit(do_not_specialize=["seed", "blk0", "shift"])(_flat_kernel)
    frozen = triton.jit(do_not_specialize=["seed", "batch", "per_program"])(_frozen_kernel)
    return flat, frozen


def _per_channel(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.reshape((-1,) + (1,) * (like.dim() - 2))


def _add_bias(x: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return x if b is None else x + _per_channel(b, x)


def _channel_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but 1, in fp32 for bf16 and rounded once."""
    return _wide(t).sum(dim=[d for d in range(t.dim()) if d != 1]).to(t.dtype)


def _wide(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` in the kernels' arithmetic type: fp32 for a bf16 tensor."""
    return None if t is None else t.to(torch.promote_types(t.dtype, torch.float32))


def gaussian_sample_plain(act_mean, act_var, b_mean, b_var, z):
    """The plain PyTorch version of K1, in the JAX layers' order of
    operations, in fp32 for bf16 planes and rounded once to their type.
    ``z`` has the full shape or one row (broadcast)."""
    mean = _add_bias(_wide(act_mean), _wide(b_mean))
    var = _add_bias(_wide(act_var), _wide(b_var))
    return (mean + torch.sqrt(var) * z).to(act_mean.dtype)


def _element_offset(rows, shape) -> int:
    """The global index of a shard's first element: ``offset * row`` for
    ``rows = (offset, total)`` and planes of ``shape``, 0 for a whole
    batch."""
    return 0 if rows is None else rows[0] * math.prod(shape[1:])


@functools.cache
def _library_bf16() -> ctypes.CDLL:
    lib = _cuda_build.load("gaussian_sample_bf16.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_bf16.argtypes = [
        i, i, i, i, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, i, i, i,
        ctypes.c_uint, i, ctypes.c_uint, i, ctypes.c_uint, i, i, i, p,
    ]
    lib.k1_bf16.restype = ctypes.c_int
    lib.k1_bf16_error_string.argtypes = [i]
    lib.k1_bf16_error_string.restype = ctypes.c_char_p
    return lib


def _channel_run(hw: int) -> int:
    """The bf16 kernels' bias run, the channels a vector group (8 elements
    from a multiple of 8) spans: 3 (one) where hw % 8 == 0, 2 (at most two)
    where hw >= 8, 1 (any) below; 0 is a plane without a bias."""
    return 3 if hw % _BF16_PER == 0 else 2 if hw >= _BF16_PER else 1


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _launch_bf16(mode, shape, a, act_var, b_mean, b_var, eps, seed, frozen, rows, out):
    """One launch of the bf16 kernels (``csrc/gaussian_sample_bf16.cu``) on
    planes of ``shape``: ``mode`` forward (``a`` = act_mean), backward (``a``
    = g), noise (z, fp32) or words (each group's Philox words, int32 [groups,
    4]), the last two reading no plane; writes ``out``."""
    lib = _library_bf16()
    if isinstance(seed, DeviceSeed):
        key, value = seed.key.data_ptr(), seed.index
    else:
        key, value = None, ((0 if seed is None else seed) + 2**63) % 2**64 - 2**63
    n = math.prod(shape)
    batch, channels = shape[0], shape[1]
    row = n // batch
    hw = row // channels
    has_bias = b_var is not None
    if eps is None and frozen:
        row_chunks, per_program, batch_chunks = frozen_plan_bf16(batch, row)
        span, shift, group0, grid = row, 0, 0, (row_chunks, batch_chunks)
        vec = row % _BF16_PER == 0
    else:
        group0, shift = divmod(_element_offset(rows, shape) if eps is None else 0, _BF16_PER)
        span, per_program, grid = n, 1, (-(-(shift + n) // _BF16_BLOCK), 1)
        vec = shift == 0
    vec = vec and _aligned(a, act_var, eps, out)
    eps_n = eps.numel() if eps is not None else n
    with torch.cuda.device(out.device):
        err = lib.k1_bf16(
            mode, int(eps is None and frozen), int(has_bias), int(eps is not None),
            None if a is None else a.data_ptr(), None if act_var is None else act_var.data_ptr(),
            b_mean.data_ptr() if b_mean is not None else None, b_var.data_ptr() if has_bias else None,
            None if eps is None else eps.data_ptr(), out.data_ptr(), key, value, span, shift, group0, eps_n,
            hw, channels, batch, per_program, int(vec), _channel_run(hw) if has_bias else 0,
            *_divider(hw), *_divider(channels), *_divider(eps_n), *grid,
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 bf16 launch failed: {lib.k1_bf16_error_string(err).decode()} ({err})")
    return out


def noise_bf16(like: torch.Tensor, seed: Seed, frozen: bool = False, rows: Optional[Rows] = None,
               words: bool = False) -> torch.Tensor:
    """The draw of the bf16 kernels for planes shaped as ``like`` (a CUDA
    tensor) under ``seed``: z, fp32, of the full shape (one row if
    ``frozen``; at ``rows = (offset, total)`` the rows of the whole batch's
    draw); with ``words``, the Philox words of the draw's groups of 8 instead
    (int64 [groups, 4] of 32-bit values, the groups holding the plane's
    elements, from counter ``start // 8``). One launch of the kernels' noise
    or words mode, which writes the draw where the sample would go; it
    counts in no launch counter (a check's read-back, not the main path).
    :func:`normals_bf16_plain` and :func:`philox4x32_plain` are its plain
    twins."""
    if not like.is_cuda:
        raise ValueError("noise_bf16 reads the kernel's draw back: it needs a CUDA tensor")
    shape = (1,) + tuple(like.shape[1:]) if frozen else tuple(like.shape)
    rows = None if frozen else rows
    if words:
        shift = _element_offset(rows, shape) % _BF16_PER
        out = torch.empty((-(-(shift + math.prod(shape)) // _BF16_PER), 4), dtype=torch.int32, device=like.device)
        return _launch_bf16(_BF16_WORDS, shape, None, None, None, None, None, seed, False, rows, out).long() & _U32
    out = torch.empty(shape, dtype=torch.float32, device=like.device)
    _launch_bf16(_BF16_NOISE, shape, None, None, None, None, None, seed, False, rows, out)
    return out[0] if frozen else out


def _launch(a, act_var, b_mean, b_var, eps, seed, frozen, backward, rows=None):
    """One launch of the forward (``a`` = act_mean) or the backward (``a`` =
    g, no bias mean) kernel, a train-mode draw at ``rows``' offset; returns
    the output plane. bf16 planes go through the CUDA kernels, fp32 ones
    through the Triton kernels."""
    if a.dtype == torch.bfloat16:
        mode = _BF16_BACKWARD if backward else _BF16_FORWARD
        return _launch_bf16(mode, a.shape, a, act_var, b_mean, b_var, eps, seed, frozen, rows, torch.empty_like(a))
    return _launch_triton(a, act_var, b_mean, b_var, eps, seed, frozen, backward, rows)


def _launch_triton(a, act_var, b_mean, b_var, eps, seed, frozen, backward, rows=None):
    """:func:`_launch` through the Triton kernels, for fp32 planes (they also
    take bf16 ones, as before the bf16 kernels: ``chip_smoke.py`` times them
    there beside the CUDA kernels)."""
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
        start = _element_offset(rows, a.shape) if eps is None else 0
        blk0, shift = divmod(start, 4 * _GROUP)
        flat[(-(-(shift + n) // (4 * _GROUP)),)](
            a, act_var, bm, bv, eps if eps is not None else a, out, seed_ptr,
            n, row // channels, channels, eps.numel() if eps is not None else 1,
            seed if seed is not None else 0, blk0, shift,
            HAS_BIAS=has_bias, GIVEN=eps is not None, BACKWARD=backward, GROUP=_GROUP,
            DEVICE_SEED=device_seed, num_warps=_FLAT_WARPS,
        )
    return out


def _cpu_noise(like, seed, frozen, rows=None):
    """The CPU path's z: ``torch.randn`` from a generator seeded with the
    seed's value (a device seed's key is read: it lies on the CPU here); at
    ``rows = (offset, total)`` the whole batch's draw, cut to the rows."""
    if isinstance(seed, DeviceSeed):
        seed = int(seed.key) + seed.index
    gen = torch.Generator().manual_seed(seed)
    dtype = torch.promote_types(like.dtype, torch.float32)
    if frozen:
        return torch.randn(like.shape[1:], generator=gen, dtype=dtype)
    if rows is None:
        return torch.randn(like.shape, generator=gen, dtype=dtype)
    whole = torch.randn((rows[1],) + tuple(like.shape[1:]), generator=gen, dtype=dtype)
    return whole[rows[0] : rows[0] + like.shape[0]]


def gaussian_sample_backward(
    g: torch.Tensor,
    act_var: torch.Tensor,
    b_var: Optional[torch.Tensor] = None,
    *,
    eps: Optional[torch.Tensor] = None,
    seed: Optional[Seed] = None,
    frozen: bool = False,
    rows: Optional[Rows] = None,
) -> torch.Tensor:
    """``d act_var = g * z * 0.5 / sqrt(act_var + b_var[c])``, the gradient
    of :func:`gaussian_sample` with respect to its variance plane, for the
    same ``eps`` or ``seed``, ``frozen`` and ``rows``. CUDA tensors go through K1's
    backward kernel, which regenerates z, and count one launch in
    ``gaussian_sample_backward.launches``; CPU tensors take the plain
    expression (in fp32 for bf16, rounded once) with z drawn again from the
    CPU generator."""
    if g.shape != act_var.shape or g.dtype != act_var.dtype or g.device != act_var.device:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} does not match act_var {tuple(act_var.shape)} {act_var.dtype}")
    g = g.contiguous()
    if g.is_cuda:
        out = _launch(g, act_var, None, b_var, eps, seed, frozen, backward=True, rows=rows)
        gaussian_sample_backward.launches += 1
        gaussian_sample_backward.bf16_launches += int(g.dtype == torch.bfloat16)
        return out
    z = eps if eps is not None else _cpu_noise(g, seed, frozen, rows)
    return (_wide(g) * z * 0.5 / torch.sqrt(_add_bias(_wide(act_var), _wide(b_var)))).to(g.dtype)


gaussian_sample_backward.launches = 0
# of them, launches on bf16 planes (csrc/gaussian_sample_bf16.cu)
gaussian_sample_backward.bf16_launches = 0


class _GaussianSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act_mean, act_var, b_mean, b_var, eps, seed, frozen, rows):
        if act_mean.is_cuda:
            out = _launch(act_mean, act_var, b_mean, b_var, eps, seed, frozen, backward=False, rows=rows)
            gaussian_sample.launches += 1
            gaussian_sample.bf16_launches += int(act_mean.dtype == torch.bfloat16)
        else:
            z = eps if eps is not None else _cpu_noise(act_mean, seed, frozen, rows)
            out = gaussian_sample_plain(act_mean, act_var, b_mean, b_var, z)
        # a device seed's key is saved as a tensor, so that the backward reads
        # the same key and autograd raises if it was written in between
        key = seed.key if isinstance(seed, DeviceSeed) else None
        ctx.seed = seed.index if key is not None else seed
        ctx.frozen, ctx.rows = frozen, rows
        ctx.save_for_backward(act_var, b_var, eps, key)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # a kernel's gradient carries no graph: a second derivative raises
        act_var, b_var, eps, key = ctx.saved_tensors
        seed = DeviceSeed(key, ctx.seed) if key is not None else ctx.seed
        d_var = gaussian_sample_backward(g, act_var, b_var, eps=eps, seed=seed, frozen=ctx.frozen, rows=ctx.rows)
        d_bmean = _channel_sum(g) if ctx.needs_input_grad[2] else None
        d_bvar = _channel_sum(d_var) if ctx.needs_input_grad[3] else None
        return g, d_var, d_bmean, d_bvar, None, None, None, None


def _check(act_mean, act_var, b_mean, b_var, eps, seed, rows=None):
    if (eps is None) == (seed is None):
        raise ValueError("pass exactly one of eps= and seed=")
    if act_mean.dtype not in PLANE_DTYPES or act_var.dtype != act_mean.dtype:
        raise TypeError("the planes must be both float32 or both bfloat16")
    if act_mean.shape != act_var.shape or act_mean.dim() < 2:
        raise ValueError(f"plane shapes {act_mean.shape}, {act_var.shape}")
    if act_mean.device != act_var.device:
        raise ValueError("the planes lie on different devices")
    if not (act_mean.is_contiguous() and act_var.is_contiguous()):
        raise ValueError("the planes must be contiguous")
    if act_mean.numel() > _MAX_ELEMENTS:
        raise ValueError(f"more than {_MAX_ELEMENTS} elements")
    if rows is not None:
        offset, total = rows
        if not 0 <= offset <= total - act_mean.shape[0]:
            raise ValueError(f"rows {rows} do not hold a batch of {act_mean.shape[0]}")
        if total * (act_mean.numel() // act_mean.shape[0]) > _MAX_ELEMENTS:
            raise ValueError(f"the whole batch has more than {_MAX_ELEMENTS} elements")
    if (b_mean is None) != (b_var is None):
        raise ValueError("pass both bias vectors or neither")
    for b in (b_mean, b_var):
        if b is not None and (
            b.shape != (act_mean.shape[1],)
            or b.dtype != act_mean.dtype
            or b.device != act_mean.device
            or not b.is_contiguous()
        ):
            raise ValueError(f"bias must be a contiguous [{act_mean.shape[1]}] vector of the planes' type")
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
    rows: Optional[Rows] = None,
) -> torch.Tensor:
    """``(act_mean + b_mean[c]) + sqrt(act_var + b_var[c]) * z``,
    differentiable in all four tensors.

    z is ``eps`` when given (full shape, or one row broadcast over the
    batch), else drawn from the Philox stream ``seed`` (a host int or a
    :class:`DeviceSeed`); ``frozen`` then draws one row for the whole batch,
    ``rows = (offset, total)`` (a data-parallel shard) draws those rows of
    the ``total``-example batch's draw. CUDA tensors go through the K1 kernel
    and count one launch in ``gaussian_sample.launches`` (the backward
    counts in ``gaussian_sample_backward.launches``); CPU tensors go
    through :func:`gaussian_sample_plain`.
    """
    _check(act_mean, act_var, b_mean, b_var, eps, seed, rows)
    if frozen or eps is not None:
        rows = None
    return _GaussianSample.apply(act_mean, act_var, b_mean, b_var, eps, seed, frozen,
                                 None if rows is None else tuple(rows))


gaussian_sample.launches = 0
# of them, launches on bf16 planes (csrc/gaussian_sample_bf16.cu)
gaussian_sample.bf16_launches = 0
