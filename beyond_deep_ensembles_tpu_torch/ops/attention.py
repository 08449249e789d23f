"""Self-attention with dropout on the probabilities, with K3a (forward) and
K3b (backward) as CUDA C++ kernels for Hopper.

Counterpart of ``beyond_deep_ensembles_tpu/ops/attention.py``: the Pallas
``_fwd_kernel`` (K3a, ``:84``) and ``_bwd_kernel`` (K3b, ``:101``) become
``attn_forward`` and ``attn_backward_dq`` + ``attn_backward_dkdv`` in
``csrc/dropout_attention.cu`` (tiles of 64 query rows by 64 keys, an online
softmax, Philox dropout keyed by (seed, b, h, row, col), no ``[L, L]`` panel
in device memory).

Bound: operations, ``4 B H L^2 D`` forward and ``10 B H L^2 D`` backward,
far above the bytes (q, k, v, o once each). What the design does about it
(the source's header has the detail): every product runs on the tensor
cores as split TF32, three ``wgmma.mma_async`` TF32 products of the fp32
operands' high and low parts accumulated in fp32, so fp32 accuracy stays
while the products leave the CUDA cores; a block of two warpgroups takes 128
rows, keeps its own operand (Q, dO, or K and V) split in registers, and
splits each 64-wide tile that streams past once, into operand tiles in
shared memory laid out so that the probabilities stay in registers between
``Q K^T`` and ``P V``; the next raw tiles arrive by the copy engine (TMA,
an mbarrier counting the bytes) while the block computes; scores are kept in base 2. K3b stays two launches without
atomics, so repeat runs agree bit for bit.

Semantics, as the JAX package's: ``S = Q K^T / sqrt(D)`` plus a key-padding
bias of -1e30, an fp32 softmax, dropout on the normalized probabilities (a
probability is kept with probability 1 - p and then scaled by 1 / (1 - p)),
``O = P_drop V``. The public layout is the JAX one, q/k/v ``[B, L, H, D]``
and ``key_mask`` ``[B, L]`` (nonzero = attend); the kernels read that layout
directly.

The dropout mask comes from one of:

  * ``seed``: on a card, Philox in the kernels, the panel (b, h) keyed by
    ``seed + b H + h`` as the JAX kernel seeds its panels, a 16-bit uniform
    per element; the backward regenerates the mask (on bf16 operands in
    training it reads the bits K3a drew). The seed is a host int,
    or a :class:`~.sampling.DeviceSeed` (an int64 key in device memory plus
    a static index, the seed their sum): the kernels read the key when they
    run, as the JAX kernel reads its seed from SMEM, so a CUDA graph that
    captured the launch draws afresh at each replay once the key has moved
    on. Autograd saves the key for the backward, which raises if it was
    written in between. On the CPU, ``torch.rand`` from a generator seeded
    with a host ``seed`` (:func:`cpu_keep_mask`), or, for a device seed, the
    top 24 of ``keys.bits`` on the key's stream of the index
    (:func:`key_keep_mask`, as ``NoiseSource.keep_mask`` draws). The streams
    differ from the card's, as the TPU's hardware bits differ from
    ``jax.random``; all are iid.
  * ``keep``: a given keep mask ``[B, H, L, L]`` (bool or uint8), read by the
    kernels on a card, so that a card and the CPU can run one draw.

A data-parallel rank passes ``rows = (offset, total)``, its shard of a
batch of ``total``: its mask is those rows of the whole batch's mask, bit
for bit. On a card the panel seed ``seed + (offset + b) H + h`` is the
launch's seed moved by ``offset H`` (:func:`_shifted`), so the kernels take
the global b unchanged; on the CPU the host-seed mask is drawn at the global
shape and cut, the device-seed mask taken at the element offset of its rows
(``keys.keep_mask``).

q, k and v are fp32 or, in a bf16 encoder, bf16. bf16 operands go through
the kernels of ``csrc/dropout_attention_bf16.cu`` (``wgmma`` bf16 products
with fp32 accumulation on tiles streamed by TMA; K3b without atomics; the
same mask bit for bit, which in training K3a leaves for K3b to read, one bit
a score) with the TPU
kernels' bf16 rule: fp32 scores and softmax, P_drop rounded to bf16 before
``P_drop V``, dS rounded to bf16 before dQ and dK, outputs in bf16; the
plain version does the same (:class:`_PlainBf16`: each product of bf16
operands taken in fp32, which is exact per term, and rounded where the TPU
kernels round).

A CUDA tensor goes through the kernels (each launch of K3a counts one in
``attention_forward.launches``, each of K3b one in
``attention_backward.launches``, whichever the operands' type) and raises
where they cannot take it: a head dimension other than 64 or misaligned
data. Any L >= 1 runs (the last query and key tiles are ragged). A CPU
tensor goes through :func:`dropout_attention_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import keys
from . import _cuda_build
from .sampling import DeviceSeed, Seed

NEG = -1e30  # additive bias of a padded key; finite, so s - max is never NaN
HEAD_DIM = 64  # the kernels' head dimension (distilbert-base: 768 / 12)
_MODE_NONE, _MODE_PHILOX, _MODE_GIVEN = 0, 1, 2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("dropout_attention.cu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k3_forward.argtypes = [p, p, p, p, i, ctypes.c_ulonglong, p, p, f, f, p, p, p, i, i, i, i, p]
    lib.k3_forward.restype = i
    lib.k3_backward.argtypes = [p, p, p, p, i, ctypes.c_ulonglong, p, p, f, f, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.k3_backward.restype = i
    lib.k3_error_string.argtypes = [i]
    lib.k3_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_bf16() -> ctypes.CDLL:
    lib = _cuda_build.load("dropout_attention_bf16.cu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.k3_bf16_forward.argtypes = [p, p, p, p, i, ctypes.c_ulonglong, p, p, f, f, p, p, p, i, i, i, i, p]
    lib.k3_bf16_forward.restype = i
    lib.k3_bf16_backward.argtypes = [p, p, p, p, i, ctypes.c_ulonglong, p, p, f, f, p, p, p, p, p, i, p, p, p, i, i,
                                     i, i, p]
    lib.k3_bf16_backward.restype = i
    return lib


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` fp32: 0 where a key is attended, -1e30 where it is padded."""
    return torch.where(key_mask > 0, 0.0, NEG).to(torch.float32).contiguous()


def cpu_keep_mask(shape, seed: int, dropout_p: float, rows=None) -> torch.Tensor:
    """The CPU path's keep mask: ``u >= p`` for ``u = torch.rand`` from a
    generator seeded with ``seed``; at ``rows = (offset, total)`` the rows
    of the ``total``-row draw."""
    gen = torch.Generator().manual_seed(seed)
    if rows is None:
        return torch.rand(tuple(shape), generator=gen) >= dropout_p
    whole = torch.rand((rows[1],) + tuple(shape[1:]), generator=gen) >= dropout_p
    return whole[rows[0] : rows[0] + shape[0]]


def key_keep_mask(shape, seed: DeviceSeed, dropout_p: float, rows=None) -> torch.Tensor:
    """The plain version's mask for a device seed: ``u >= p`` for u the top
    24 of ``keys.bits`` on the key's stream ``index``, a function of (key,
    index) alone, on the key's device (``NoiseSource.keep_mask``'s draw); at
    ``rows = (offset, total)`` the elements from ``offset`` rows on."""
    offset = 0 if rows is None else rows[0] * math.prod(shape[1:])
    return keys.keep_mask(seed.key.reshape(()), seed.index, shape, dropout_p, offset=offset)


def _shifted(seed: Optional[Seed], by: int) -> Optional[Seed]:
    """``seed`` moved by ``by``: the panels ``seed + b H + h`` of a shard
    whose first batch row is ``offset`` are the whole launch's at ``by =
    offset H``."""
    if seed is None or by == 0:
        return seed
    if isinstance(seed, DeviceSeed):
        return DeviceSeed(seed.key, seed.index + by)
    return (seed + by) & 0xFFFFFFFFFFFFFFFF


def _plain_probs(q, k, key_mask, keep, dropout_p):
    # the bias is added, as the JAX kernel adds it: a batch row with every key
    # padded then scores -1e30 at every key, so its softmax is uniform and
    # its gradient reaches the scores
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(q.shape[-1])
    p = torch.softmax(s + key_bias(key_mask)[:, None, None, :], dim=-1)
    return p if keep is None else torch.where(keep.bool(), p / (1.0 - dropout_p), 0.0)


def _drop(x, keep, dropout_p):
    """The JAX kernels' ``_apply_drop``: kept values times 1 / (1 - p)."""
    return x if keep is None else torch.where(keep.bool(), x * (1.0 / (1.0 - dropout_p)), 0.0)


def _bf16_probs(q, k, key_mask, keep, dropout_p):
    """The bf16 rule's fp32 probabilities and P_drop, from q and k taken in
    fp32 (each product of two bf16 values is exact in fp32)."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / math.sqrt(q.shape[-1])
    p = torch.softmax(s + key_bias(key_mask)[:, None, None, :], dim=-1)
    return p, _drop(p, keep, dropout_p)


class _PlainBf16(torch.autograd.Function):
    """The plain version of K3a and K3b on bf16 operands, rounding where the
    TPU kernels round (JAX ``ops/attention.py:66-69``, ``:88-93``,
    ``:111-128``): ``O = bf16(bf16(P_drop) V)``; ``dV = bf16(bf16(P_drop)^T
    dO)``, ``dP = drop(dO V^T)``, ``dS = P (dP - rowsum(dP P))``, ``dQ =
    bf16(bf16(dS) K scale)``, ``dK = bf16(bf16(dS)^T Q scale)``; every product
    in fp32. The forward takes no ``ctx`` (``setup_context``), so that
    ``torch.func`` transforms can run a model through it."""

    @staticmethod
    def forward(q, k, v, key_mask, keep, dropout_p):
        _, pd = _bf16_probs(q, k, key_mask, keep, dropout_p)
        return torch.einsum("bhlm,bmhd->blhd", pd.bfloat16().float(), v.float()).bfloat16()

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, key_mask, keep, dropout_p = inputs
        ctx.save_for_backward(q, k, v, key_mask, keep)
        ctx.dropout_p = dropout_p

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, keep = ctx.saved_tensors
        p, pd = _bf16_probs(q, k, key_mask, keep, ctx.dropout_p)
        do = do.float()
        dv = torch.einsum("bhlm,blhd->bmhd", pd.bfloat16().float(), do).bfloat16()
        dp = _drop(torch.einsum("blhd,bmhd->bhlm", do, v.float()), keep, ctx.dropout_p)
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).bfloat16().float()
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq = (torch.einsum("bhlm,bmhd->blhd", ds, k.float()) * scale).bfloat16()
        dk = (torch.einsum("bhlm,blhd->bmhd", ds, q.float()) * scale).bfloat16()
        return dq, dk, dv, None, None, None


def dropout_attention_plain(q, k, v, key_mask, keep: Optional[torch.Tensor] = None, *, dropout_p: float = 0.0):
    """The plain PyTorch version of K3a (and, by autograd, of K3b): the JAX
    ``reference_dropout_attention`` with an explicit keep mask ``[B, H, L, L]``
    (None: nothing dropped); on bf16 operands :class:`_PlainBf16`."""
    if q.dtype == torch.bfloat16:
        return _PlainBf16.apply(q, k, v, key_mask, keep, dropout_p)
    return torch.einsum("bhlm,bmhd->blhd", _plain_probs(q, k, key_mask, keep, dropout_p), v)


def _mode(dropout_p, keep):
    if dropout_p == 0.0:
        return _MODE_NONE
    return _MODE_GIVEN if keep is not None else _MODE_PHILOX


def _check_kernel(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the kernels take beyond :func:`_check`: CUDA tensors, head
    dimension 64 and 16-byte aligned data (they read float4s); any L >= 1."""
    if not all(t is None or t.is_cuda for t in (q, *tensors)):
        raise ValueError("K3 runs on CUDA tensors; a CPU tensor takes dropout_attention_plain")
    b, l, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"K3 takes head dimension {HEAD_DIM}, got {d}")
    if l < 1:
        raise ValueError("K3 takes L >= 1")
    if any(t is not None and t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError("K3 takes 16-byte aligned tensors")


def _err(err: int, which: str) -> None:
    if err != 0:
        raise RuntimeError(f"{which} launch failed: {_library().k3_error_string(err).decode()} ({err})")


def _keep_ptr(keep):
    return keep.data_ptr() if keep is not None else None


def _seed_args(seed: Optional[Seed]):
    """(host value, key pointer or None) of a seed: a device seed passes its
    index and its key's address, which the kernels read and add."""
    if isinstance(seed, DeviceSeed):
        return seed.index, seed.key.data_ptr()
    return (seed or 0) & 0xFFFFFFFFFFFFFFFF, None


def attention_forward(q, k, v, bias, dropout_p: float, seed: Optional[Seed], keep: Optional[torch.Tensor],
                      with_probs: bool = False):
    """K3a on CUDA tensors: ``(o, lse, probs or None)``; ``lse`` ``[B, H, L]``
    is the row's log-sum-exp in base 2 of the scores times log2(e), which K3b
    reads. ``keep``: uint8 ``[B, H, L, L]``; ``seed``: a host int or a
    device seed. bf16 operands take the bf16 kernel, which writes no
    ``probs``."""
    return _forward(q, k, v, bias, dropout_p, seed, keep, with_probs, keep_draws=False)[:3]


def _draws_space(q, mode):
    """The int32 space of a bf16 Philox launch's keep bits (one bit a score,
    ``csrc/dropout_attention_bf16.cu``'s ``drawn_panel`` layout), or None."""
    if q.dtype != torch.bfloat16 or mode != _MODE_PHILOX:
        return None
    b, l, h, _ = q.shape
    tiles = -(-l // 64)
    return torch.empty(b * h * 128 * tiles * tiles, dtype=torch.int32, device=q.device)


def _forward(q, k, v, bias, dropout_p, seed, keep, with_probs, keep_draws):
    """K3a; with ``keep_draws`` (bf16, Philox) also the keep bits the kernel
    drew, for K3b (else None)."""
    _check_kernel(q, k, v, bias, keep)
    b, l, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    mode = _mode(dropout_p, keep)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mode, *_seed_args(seed),
            _keep_ptr(keep), dropout_p, 1.0 / math.sqrt(HEAD_DIM))
    drawn = None
    if q.dtype == torch.bfloat16:
        if with_probs:
            raise ValueError("K3a's debug probabilities take fp32 operands")
        probs = None
        drawn = _draws_space(q, mode) if keep_draws else None
        err = _library_bf16().k3_bf16_forward(*args, o.data_ptr(), lse.data_ptr(),
                                              drawn.data_ptr() if drawn is not None else None, b, l, h,
                                              q.device.index, stream)
    else:
        probs = torch.empty((b, h, l, l), dtype=torch.float32, device=q.device) if with_probs else None
        err = _library().k3_forward(*args, o.data_ptr(), lse.data_ptr(), probs.data_ptr() if with_probs else None,
                                    b, l, h, q.device.index, stream)
    _err(err, "K3a")
    attention_forward.launches += 1
    return o, lse, probs, drawn


attention_forward.launches = 0


def attention_backward(q, k, v, bias, dropout_p: float, seed: Optional[Seed], keep: Optional[torch.Tensor],
                       o, lse, do):
    """K3b on CUDA tensors: ``(dq, dk, dv)`` for the output gradient ``do``."""
    return _backward(q, k, v, bias, dropout_p, seed, keep, o, lse, do, drawn=None)


def _backward(q, k, v, bias, dropout_p, seed, keep, o, lse, do, drawn):
    """K3b; ``drawn``: K3a's keep bits (bf16, Philox), or None, when the
    bf16 kernel's first launch draws them."""
    _check_kernel(q, k, v, bias, keep, o, lse, do)
    b, l, h, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    mode = _mode(dropout_p, keep)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), mode, *_seed_args(seed), _keep_ptr(keep),
            dropout_p, 1.0 / math.sqrt(HEAD_DIM), o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l, h, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if q.dtype == torch.bfloat16:
        by_forward = drawn is not None
        if not by_forward:
            drawn = _draws_space(q, mode)
        err = _library_bf16().k3_bf16_backward(*args, drawn.data_ptr() if drawn is not None else None,
                                               int(by_forward), *outs)
    else:
        err = _library().k3_backward(*args, *outs)
    _err(err, "K3b")
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0


class _Attend(torch.autograd.Function):
    """K3a forward, K3b backward; the mask is held fixed between them (the
    seed, or the given mask, is kept, never the drawn mask: a device seed's
    key is saved as a tensor, so autograd raises if it was written before
    the backward). With ``keep_draws`` (a gradient wanted) the bf16 K3a also
    leaves its Philox keep bits (one bit a score), which K3b reads instead of
    drawing them again. The forward takes no ``ctx`` (``setup_context``), so
    that ``torch.func`` transforms (the Laplace fit's ``jacrev``) can run a
    model through it."""

    @staticmethod
    def forward(q, k, v, bias, keep, seed, dropout_p, keep_draws):
        o, lse, _, drawn = _forward(q, k, v, bias, dropout_p, seed, keep, False, keep_draws)
        return o, lse, drawn if drawn is not None else lse.new_empty(0, dtype=torch.int32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, keep, seed, dropout_p, _ = inputs
        o, lse, drawn = output
        key = seed.key if isinstance(seed, DeviceSeed) else None
        ctx.save_for_backward(q, k, v, bias, keep, o, lse, key, drawn)
        ctx.seed = seed.index if key is not None else seed
        ctx.dropout_p = dropout_p
        ctx.mark_non_differentiable(lse, drawn)

    @staticmethod
    def backward(ctx, do, _dlse, _ddrawn):
        q, k, v, bias, keep, o, lse, key, drawn = ctx.saved_tensors
        seed = DeviceSeed(key, ctx.seed) if key is not None else ctx.seed
        dq, dk, dv = _backward(q, k, v, bias, ctx.dropout_p, seed, keep, o, lse, do.contiguous(),
                               drawn if drawn.numel() else None)
        return dq, dk, dv, None, None, None, None, None


def _check(q, k, v, key_mask, dropout_p, seed, keep, rows=None) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, L, H, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must be all float32 or all bfloat16")
    if not all(t.device == q.device for t in (k, v, key_mask)) or q.device.type not in ("cpu", "cuda"):
        raise ValueError("q, k, v and key_mask must lie on one CPU or CUDA device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous")
    b, l, h, _ = q.shape
    if key_mask.shape != (b, l):
        raise ValueError(f"key_mask must be [B, L] = {(b, l)}, got {tuple(key_mask.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    if dropout_p == 0.0 and keep is not None:
        raise ValueError("a keep mask was given with dropout_p 0")
    if dropout_p > 0.0 and (seed is None) == (keep is None):
        raise ValueError("with dropout_p > 0 pass exactly one of seed= and keep=")
    if isinstance(seed, DeviceSeed) and (
        seed.key.dtype != torch.int64 or seed.key.numel() != 1 or seed.key.device != q.device
        or not 0 <= seed.index < 2**31
    ):
        raise ValueError("a device seed is a one-element int64 key on q's device and an index below 2^31")
    if keep is not None and (
        keep.shape != (b, h, l, l) or keep.dtype not in (torch.bool, torch.uint8) or keep.device != q.device
    ):
        raise ValueError(f"keep must be a bool or uint8 [B, H, L, L] = {(b, h, l, l)} mask on q's device")
    if rows is not None and not 0 <= rows[0] <= rows[1] - b:
        raise ValueError(f"rows {rows} do not hold a batch of {b}")


def _kernel_keep(keep):
    return None if keep is None else keep.contiguous().view(torch.uint8)


def _cpu_keep(q, dropout_p, seed, keep, rows=None):
    """The CPU path's mask: the given one, or one drawn from ``seed`` (at
    ``rows``)."""
    if dropout_p == 0.0 or keep is not None:
        return keep
    b, l, h, _ = q.shape
    if isinstance(seed, DeviceSeed):
        return key_keep_mask((b, h, l, l), seed, dropout_p, rows)
    return cpu_keep_mask((b, h, l, l), seed, dropout_p, rows)


def _kernel_seed(q, seed, rows):
    return seed if rows is None else _shifted(seed, rows[0] * q.shape[2])


def fused_dropout_attention(q, k, v, key_mask, *, dropout_p: float = 0.0, seed: Optional[Seed] = None,
                            keep: Optional[torch.Tensor] = None, rows=None) -> torch.Tensor:
    """Self-attention with dropout on the probabilities, differentiable in
    q, k and v with the mask held fixed. q/k/v ``[B, L, H, D]`` fp32 or bf16,
    ``key_mask`` ``[B, L]``; with ``dropout_p > 0`` exactly one of ``seed``
    (an int or a :class:`DeviceSeed`) and ``keep`` (a ``[B, H, L, L]``
    mask); ``rows = (offset, total)`` draws a seed's mask as those rows of a
    ``total``-row batch's. Returns ``[B, L, H, D]``."""
    _check(q, k, v, key_mask, dropout_p, seed, keep, rows)
    if q.is_cuda:
        keep_draws = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        return _Attend.apply(q, k, v, key_bias(key_mask), _kernel_keep(keep), _kernel_seed(q, seed, rows),
                             float(dropout_p), keep_draws)[0]
    return dropout_attention_plain(q, k, v, key_mask, _cpu_keep(q, dropout_p, seed, keep, rows),
                                   dropout_p=dropout_p)


def fused_attention_available(L: int, device=None) -> bool:
    """Whether the kernels take a sequence of ``L`` on ``device`` (default:
    the current card): a CUDA device with a card present and L >= 1 (the
    last tiles are ragged; the head dimension is fixed at
    :data:`HEAD_DIM`). The JAX package's TPU kernels asked L % 128 == 0 and
    L <= 1024. Where this is false a CUDA tensor raises in
    :func:`fused_dropout_attention` rather than taking the plain version; a
    CPU tensor takes the plain version by design."""
    device = torch.device("cuda") if device is None else torch.device(device)
    return L >= 1 and device.type == "cuda" and torch.cuda.is_available()


def fused_dropout_attention_debug(q, k, v, key_mask, *, dropout_p: float = 0.0, seed: Optional[Seed] = None,
                                  keep: Optional[torch.Tensor] = None, rows=None):
    """Forward only, also returning the realized (dropped, normalized)
    probabilities ``[B, H, L, L]``: test and debug use; the main path never
    materializes them. On a card K3a writes them."""
    _check(q, k, v, key_mask, dropout_p, seed, keep, rows)
    if q.is_cuda:
        o, _, probs = attention_forward(
            q, k, v, key_bias(key_mask), float(dropout_p), _kernel_seed(q, seed, rows), _kernel_keep(keep),
            with_probs=True
        )
        return o, probs
    probs = _plain_probs(q, k, key_mask, _cpu_keep(q, dropout_p, seed, keep, rows), dropout_p)
    return torch.einsum("bhlm,bmhd->blhd", probs, v), probs
