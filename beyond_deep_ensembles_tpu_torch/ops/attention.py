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
    per element; the backward regenerates the mask. The seed is a host int,
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

A CUDA tensor goes through the kernels (each launch of K3a counts one in
``attention_forward.launches``, each of K3b one in
``attention_backward.launches``) and raises where they cannot take it: a
head dimension other than 64 or misaligned data. Any L >= 1 runs (the last
query and key tiles are ragged). A CPU tensor goes through
:func:`dropout_attention_plain`.
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


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` fp32: 0 where a key is attended, -1e30 where it is padded."""
    return torch.where(key_mask > 0, 0.0, NEG).to(torch.float32).contiguous()


def cpu_keep_mask(shape, seed: int, dropout_p: float) -> torch.Tensor:
    """The CPU path's keep mask: ``u >= p`` for ``u = torch.rand`` from a
    generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(tuple(shape), generator=gen) >= dropout_p


def key_keep_mask(shape, seed: DeviceSeed, dropout_p: float) -> torch.Tensor:
    """The plain version's mask for a device seed: ``u >= p`` for u the top
    24 of ``keys.bits`` on the key's stream ``index``, a function of (key,
    index) alone, on the key's device (``NoiseSource.keep_mask``'s draw)."""
    h = keys.bits(seed.key.reshape(()), seed.index, math.prod(shape))
    return ((h >> 8).to(torch.float32) * 2.0**-24 >= dropout_p).reshape(tuple(shape))


def _plain_probs(q, k, key_mask, keep, dropout_p):
    # the bias is added, as the JAX kernel adds it: a batch row with every key
    # padded then scores -1e30 at every key, so its softmax is uniform and
    # its gradient reaches the scores
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(q.shape[-1])
    p = torch.softmax(s + key_bias(key_mask)[:, None, None, :], dim=-1)
    return p if keep is None else torch.where(keep.bool(), p / (1.0 - dropout_p), 0.0)


def dropout_attention_plain(q, k, v, key_mask, keep: Optional[torch.Tensor] = None, *, dropout_p: float = 0.0):
    """The plain PyTorch version of K3a (and, by autograd, of K3b): the JAX
    ``reference_dropout_attention`` with an explicit keep mask ``[B, H, L, L]``
    (None: nothing dropped)."""
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


def _err(lib, err: int, which: str) -> None:
    if err != 0:
        raise RuntimeError(f"{which} launch failed: {lib.k3_error_string(err).decode()} ({err})")


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
    device seed."""
    _check_kernel(q, k, v, bias, keep)
    lib = _library()
    b, l, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    probs = torch.empty((b, h, l, l), dtype=torch.float32, device=q.device) if with_probs else None
    err = lib.k3_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), _mode(dropout_p, keep), *_seed_args(seed),
        _keep_ptr(keep), dropout_p, 1.0 / math.sqrt(HEAD_DIM),
        o.data_ptr(), lse.data_ptr(), probs.data_ptr() if with_probs else None, b, l, h,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _err(lib, err, "K3a")
    attention_forward.launches += 1
    return o, lse, probs


attention_forward.launches = 0


def attention_backward(q, k, v, bias, dropout_p: float, seed: Optional[Seed], keep: Optional[torch.Tensor],
                       o, lse, do):
    """K3b on CUDA tensors: ``(dq, dk, dv)`` for the output gradient ``do``."""
    _check_kernel(q, k, v, bias, keep, o, lse, do)
    lib = _library()
    b, l, h, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    err = lib.k3_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), _mode(dropout_p, keep), *_seed_args(seed),
        _keep_ptr(keep), dropout_p, 1.0 / math.sqrt(HEAD_DIM),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, l, h, q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _err(lib, err, "K3b")
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0


class _Attend(torch.autograd.Function):
    """K3a forward, K3b backward; the mask is held fixed between them (the
    seed, or the given mask, is kept, never the drawn mask: a device seed's
    key is saved as a tensor, so autograd raises if it was written before
    the backward). The forward takes no ``ctx`` (``setup_context``), so that
    ``torch.func`` transforms (the Laplace fit's ``jacrev``) can run a model
    through it."""

    @staticmethod
    def forward(q, k, v, bias, keep, seed, dropout_p):
        o, lse, _ = attention_forward(q, k, v, bias, dropout_p, seed, keep)
        return o, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, keep, seed, dropout_p = inputs
        o, lse = output
        key = seed.key if isinstance(seed, DeviceSeed) else None
        ctx.save_for_backward(q, k, v, bias, keep, o, lse, key)
        ctx.seed = seed.index if key is not None else seed
        ctx.dropout_p = dropout_p
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, keep, o, lse, key = ctx.saved_tensors
        seed = DeviceSeed(key, ctx.seed) if key is not None else ctx.seed
        dq, dk, dv = attention_backward(q, k, v, bias, ctx.dropout_p, seed, keep, o, lse, do.contiguous())
        return dq, dk, dv, None, None, None, None


def _check(q, k, v, key_mask, dropout_p, seed, keep) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, L, H, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    if not all(t.dtype == torch.float32 for t in (q, k, v)):
        raise TypeError("q, k, v must be float32")
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


def _kernel_keep(keep):
    return None if keep is None else keep.contiguous().view(torch.uint8)


def _cpu_keep(q, dropout_p, seed, keep):
    """The CPU path's mask: the given one, or one drawn from ``seed``."""
    if dropout_p == 0.0 or keep is not None:
        return keep
    b, l, h, _ = q.shape
    if isinstance(seed, DeviceSeed):
        return key_keep_mask((b, h, l, l), seed, dropout_p)
    return cpu_keep_mask((b, h, l, l), seed, dropout_p)


def fused_dropout_attention(q, k, v, key_mask, *, dropout_p: float = 0.0, seed: Optional[Seed] = None,
                            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention with dropout on the probabilities, differentiable in
    q, k and v with the mask held fixed. q/k/v ``[B, L, H, D]`` fp32,
    ``key_mask`` ``[B, L]``; with ``dropout_p > 0`` exactly one of ``seed``
    (an int or a :class:`DeviceSeed`) and ``keep`` (a ``[B, H, L, L]``
    mask). Returns ``[B, L, H, D]``."""
    _check(q, k, v, key_mask, dropout_p, seed, keep)
    if q.is_cuda:
        return _Attend.apply(q, k, v, key_bias(key_mask), _kernel_keep(keep), seed, float(dropout_p))[0]
    return dropout_attention_plain(q, k, v, key_mask, _cpu_keep(q, dropout_p, seed, keep), dropout_p=dropout_p)


def fused_dropout_attention_debug(q, k, v, key_mask, *, dropout_p: float = 0.0, seed: Optional[Seed] = None,
                                  keep: Optional[torch.Tensor] = None):
    """Forward only, also returning the realized (dropped, normalized)
    probabilities ``[B, H, L, L]``: test and debug use; the main path never
    materializes them. On a card K3a writes them."""
    _check(q, k, v, key_mask, dropout_p, seed, keep)
    if q.is_cuda:
        o, _, probs = attention_forward(
            q, k, v, key_bias(key_mask), float(dropout_p), seed, _kernel_keep(keep), with_probs=True
        )
        return o, probs
    probs = _plain_probs(q, k, key_mask, _cpu_keep(q, dropout_p, seed, keep), dropout_p)
    return torch.einsum("bhlm,bmhd->blhd", probs, v), probs
