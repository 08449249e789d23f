"""SVGD's pairwise RBF kernel and Stein direction, with K2, the Gram matrix,
as a CUDA C++ kernel for Hopper.

Counterpart of ``beyond_deep_ensembles_tpu/ops/svgd_kernel.py``. The two
passes over the ``[n, P]`` particle matrix are the JAX package's:

  pass 1: the Gram matrix ``G = X X^T`` (:func:`gram`; on a card the K2
          kernel ``csrc/svgd_gram.cu``, the counterpart of the Pallas
          ``_gram_kernel``), then d^2 = diag_i + diag_j - 2 G, the exact
          median and the bandwidth h on the device, no host read;
  pass 2: phi = [-K | c (diag(Ksum) - K)] @ [grads; particles], one
          ``[n, 2n] @ [2n, P]`` product, left to ``torch.matmul`` as the JAX
          package leaves it to XLA.

K2 replaces the TPU kernel for every P on a card (the JAX package takes its
Pallas kernel from P >= 32,768 on a TPU and an XLA product below). The
wrapper launches it on a CUDA tensor and raises where it cannot; a CPU tensor
takes :func:`gram_plain`, which takes any n. K2 takes n <= 32 particles (a
CUDA tensor with more raises); the configurations use at most 20.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _cuda_build

MAX_N = 32
# K2's launch plan, which csrc/svgd_gram.cu takes as given: column tiles of a
# multiple of 128 columns, staged (every row, plus a zero row) in a ring of
# tiles in shared memory, one block per SM. n <= 8: 8 warps, a ring of 3 in
# 108 KB; n > 8: tile pairs of 8 rows x ceil(8 / pairs) slices (64 sums a
# thread), a ring of 2 in 200 KB, which makes the tiles wide (1152 columns
# at n = 20). The ring depths are the kernel's kSmallStages and kPairStages.
_TILE = 8
_QUANTUM = 128
_H100_SMS = 132
_SMALL_STAGES, _SMALL_SMEM_FLOATS = 3, 27_648
_PAIR_STAGES, _PAIR_SMEM_FLOATS = 2, 51_200


class LaunchPlan(NamedTuple):
    pairs: int  # row-tile pairs (1 for n <= 8)
    slices: int  # warps per pair, each every slices-th run of 32 columns
    cols: int  # columns of a tile
    tiles: int  # column tiles
    blocks: int  # block b takes tiles [tiles * b // blocks, tiles * (b + 1) // blocks)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(n: int, p: int, sms: int = _H100_SMS) -> LaunchPlan:
    """K2's launch for ``[n, p]`` on a card of ``sms`` SMs."""
    if n <= _TILE:
        pairs, slices = 1, 8
        stages, smem_floats = _SMALL_STAGES, _SMALL_SMEM_FLOATS
    else:
        row_tiles = _ceil_div(n, _TILE)
        pairs = row_tiles * (row_tiles + 1) // 2
        slices = _ceil_div(8, pairs)
        stages, smem_floats = _PAIR_STAGES, _PAIR_SMEM_FLOATS
    widest = (smem_floats // (stages * n + 1) - 4) // _QUANTUM * _QUANTUM
    cols = min(widest, _ceil_div(_ceil_div(p, sms), _QUANTUM) * _QUANTUM)
    tiles = _ceil_div(p, cols)
    return LaunchPlan(pairs, slices, cols, tiles, min(tiles, sms))


def _sm_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _H100_SMS


def summation_depth(n: int, p: int, sms: int = _H100_SMS) -> int:
    """The most roundings any element of K2's G passes through: one thread's
    FMAs over its columns of its block's tiles, the 5-level warp tree, the
    block's slices, then the last block's lane sum over the blocks and its
    warp tree."""
    plan = launch_plan(n, p, sms)
    per_thread = _ceil_div(plan.tiles, plan.blocks) * _ceil_div(plan.cols, 32 * plan.slices)
    return per_thread + 5 + plan.slices - 1 + _ceil_div(plan.blocks, 32) + 5


def gram_error_bound(x: torch.Tensor) -> torch.Tensor:
    """Per element, a bound on the distance of K2's G for ``x`` (on ``x``'s
    card; an H100's 132 SMs for a CPU tensor) from the exact X X^T:
    ``gamma_d * sum_p |x_ip| |x_jp|`` with d = :func:`summation_depth` and
    gamma_d = d u / (1 - d u), u = 2^-24 (fp32, round to nearest), in fp64."""
    n, p = x.shape
    d = summation_depth(n, p, _sm_count(x.device))
    u = 2.0**-24
    a = x.detach().abs().double()
    return (d * u / (1.0 - d * u)) * (a @ a.T)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("svgd_gram.cu")
    lib.svgd_gram.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.svgd_gram.restype = ctypes.c_int
    lib.svgd_gram_error_string.argtypes = [ctypes.c_int]
    lib.svgd_gram_error_string.restype = ctypes.c_char_p
    return lib


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K2: ``x @ x.T`` in fp32."""
    return x.float() @ x.float().T


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"gram takes float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"gram takes [n, P], got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gram runs on the CPU or a CUDA card, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("gram takes a contiguous [n, P] tensor")
    n, p = x.shape
    if n < 1 or p < 1:
        raise ValueError(f"gram takes at least one row and one column, got shape {tuple(x.shape)}")
    if x.is_cuda and n > MAX_N:
        raise ValueError(f"K2 takes 1 to {MAX_N} rows, got {n}; the CPU path takes any n")


# K2's ticket counter: one zeroed 32-bit word per device, which the kernel
# leaves at 0. Two K2 launches in flight at once would take each other's
# tickets, so K2 runs on one stream at a time: launches on two streams that
# may overlap, and concurrent replays of CUDA graphs that hold a K2 launch,
# are unsupported. Every path of the port launches K2 on one stream.
_counters: dict = {}


def _counter(device: torch.device) -> int:
    """The address of the ticket counter on ``device``. It is zeroed when
    the device's first K2 call allocates it, which therefore may not happen
    inside CUDA-graph capture (nothing would zero it before the graph's
    first replay)."""
    word = _counters.get(device.index)
    if word is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K2: call gram once outside CUDA-graph capture first, to zero its counter")
        word = torch.zeros(1, dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)
        _counters[device.index] = word
    return word.data_ptr()


def _launch(x: torch.Tensor) -> torch.Tensor:
    lib = _library()
    n, p = x.shape
    plan = launch_plan(n, p, _sm_count(x.device))
    counter = _counter(x.device)
    partial = torch.empty(plan.blocks * n * (n + 1) // 2, dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = lib.svgd_gram(
        x.data_ptr(), n, p, plan.pairs, plan.slices, plan.cols, plan.tiles, plan.blocks, partial.data_ptr(),
        partial.numel(), counter, out.data_ptr(), x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: {lib.svgd_gram_error_string(err).decode()} ({err})")
    gram.launches += 1
    return out


def gram(x: torch.Tensor) -> torch.Tensor:
    """``G = x @ x.T`` for fp32 ``x`` of shape ``[n, P]``. A CUDA tensor goes
    through K2, which takes n <= 32 and raises beyond, and counts one launch
    in ``gram.launches``; a CPU tensor, of any n, goes through
    :func:`gram_plain`. Not differentiable: SVGD takes
    the Stein direction on detached particles."""
    _check(x)
    x = x.detach()
    return _launch(x) if x.is_cuda else gram_plain(x)


gram.launches = 0


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between rows of ``x``: ``[n, n]``, as
    ``max(diag_i + diag_j - 2 G, 0)`` with the diagonal taken from the Gram
    (reference svgd.py:15 ``torch.cdist(...)**2``)."""
    g = gram(x.float().contiguous())
    sq = torch.diagonal(g)
    return torch.clamp(sq[:, None] + sq[None, :] - 2 * g, min=0.0)


def _median_linear(values: torch.Tensor) -> torch.Tensor:
    """Exact 0.5-quantile with linear interpolation over all entries
    (torch.quantile's default, reference svgd.py:18)."""
    flat = torch.sort(values.reshape(-1)).values
    m = flat.shape[0]
    pos = 0.5 * (m - 1)
    lo = int(pos)
    frac = pos - lo
    hi = min(lo + 1, m - 1)
    return flat[lo] * (1.0 - frac) + flat[hi] * frac


def rbf_phi(
    particles: torch.Tensor,
    grads: torch.Tensor,
    kernel_grad_scale: float,
    dataset_size: int,
    h_override: Optional[float] = None,
) -> torch.Tensor:
    """Full Stein direction phi for all particles.

    particles, grads: ``[n, P]`` (grads already include the L2 prior term).
    Returns phi ``[n, P] = K @ (-grads) + scale * grad_K / dataset_size``
    (reference svgd.py:86-89), as one ``[n, 2n] @ [2n, P]`` product.
    """
    particles = particles.float()
    grads = grads.float()
    n = particles.shape[0]

    d2 = pairwise_sq_dists(particles)
    if h_override is None:
        h = torch.sqrt(0.5 * _median_linear(d2) / math.log(n + 1.0)) + 1e-8
    else:
        h = torch.tensor(h_override, dtype=torch.float32, device=particles.device)

    kernel = torch.exp(-d2 / (2.0 * h**2))
    c = kernel_grad_scale / (h**2) / dataset_size
    ksum = torch.sum(kernel, dim=1)
    m1 = -kernel  # multiplies grads
    m2 = c * (torch.diag(ksum) - kernel)  # multiplies particles
    combined = torch.cat([m1, m2], dim=1)  # [n, 2n]
    stacked = torch.cat([grads, particles], dim=0)  # [2n, P]
    return combined @ stacked
