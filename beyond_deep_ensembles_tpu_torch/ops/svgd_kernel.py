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
takes :func:`gram_plain`. K2 takes n <= 32 particles; the configurations use
at most 20.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _cuda_build

MAX_N = 32
# K2's launch shape, as csrc/svgd_gram.cu has it: pass 1 blocks of 256
# threads over chunks of about 512 columns (two per thread), at most 2048
# chunks; pass 2 blocks of 128 threads
_THREADS = 256
_COLUMNS_PER_CHUNK = 512
_MAX_CHUNKS = 2048
_FINISH_THREADS = 128


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _cuda_build.load("svgd_gram.cu")
    lib.svgd_gram.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.svgd_gram.restype = ctypes.c_int
    lib.svgd_gram_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.svgd_gram_scratch_floats.restype = ctypes.c_longlong
    lib.svgd_gram_error_string.argtypes = [ctypes.c_int]
    lib.svgd_gram_error_string.restype = ctypes.c_char_p
    return lib


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _chunks(p: int) -> int:
    return min(_ceil_div(p, _COLUMNS_PER_CHUNK), _MAX_CHUNKS)


def summation_depth(p: int) -> int:
    """The most roundings any element of K2's G passes through: the FMAs of
    one thread's columns, the 5-level warp tree and the 8 warps of pass 1;
    one thread's share of the chunks, the warp tree and the 4 warps of
    pass 2."""
    chunks = _chunks(p)
    pass1 = _ceil_div(_ceil_div(p, chunks), _THREADS) + 5 + _THREADS // 32 - 1
    pass2 = _ceil_div(chunks, _FINISH_THREADS) + 5 + _FINISH_THREADS // 32 - 1
    return pass1 + pass2


def gram_error_bound(x: torch.Tensor) -> torch.Tensor:
    """Per element of K2's G, a bound on its distance from the exact X X^T:
    ``gamma_d * sum_p |x_ip| |x_jp|`` with d = :func:`summation_depth` and
    gamma_d = d u / (1 - d u), u = 2^-24 (fp32, round to nearest), in fp64."""
    d = summation_depth(x.shape[1])
    u = 2.0**-24
    a = x.detach().abs().double()
    return (d * u / (1.0 - d * u)) * (a @ a.T)


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
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K2 takes 1 to {MAX_N} rows, got {n}")
    if p < 1:
        raise ValueError("gram takes at least one column")


def _launch(x: torch.Tensor) -> torch.Tensor:
    lib = _library()
    n, p = x.shape
    chunks = _chunks(p)
    scratch_floats = lib.svgd_gram_scratch_floats(n, chunks)
    partial = torch.empty(scratch_floats, dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = lib.svgd_gram(
        x.data_ptr(), n, p, chunks, partial.data_ptr(), scratch_floats, out.data_ptr(),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: {lib.svgd_gram_error_string(err).decode()} ({err})")
    gram.launches += 1
    return out


def gram(x: torch.Tensor) -> torch.Tensor:
    """``G = x @ x.T`` for fp32 ``x`` of shape ``[n, P]``, n <= 32. A CUDA
    tensor goes through K2 and counts one launch in ``gram.launches``; a CPU
    tensor goes through :func:`gram_plain`. Not differentiable: SVGD takes
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
