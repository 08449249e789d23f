"""K1: the local-reparameterization epilogue of every BBB layer, as a Triton
kernel for Hopper.

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

  * train: a fresh z per element, Philox at (seed, element index);
  * frozen eval: Philox at (seed, index mod C*H*W), so one noise row is
    shared by the whole batch (JAX ``nn/gaussian.py:74-76``);
  * given: z read from a tensor of the full shape or of one row.

Bound: device memory. Per element the kernel reads the two planes and
writes the sample, 12 bytes in fp32 (the bias vectors stay in cache). The
design is one pass: the bias adds, the sqrt, the multiply-add and the cast
ride on it, and z lives only in registers, never in device memory.
Philox-4x32-10 and Box-Muller add integer and transcendental work per
element on top of the memory traffic.

Backward (plain PyTorch, as the JAX kernel's ``_bwd`` is plain jnp):
d act_mean = g, d act_var = g*z/(2*std), and the bias gradients are those
summed over every dim but dim 1. z is the given tensor, or is recovered as
``(out - mean) / std`` like the JAX ``_bwd``; for that the forward keeps
``act_mean``, ``act_var`` and ``out`` alive, two fp32 planes (8 bytes per
element) beyond the output the next layer keeps anyway. A backward kernel
that regenerates z from (seed, offset) would drop both.

The random stream differs from ``jax.random``, as the TPU kernel's did;
both are iid N(0, 1), which is all the algorithms need.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

_BLOCK = 1024  # elements per program: 4 warps x 32 threads x 8 elements
_TRAIN, _FROZEN, _GIVEN = 0, 1, 2

# Bound to ``triton.language`` by ``_build`` before the kernel is compiled:
# Triton resolves the kernel's globals from this module, and importing
# triton here would break importing the module on a host without it.
tl = None


def _sample_kernel(
    mean_ptr, var_ptr, bmean_ptr, bvar_ptr, eps_ptr, out_ptr,
    n, row, hw, channels, eps_n, seed,
    HAS_BIAS: tl.constexpr, MODE: tl.constexpr, BLOCK: tl.constexpr,
):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    mean = tl.load(mean_ptr + offs, mask=mask, other=0.0)
    var = tl.load(var_ptr + offs, mask=mask, other=1.0)
    if HAS_BIAS:
        c = (offs // hw) % channels
        mean = mean + tl.load(bmean_ptr + c, mask=mask, other=0.0)
        var = var + tl.load(bvar_ptr + c, mask=mask, other=0.0)
    if MODE == 0:
        z = tl.randn(seed, offs)
    elif MODE == 1:
        z = tl.randn(seed, offs % row)
    else:
        z = tl.load(eps_ptr + offs % eps_n, mask=mask, other=0.0)
    out = mean + tl.sqrt_rn(var) * z
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _build():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(do_not_specialize=["seed"])(_sample_kernel)


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


def _launch(act_mean, act_var, b_mean, b_var, eps, seed, frozen):
    kernel = _build()
    out = torch.empty_like(act_mean)
    n = act_mean.numel()
    row = n // act_mean.shape[0]
    channels = act_mean.shape[1]
    has_bias = b_mean is not None
    mode = _GIVEN if eps is not None else (_FROZEN if frozen else _TRAIN)
    grid = ((n + _BLOCK - 1) // _BLOCK,)
    kernel[grid](
        act_mean, act_var,
        b_mean if has_bias else act_mean, b_var if has_bias else act_var,
        eps if eps is not None else act_mean, out,
        n, row, row // channels, channels,
        eps.numel() if eps is not None else 1, seed if seed is not None else 0,
        HAS_BIAS=has_bias, MODE=mode, BLOCK=_BLOCK, num_warps=4,
    )
    gaussian_sample.launches += 1
    return out


def _cpu_noise(act_mean, seed, frozen):
    shape = act_mean.shape[1:] if frozen else act_mean.shape
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=act_mean.dtype)


class _GaussianSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, act_mean, act_var, b_mean, b_var, eps, seed, frozen):
        if act_mean.is_cuda:
            out = _launch(act_mean, act_var, b_mean, b_var, eps, seed, frozen)
        else:
            z = eps if eps is not None else _cpu_noise(act_mean, seed, frozen)
            out = gaussian_sample_plain(act_mean, act_var, b_mean, b_var, z)
        ctx.given = eps is not None
        if ctx.given:
            ctx.save_for_backward(act_var, b_var, eps)
        else:
            ctx.save_for_backward(act_mean, act_var, b_mean, b_var, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.given:
            act_var, b_var, z = ctx.saved_tensors
            std = torch.sqrt(_add_bias(act_var, b_var))
        else:
            act_mean, act_var, b_mean, b_var, out = ctx.saved_tensors
            std = torch.sqrt(_add_bias(act_var, b_var))
            z = (out - _add_bias(act_mean, b_mean)) / std
        d_var = g * z * 0.5 / std
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
    if act_mean.numel() >= 2**31:
        raise ValueError("more than 2**31 elements")
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
    seed: Optional[int] = None,
    frozen: bool = False,
) -> torch.Tensor:
    """``(act_mean + b_mean[c]) + sqrt(act_var + b_var[c]) * z``,
    differentiable in all four tensors.

    z is ``eps`` when given (full shape, or one row broadcast over the
    batch), else drawn from the Philox stream ``seed``; ``frozen`` then
    draws one row for the whole batch. CUDA tensors go through the K1 kernel
    and count one launch in ``gaussian_sample.launches``; CPU tensors go
    through :func:`gaussian_sample_plain`.
    """
    _check(act_mean, act_var, b_mean, b_var, eps, seed)
    return _GaussianSample.apply(act_mean, act_var, b_mean, b_var, eps, seed, frozen)


gaussian_sample.launches = 0
