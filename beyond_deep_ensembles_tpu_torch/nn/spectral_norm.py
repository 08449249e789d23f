"""Spectral normalization with a max-norm bound.

Counterpart of ``beyond_deep_ensembles_tpu/nn/spectral_norm.py`` (reference
src/algos/kernel/spectral_norm.py): power iteration estimates the top
singular value sigma of the kernel viewed as ``[out, fan_in]``, and the
kernel is scaled by ``1 / max(1, sigma / norm_bound)``: the spectral norm is
capped at ``norm_bound``, not normalized to 1.

The power-iteration vector ``u`` (``[out]``) is a buffer, ``kernel_u`` (the
JAX package keeps it in the ``spectral_norm`` collection under that name).
Every forward runs ``power_iterations`` iterations from it with ``u`` and
``v`` detached, so the gradient flows through the kernel only, in
``sigma = u^T W v``; a training forward writes the new ``u`` back in place,
an eval forward does not. At construction ``u`` warms up with 15 iterations
against the initial kernel, from a normal draw of the caller's generator
(the JAX package draws it from ``jax.random.key(17)``; parity tests load
JAX's ``u``).

The port's conv kernel is OIHW, so ``W`` is ``[out, in * kh * kw]``, where
the JAX package's HWIO kernel gives ``[out, kh * kw * in]``: the columns are
permuted, which changes neither sigma nor ``u`` (indexed by output channel).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from .convops import Padding, conv2d
from .plain import lecun_normal_

_WARMUP_ITERATIONS = 15


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class _SpectralNorm(nn.Module):
    def _init_u(self, generator: torch.Generator) -> None:
        w = self._w2d().detach()
        u = _l2_normalize(torch.randn(w.shape[0], generator=generator))
        for _ in range(_WARMUP_ITERATIONS):
            v = _l2_normalize(w.T @ u)
            u = _l2_normalize(w @ v)
        self.register_buffer("kernel_u", u)

    def _w2d(self) -> torch.Tensor:
        return self.kernel.reshape(self.kernel.shape[0], -1)

    def _scale(self, train: bool) -> torch.Tensor:
        """``1 / max(1, sigma / norm_bound)``, advancing ``u`` in training."""
        w = self._w2d()
        with torch.no_grad():
            u = self.kernel_u
            for _ in range(self.power_iterations):
                v = _l2_normalize(w.T @ u)
                u = _l2_normalize(w @ v)
            if train:
                self.kernel_u.copy_(u)
        sigma = u @ w @ v
        return 1.0 / torch.clamp(sigma / self.norm_bound, min=1.0)


class SpectralNormDense(_SpectralNorm):
    """Dense layer with capped spectral norm (reference
    spectrally_normalize_module on nn.Linear, kernel/base.py:6-17); kernel
    ``[features, in_features]`` (lecun-normal), bias zero."""

    def __init__(
        self,
        in_features: int,
        features: int,
        norm_bound: float = 6.0,
        power_iterations: int = 1,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.norm_bound, self.power_iterations = norm_bound, power_iterations
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        lecun_normal_(self.kernel, in_features, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_u(generator)

    def forward(self, x, noise=None, train: bool = True):
        del noise
        out = x @ (self.kernel * self._scale(train)).T
        return out if self.bias is None else out + self.bias


class SpectralNormConv(_SpectralNorm):
    """Conv layer with capped spectral norm of the ``[out, in * kh * kw]``
    unfolded kernel (the reference's torch weight viewed as
    ``(out_channels, -1)``); NCHW input, kernel OIHW, bias zero."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: Union[int, Sequence[int]] = 1,
        padding: Padding = 0,
        norm_bound: float = 6.0,
        power_iterations: int = 1,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self.norm_bound, self.power_iterations = norm_bound, power_iterations
        self.kernel = nn.Parameter(torch.empty(features, in_features, kh, kw))
        lecun_normal_(self.kernel, in_features * kh * kw, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._init_u(generator)

    def forward(self, x, noise=None, train: bool = True):
        del noise
        out = conv2d(x, self.kernel * self._scale(train), self.strides, self.padding)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out
