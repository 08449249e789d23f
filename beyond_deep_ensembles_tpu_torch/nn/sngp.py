"""SNGP: a Random-Fourier-Feature Gaussian-process output head.

Counterpart of ``beyond_deep_ensembles_tpu/nn/sngp.py`` (reference
src/algos/kernel/sngp.py, after arXiv:2006.10108 and edward2's random
feature layer):

  * :class:`RandomFourierFeatures`: ``scale * cos(x W + b)`` with fixed
    buffers ``W`` ``[in, R]`` (blockwise-orthogonal columns with chi-scaled
    norms, the JAX layout) and ``b`` ``[R]`` uniform in [0, 2 pi);
  * :class:`SNGPHead`: the optional JL projection (buffer
    ``random_matrix``) and layer norm, the RFF, the trained output layer
    ``beta``, and the buffers ``precision`` ``[R, R]``, ``covariance``
    ``[R, R]`` and ``seen_data``. A training forward adds ``k^T k`` of the
    detached features to ``precision`` and the batch size to
    ``seen_data``, in place; an eval forward applies the mean-field logit
    correction, or draws MC logits from the diagonal predictive Gaussian
    (with sqrt(var) as the std, as the JAX package fixes the reference).

The JAX package keeps ``W``/``b`` in its ``buffers`` collection and the
precision in ``sngp``; here all are module buffers, so a state's
``params.state_dict()`` carries them. :func:`recompute_covariance_and_reset`
(the method's epoch boundary) writes ``covariance`` and ``precision`` in
place, so a captured eval graph that holds them reads the new values.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .plain import Dense, LayerNorm


def _random_ortho(n: int, m: int, std: float, generator: torch.Generator) -> torch.Tensor:
    q, _ = torch.linalg.qr(std * torch.randn(n, m, generator=generator))
    return q


def rff_kernel_init(in_dim: int, num_features: int, std: float, generator: torch.Generator) -> torch.Tensor:
    """Blockwise-orthogonal ``[in_dim, num_features]`` with chi-scaled column
    norms (reference sngp.py:29-44)."""
    if num_features <= in_dim:
        w = _random_ortho(in_dim, num_features, std, generator)
    else:
        blocks, left = [], num_features
        while left > in_dim:
            blocks.append(_random_ortho(in_dim, in_dim, std, generator))
            left -= in_dim
        blocks.append(_random_ortho(in_dim, left, std, generator))
        w = torch.cat(blocks, dim=1)
    feature_norm = torch.randn(w.shape, generator=generator) ** 2
    return w * torch.sqrt(feature_norm.sum(0))


class RandomFourierFeatures(nn.Module):
    """``k(x) = feature_scale * cos(x W + b)``, ``W`` and ``b`` fixed buffers
    (reference sngp.py:17-52)."""

    def __init__(self, in_dim: int, num_random_features: int, feature_scale: Optional[float] = None,
                 std: float = 1.0, *, generator: torch.Generator):
        super().__init__()
        self.scale = math.sqrt(2.0 / num_random_features) if feature_scale is None else feature_scale
        self.register_buffer("W", rff_kernel_init(in_dim, num_random_features, std, generator))
        self.register_buffer("b", torch.rand(num_random_features, generator=generator) * (2 * math.pi))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * torch.cos(x @ self.W + self.b)


class SNGPHead(nn.Module):
    """Laplace-approximated GP output head (reference Laplace + SNGPWrapper,
    sngp.py:55-233). Input: features ``[B, D]``. Output: train -> logits
    ``[B, O]``; eval, mean field -> corrected logits, ``[n_samples, B, O]``
    broadcast when ``n_samples`` > 1; eval, ``"mc"`` -> ``[n_samples, B, O]``
    logit draws (``[B, O]`` at one sample). The JAX head's mean field without
    a factor (``mean_field_factor=None``: logits and the ``[B, B]``
    predictive covariance) has no caller and is not taken."""

    def __init__(
        self,
        in_features: int,
        outputs: int,
        num_random_features: int = 1024,
        num_gp_features: int = -1,
        normalize_gp_features: bool = True,
        ridge_penalty: float = 0.001,
        feature_scale: Optional[float] = 2.0,
        mean_field_factor: float = 0.25,
        rff_init_std: float = 1.0,
        sampling_mode: str = "mean field",
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        if sampling_mode not in ("mean field", "mc"):
            raise ValueError(f"unknown sampling_mode {sampling_mode!r}")
        self.ridge_penalty, self.mean_field_factor, self.sampling_mode = ridge_penalty, mean_field_factor, sampling_mode
        dim, matrix = in_features, None
        if num_gp_features > 0:
            dim, matrix = num_gp_features, 0.05 * torch.randn(in_features, num_gp_features, generator=generator)
        self.register_buffer("random_matrix", matrix)
        self.LayerNorm_0 = LayerNorm(dim) if normalize_gp_features else None
        self.RandomFourierFeatures_0 = RandomFourierFeatures(
            dim, num_random_features, feature_scale, rff_init_std, generator=generator)
        self.beta = Dense(num_random_features, outputs, generator=generator)
        r = num_random_features
        self.register_buffer("precision", ridge_penalty * torch.eye(r))
        self.register_buffer("covariance", torch.eye(r))
        self.register_buffer("seen_data", torch.zeros((), dtype=torch.int32))

    def forward(self, f: torch.Tensor, noise=None, train: bool = True, n_samples: int = 1):
        if self.random_matrix is not None:
            f = f @ self.random_matrix
        if self.LayerNorm_0 is not None:
            f = self.LayerNorm_0(f)
        k = self.RandomFourierFeatures_0(f)
        pred = self.beta(k)
        if train:
            with torch.no_grad():
                kf = k.detach().float()
                self.precision.add_(kf.T @ kf)
                self.seen_data.add_(f.shape[0])
            return pred
        # the diagonal of (k @ cov @ k^T) * ridge alone, [B]: the same values
        # as the JAX package's diagonal of the [B, B] product, without it
        var = ((k @ self.covariance) * k).sum(-1) * self.ridge_penalty
        if self.sampling_mode == "mean field":
            logits = pred
            if self.mean_field_factor > 0:
                logits = pred / torch.sqrt(1.0 + var * self.mean_field_factor)[:, None]
            return logits.expand((n_samples,) + tuple(logits.shape)) if n_samples > 1 else logits
        std = torch.sqrt(torch.clamp(var, min=1e-12))[:, None]
        eps = noise.normal((n_samples,) + tuple(pred.shape), pred.device, True, False)
        samples = pred[None] + std[None] * eps
        return samples if n_samples > 1 else samples[0]


@torch.no_grad()
def recompute_covariance_and_reset(module: nn.Module, ridge_penalty: float, eps: float = 1e-7) -> None:
    """Epoch boundary (reference sngp.py:106-110, 149-160, 243-246): in every
    :class:`SNGPHead` of ``module``, ``covariance <- inv(precision + eps I)``
    by Cholesky on the device, ``precision <- ridge * I`` and ``seen_data <-
    0``, each written in place."""
    for head in module.modules():
        if isinstance(head, SNGPHead):
            prec = head.precision
            eye = torch.eye(prec.shape[0], dtype=prec.dtype, device=prec.device)
            chol, _ = torch.linalg.cholesky_ex(prec + eps * eye)  # no host sync on the check
            head.covariance.copy_(torch.cholesky_solve(eye, chol))
            head.precision.copy_(ridge_penalty * eye)
            head.seen_data.zero_()
