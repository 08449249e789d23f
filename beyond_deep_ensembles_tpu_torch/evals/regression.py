"""Regression evaluation: MSE, posterior log-likelihoods, log marginal
likelihood and quantile calibration (QCE, signed QCE).

Counterpart of ``beyond_deep_ensembles_tpu/evals/regression.py`` (reference
src/eval/regresssion.py). The quantile draw is one normal per (sample,
point): ``calc_quantile_frequencies`` and ``RegressionResults.create`` take
it as ``z``, or draw it from ``key`` by ``keys.normal`` on the outputs'
device (the same values on the CPU and on a card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from .. import keys

_QUANTILE_STREAM = 0


def gauss_logprob(mean, variance, x):
    """Gaussian log-density (reference src/algos/util.py:8-9)."""
    return -((x - mean) ** 2) / (2 * variance) - 0.5 * torch.log(variance) - 0.5 * math.log(2 * math.pi)


def nll_loss(output: torch.Tensor, target: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Heteroscedastic Gaussian NLL of GaussLayer outputs, the variance
    clamped at ``eps`` (reference src/algos/util.py:17-24)."""
    mean = output[..., 0]
    var = torch.clamp(output[..., 1] ** 2, min=eps)
    return torch.mean(0.5 * (torch.log(var) + (mean - target) ** 2 / var))


def quantile_draw(key: int, shape, device) -> torch.Tensor:
    """The quantile calibration's standard normals of ``shape`` from the host
    key ``key``."""
    return keys.normal(key, _QUANTILE_STREAM, math.prod(shape), device).reshape(tuple(shape))


def _linspace01(m: int, device) -> torch.Tensor:
    """``m`` points from 0 to 1 as ``jnp.linspace`` computes them in fp32
    (``i * (1 / (m - 1))``, the last set to 1), which ``torch.linspace``
    differs from in the last bit of some points: enough to move a nearest
    rank that falls on a half."""
    ps = torch.arange(m, dtype=torch.float32, device=device) * torch.tensor(1.0 / (m - 1), dtype=torch.float32)
    ps[-1] = 1.0
    return ps


def calc_quantile_frequencies(means, stds, targets, quantile_steps: int, key: Optional[int] = None,
                              z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Observed central-interval coverage at ``quantile_steps`` symmetric
    levels (reference regresssion.py:49-64). ``means``/``stds``: ``[S, ...]``.
    One realization ``means + stds * z`` per (sample, point); empirical
    quantiles over the samples, nearest rank ``rint(p (S - 1))`` (round half
    to even, as ``jnp.rint``); the share of targets at or below each."""
    if z is None:
        z = quantile_draw(key, means.shape, means.device)
    ps = _linspace01(2 * quantile_steps - 1, means.device)
    samples = means + stds * z.to(means.dtype)
    sorted_flat = torch.sort(samples.reshape(samples.shape[0], -1), dim=0).values
    n = sorted_flat.shape[0]
    idx = torch.round(ps * (n - 1)).to(torch.int64)
    quantiles = sorted_flat[idx]  # [2 steps - 1, points]
    t = targets.reshape(-1)
    qf = torch.mean((t[None, :] <= quantiles).to(torch.float32), dim=1)
    i = torch.arange(quantile_steps, device=means.device)
    return qf[quantile_steps + i - 1] - qf[quantile_steps - i - 1]


_FIELDS = ("mse_of_means", "mean_mse", "log_likelihood", "average_log_likelihood", "lml", "average_lml",
           "observed_cdf", "quantile_ps", "qce")


@dataclasses.dataclass
class RegressionResults:
    """Reference RegressionResults (regresssion.py:10-47), from outputs
    ``[samples, points, out_dim, 2]`` (mean, std)."""

    mse_of_means: torch.Tensor
    mean_mse: torch.Tensor
    log_likelihood: torch.Tensor
    average_log_likelihood: torch.Tensor
    lml: torch.Tensor
    average_lml: torch.Tensor
    observed_cdf: torch.Tensor
    quantile_ps: torch.Tensor
    qce: torch.Tensor

    @classmethod
    def create(cls, outputs, targets, key: Optional[int] = None, cal_steps: int = 10, target_mean=0.0,
               target_std=1.0, z: Optional[torch.Tensor] = None) -> "RegressionResults":
        """Denormalized by ``target_mean``/``target_std`` (reference
        regresssion.py:119-126); the quantile draw ``z`` ``[samples, points,
        out_dim]`` given, or drawn from ``key``."""
        outputs = outputs.to(torch.float32)
        targets = targets.to(device=outputs.device, dtype=torch.float32)
        samples, points = outputs.shape[0], outputs.shape[1]
        means = outputs[..., 0] * target_std + target_mean
        stds = outputs[..., 1] * target_std
        targets = targets * target_std + target_mean

        lls = gauss_logprob(means, stds**2, targets)
        mse_of_means = torch.mean((torch.mean(means, dim=0) - targets) ** 2)
        mean_mse = torch.mean((means - targets) ** 2)
        # per-point posterior-predictive LL: logsumexp over samples
        log_likelihood = -points * math.log(samples) + torch.sum(torch.logsumexp(lls, dim=0))
        # log marginal likelihood: the joint over the data set per sample
        lml = -math.log(samples) + torch.logsumexp(torch.sum(lls.reshape(samples, -1), dim=1), dim=0)

        observed_cdf = calc_quantile_frequencies(means, stds, targets, cal_steps, key=key, z=z)
        quantile_ps = _linspace01(cal_steps, outputs.device)
        qce = torch.mean(torch.abs(observed_cdf - quantile_ps))
        return cls(mse_of_means=mse_of_means, mean_mse=mean_mse, log_likelihood=log_likelihood,
                   average_log_likelihood=log_likelihood / points, lml=lml, average_lml=lml / points,
                   observed_cdf=observed_cdf, quantile_ps=quantile_ps, qce=qce)

    @property
    def sqce(self) -> torch.Tensor:
        """Signed QCE: negative = overconfident (reference
        regresssion.py:45-47)."""
        return torch.mean(self.observed_cdf - self.quantile_ps)

    @classmethod
    def average(cls, results: List["RegressionResults"]) -> "RegressionResults":
        """The fieldwise mean of ``results``."""
        return cls(**{f: torch.mean(torch.stack([getattr(r, f) for r in results]), dim=0) for f in _FIELDS})
