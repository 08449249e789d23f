"""Shared multiclass-classification evaluation.

Counterpart of ``beyond_deep_ensembles_tpu/evals/classification.py``
(reference experiments/base/multiclass_classification.py): the Bayesian
model average in log space, per-point analysis and the aggregate
EvalResult.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .calibration import CalibrationResults


def bayesian_model_average(log_probs: torch.Tensor) -> torch.Tensor:
    """logsumexp over the sample axis minus log S (reference
    multiclass_classification.py:30-31); ``[samples, batch, classes]``."""
    return torch.logsumexp(log_probs, dim=0) - math.log(log_probs.shape[0])


def analyze_output(log_marginal: torch.Tensor, target: torch.Tensor, baseline_log_marginal=None):
    """Per-point correctness / confidence / log-likelihood, plus agreement
    and total variation against a baseline predictive when given (reference
    multiclass_classification.py:163-176)."""
    preds = torch.argmax(log_marginal, dim=1)
    correct = preds == target
    confidences = torch.clamp(torch.exp(torch.max(log_marginal, dim=1).values), 0.0, 1.0)
    ll = torch.gather(log_marginal, 1, target[:, None])[:, 0]
    agreement = total_variation = None
    if baseline_log_marginal is not None:
        agreement = (preds == torch.argmax(baseline_log_marginal, dim=1)).float()
        total_variation = (
            torch.sum(torch.abs(torch.exp(log_marginal) - torch.exp(baseline_log_marginal)), dim=1) / 2
        )
    return correct, confidences, ll, agreement, total_variation


@dataclasses.dataclass
class EvalResult:
    """Aggregate classification metrics (reference EvalResult,
    multiclass_classification.py:78-109)."""

    accuracy: torch.Tensor
    avg_log_likelihood: torch.Tensor
    avg_likelihood: torch.Tensor
    ece: torch.Tensor
    signed_ece: torch.Tensor
    hmc_agreement: Optional[torch.Tensor] = None
    hmc_total_variation: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls, correct, confidences, log_likelihoods, bin_count: int = 10,
        agreements=None, total_variations=None,
    ) -> "EvalResult":
        calibration = CalibrationResults.create(bin_count, correct, confidences)
        return cls(
            accuracy=torch.mean(correct.float()),
            avg_log_likelihood=torch.mean(log_likelihoods),
            avg_likelihood=torch.mean(torch.exp(log_likelihoods)),
            ece=calibration.ece,
            signed_ece=calibration.signed_ece,
            hmc_agreement=None if agreements is None else torch.mean(agreements),
            hmc_total_variation=None if total_variations is None else torch.mean(total_variations),
        )

    def as_dict(self) -> dict:
        out = {
            "accuracy": float(self.accuracy),
            "avg_log_likelihood": float(self.avg_log_likelihood),
            "avg_likelihood": float(self.avg_likelihood),
            "ece": float(self.ece),
            "signed_ece": float(self.signed_ece),
        }
        if self.hmc_agreement is not None:
            out["hmc_agreement"] = float(self.hmc_agreement)
        if self.hmc_total_variation is not None:
            out["hmc_total_variation"] = float(self.hmc_total_variation)
        return out
