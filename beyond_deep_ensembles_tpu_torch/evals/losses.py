"""Loss / likelihood functions for Bayesian training.

Counterpart of ``beyond_deep_ensembles_tpu/evals/losses.py`` (reference
bnn_hmc/utils/losses.py): tempered softmax cross-entropy (:38-50), the
Gaussian log-prior and prior difference (:53-73), and the heteroscedastic
Gaussian likelihood with a softplus-parameterized std (:76-110). These are
the potentials of the HMC / SG-MCMC / MFVI methods; a params tree is a
module, a mapping of names to tensors or one flat tensor (``tree.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import tree


def tempered_softmax_xent(logits: torch.Tensor, labels: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Mean tempered cross-entropy: the log-likelihood scaled by 1/T
    (reference losses.py:38-50)."""
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, labels[:, None].long())[:, 0]
    return -torch.mean(ll) / temperature


def gaussian_log_prior(params, prior_std: float = 1.0) -> torch.Tensor:
    """Sum of iid Gaussian log-densities over every parameter (reference
    losses.py:53-63)."""
    n = tree.tree_size(params)
    sq = tree.tree_sq_norm(params)
    return -0.5 * sq / prior_std**2 - 0.5 * n * math.log(2 * math.pi * prior_std**2)


def gaussian_log_prior_diff(params1, params2, prior_std: float = 1.0) -> torch.Tensor:
    """log p(params1) - log p(params2), as a difference of squared norms
    (reference losses.py:66-73, the HMC accept-reject step's form)."""
    return (tree.tree_sq_norm(params2) - tree.tree_sq_norm(params1)) / (2 * prior_std**2)


def heteroscedastic_gaussian_ll(outputs: torch.Tensor, targets: torch.Tensor, min_std: float = 1e-3) -> torch.Tensor:
    """Per-point Gaussian log-likelihood of (mean, raw std) output pairs,
    std = softplus(raw) + ``min_std`` (reference losses.py:76-110)."""
    mean = outputs[..., 0]
    std = F.softplus(outputs[..., 1]) + min_std
    return -0.5 * ((targets - mean) / std) ** 2 - torch.log(std) - 0.5 * math.log(2 * math.pi)
