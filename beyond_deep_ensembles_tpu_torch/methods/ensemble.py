"""The posterior-predictive entry.

Counterpart of ``beyond_deep_ensembles_tpu/methods/ensemble.py::predict``
(reference DeepEnsemble.predict, ensemble.py:28-44), ``sample_is_identity``
branch only: the model samples in its forward, so S predictions are S
forwards of the live parameters, each drawing fresh noise. ``deep_ensemble``,
multisample methods and rank-1 components are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from .api import PosteriorMethod


def predict(
    method: PosteriorMethod,
    state,
    apply_fn: Callable,
    x: torch.Tensor,
    n_samples: int,
    noise,
    components: int = 1,
) -> torch.Tensor:
    """apply_fn(params, model_state, noise, x) -> output of one draw.
    Returns ``[n_samples, ...]`` stacked outputs."""
    if method.multisample or not method.sample_is_identity or components > 1:
        raise NotImplementedError("only sample_is_identity methods are ported yet")
    params, model_state = method.sample(state, noise, 0)
    return torch.stack([apply_fn(params, model_state, noise, x) for _ in range(n_samples)])
