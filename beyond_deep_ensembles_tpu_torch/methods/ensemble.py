"""The posterior-predictive entry.

Counterpart of ``beyond_deep_ensembles_tpu/methods/ensemble.py::predict``
(reference DeepEnsemble.predict, ensemble.py:28-44). S predictions are S
forwards: of the live parameters, each drawing fresh noise, for methods
whose model samples in its forward (``sample_is_identity``, BBB); of the
parameters ``method.sample`` returns for index i otherwise (SVGD: particle
``i % n``). Nothing on these paths materializes sampled parameters, so the
JAX ``chunk_size`` has no counterpart. ``deep_ensemble``, multisample
methods and rank-1 components are not ported yet.
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
    if method.multisample or components > 1:
        raise NotImplementedError("multisample methods and rank-1 components: not ported yet")
    if method.sample_is_identity:
        params, model_state = method.sample(state, noise, 0)
        return torch.stack([apply_fn(params, model_state, noise, x) for _ in range(n_samples)])
    outs = []
    for i in range(n_samples):
        params, model_state = method.sample(state, noise, i)
        outs.append(apply_fn(params, model_state, noise, x))
    return torch.stack(outs)
