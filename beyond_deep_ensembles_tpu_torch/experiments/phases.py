"""Checkpoint-driven downstream phases: Multi-X ensembling and post-hoc
Laplace fitting.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/phases.py``
(reference per-task ``eval_ensembles.py``: a DeepEnsemble of 4 of 5 saved
single-model checkpoints, civilcomments/eval_ensembles.py:34-48; and
``fit_laplace.py``, laplace-torch on saved MAP checkpoints), on the port's
``torch.save`` checkpoints (``utils/checkpoint.py``). A restore fills a
state in place, so each member is restored into a state of its own.
The WILDS ``drop_rates`` and ``eval`` phases live in
``experiments/wilds_task.py`` (``sweep_drop_rates_phase``,
``eval_only_phase``), as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..methods.api import PosteriorMethod
from ..methods.ensemble import EnsembleState, deep_ensemble
from ..methods.laplace import laplace_method
from ..utils import checkpoint as ckpt


def load_members(run_dirs: Sequence[str], name: str, new_state: Callable[[], object]) -> List:
    """The ``{name}_final`` state of each run directory, each restored into
    a fresh ``new_state()`` (reference results/<Run>/log/rep_0i{model}_final
    layout)."""
    return [ckpt.restore_final(d, name, new_state()) for d in run_dirs]


def multix_from_checkpoints(inner_method: PosteriorMethod, states: Sequence, leave_out: Optional[int] = None):
    """Independently trained single-model states as one Multi-X ensemble
    (reference eval_ensembles' leave-one-out: 4 of 5 members). Returns
    ``(deep_ensemble method, its state)``; the states are the members, not
    copies (JAX stacks them on a leading axis)."""
    states = [s for i, s in enumerate(states) if i != leave_out]
    return deep_ensemble(inner_method, n_members=len(states)), EnsembleState(states)


def fit_laplace_from_checkpoint(model, map_state, train_data, hessian: str = "full", regression: bool = False):
    """Post-hoc Laplace on a saved MAP state (reference fit_laplace.py):
    ``(laplace method, fitted state)``."""
    method = laplace_method(model, hessian=hessian, regression=regression)
    return method, method.fit(map_state, train_data)
