"""SNGP training method.

Counterpart of ``beyond_deep_ensembles_tpu/methods/sngp.py`` (reference
SNGPOptimizer, src/algos/kernel/sngp.py:235-267): ``map_method`` training of
the spectral-normalized backbone and GP head, the head's precision
accumulating in its training forwards (a module buffer here, written in
place), and a ``finalize_epoch`` that computes the covariance from the
precision by Cholesky on the device, resets the precision to ``ridge * I``
(``nn/sngp.py::recompute_covariance_and_reset``, all in place, so a captured
eval graph reads the new covariance) and advances the epoch. Prediction is
one forward that returns every sample (``multisample``).
"""
from __future__ import annotations

from typing import Callable

from ..nn.sngp import recompute_covariance_and_reset
from .api import LossFn, PosteriorMethod
from .map import map_method


def sngp_method(loss_fn: LossFn, tx: Callable, ridge_penalty: float = 0.001) -> PosteriorMethod:
    base = map_method(loss_fn, tx)

    def finalize_epoch(state):
        recompute_covariance_and_reset(state.params, ridge_penalty)
        state.epoch += 1
        return state

    return PosteriorMethod(
        init=base.init,
        update=base.update,
        sample=base.sample,
        finalize_epoch=finalize_epoch,
        sample_is_identity=True,
        multisample=True,
    )
