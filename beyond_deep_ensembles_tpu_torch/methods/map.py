"""MAP (point estimate) method.

Counterpart of ``beyond_deep_ensembles_tpu/methods/map.py`` (reference
MAPOptimizer, src/algos/pp.py:6-34): forward, backward, one optimizer step;
``sample`` returns the live parameters. Also the chassis of MC-Dropout: MCD
is MAP training of a model whose dropout layers stay active at eval, so
``sample_is_identity`` makes ``predict`` run S forwards, each drawing fresh
masks. As in the JAX package, a non-finite loss is not guarded against.

``tx(params) -> (optimizer, scheduler or None)`` builds the optimizer from
the parameters that require gradients.
"""
from __future__ import annotations

from typing import Callable

from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch


def map_method(loss_fn: LossFn, tx: Callable) -> PosteriorMethod:
    def init(params, model_state=None):
        trained = [p for p in params.parameters() if p.requires_grad]
        return MethodState(params=params, model_state=model_state or {}, opt_state=tx(trained))

    def update(state: MethodState, noise, batch):
        optimizer, scheduler = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(state.params, state.model_state, noise, batch)
        out.loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        state.model_state = out.model_state or state.model_state
        state.step += 1
        return state, {"loss": out.loss.detach(), **{k: v.detach() for k, v in out.metrics.items()}}

    def sample(state: MethodState, noise=None, index=None):
        del noise, index
        return state.params, state.model_state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=default_finalize_epoch,
        sample_is_identity=True,
    )
