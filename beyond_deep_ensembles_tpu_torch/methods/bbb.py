"""Bayes-By-Backprop method.

Counterpart of ``beyond_deep_ensembles_tpu/methods/bbb.py`` (reference
BBBOptimizer, src/algos/bbb.py:43-99): ``mc_samples`` forwards per step, the
closed-form Gaussian KL collected once,
loss = kl_rescaling/N * KL + data_loss/(mc_samples * components), and a
non-finite loss skips the update of both the parameters and the optimizer
state. Rank-1 mixtures (``components > 1``) are not ported yet.

``tx(params) -> (optimizer, scheduler or None)`` builds the optimizer; the
scheduler steps once per applied update, as optax's schedule counts the
updates it applied.
"""
from __future__ import annotations

import math
from typing import Callable

from .api import (
    LossFn,
    MethodState,
    PosteriorMethod,
    collect_gaussian_kl,
    default_finalize_epoch,
)


def bbb_method(
    loss_fn: LossFn,
    tx: Callable,
    prior,
    dataset_size: int,
    mc_samples: int = 1,
    kl_rescaling: float = 1.0,
    components: int = 1,
) -> PosteriorMethod:
    if components != 1:
        raise NotImplementedError("rank-1 mixtures (components > 1): not ported yet")

    def init(params, model_state=None):
        return MethodState(
            params=params, model_state=model_state or {}, opt_state=tx(params.parameters())
        )

    def update(state: MethodState, noise, batch):
        params = state.params
        optimizer, scheduler = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        model_state, data_loss, sown_kl = state.model_state, 0.0, 0.0
        for _ in range(mc_samples):
            out = loss_fn(params, model_state, noise, batch)
            model_state = out.model_state or model_state
            data_loss = data_loss + out.loss
            sown_kl = out.kl
        # KL collected once (reference bbb.py:69-79)
        kl = collect_gaussian_kl(params, prior) + sown_kl
        loss = kl_rescaling / dataset_size * kl + data_loss / (mc_samples * components)
        loss.backward()
        # NaN guard (reference bbb.py:81): a skipped step leaves parameters,
        # momentum and the schedule's count as they were. Reads one scalar.
        if math.isfinite(loss.item()):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        state.model_state = model_state
        state.step += 1
        metrics = {"loss": loss.detach(), "data_loss": data_loss.detach() / mc_samples, "kl": kl.detach()}
        return state, metrics

    def sample(state: MethodState, noise=None, index=None):
        # Layers sample in the forward pass; ``noise`` drives them.
        del noise, index
        return state.params, state.model_state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=default_finalize_epoch,
        sample_is_identity=True,
    )
