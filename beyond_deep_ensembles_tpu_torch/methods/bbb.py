"""Bayes-By-Backprop method (also trains Rank-1 VI models).

Counterpart of ``beyond_deep_ensembles_tpu/methods/bbb.py`` (reference
BBBOptimizer, src/algos/bbb.py:43-99): ``mc_samples`` forwards per step, the
closed-form Gaussian KL collected once (plus ``l2_scale`` times the L2 of
the plain parameters), loss = kl_rescaling/N * KL + data_loss/(mc_samples *
components), and a non-finite loss skips the update of both the parameters
and the optimizer state, its update count included, by a select on the
device (``utils/optim.py::SGD.step``; JAX ``methods/bbb.py:97-107``), so the
step reads nothing on the host and a CUDA graph can capture it.

Rank-1 VI (``components`` = C > 1; reference src/algos/rank1.py trained by
``BBBOptimizer(components=C)``): MC sample i runs the joint component
``(base + i) % C`` with ``base = (updates * mc_samples) % C``, passed to
``loss_fn`` as ``component``. ``updates`` counts every update, a skipped one
included (the JAX state's ``step``), as an int64 tensor on the device that
the update itself advances (:class:`MixtureState`): a captured step reads
it at every replay, where the host's ``state.step`` would be frozen into
the graph. The KL covers every component's factors.

``tx(params) -> (optimizer, None)`` builds the optimizer: the port's
``SGD`` (``experiments/cifar.py::_base_tx``), whose schedule counts the
updates it applied, as optax's does, and whose ``step(ok)`` takes the guard.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .api import (
    LossFn,
    MethodState,
    PosteriorMethod,
    collect_gaussian_kl,
    default_finalize_epoch,
    l2_of_plain_params,
)


@dataclasses.dataclass(kw_only=True)
class MixtureState(MethodState):
    """A Rank-1 mixture's state: ``updates`` (int64, on the device) is the
    count of updates so far, from which each step takes its components."""

    updates: torch.Tensor

    def written_tensors(self) -> list:
        return super().written_tensors() + [self.updates]

    def state_dict(self) -> dict:
        return {**super().state_dict(), "bbb.updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        with torch.no_grad():
            self.updates.copy_(state["bbb.updates"])


def bbb_method(
    loss_fn: LossFn,
    tx: Callable,
    prior,
    dataset_size: int,
    mc_samples: int = 1,
    kl_rescaling: float = 1.0,
    components: int = 1,
    l2_scale: float = 0.0,
) -> PosteriorMethod:
    def init(params, model_state=None):
        fields = {"params": params, "model_state": model_state or {}, "opt_state": tx(params.parameters())}
        if components == 1:
            return MethodState(**fields)
        device = next(params.parameters()).device
        return MixtureState(**fields, updates=torch.zeros((), dtype=torch.int64, device=device))

    def update(state: MethodState, noise, batch):
        params = state.params
        optimizer, _ = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        model_state, data_loss, sown_kl = state.model_state, 0.0, 0.0
        base = (state.updates * mc_samples) % components if components > 1 else None
        for i in range(mc_samples):
            kwargs = {} if base is None else {"component": (base + i) % components}
            out = loss_fn(params, model_state, noise, batch, **kwargs)
            model_state = out.model_state or model_state
            data_loss = data_loss + out.loss
            sown_kl = out.kl
        # KL collected once (reference bbb.py:69-79), L2 on plain parameters
        kl = collect_gaussian_kl(params, prior) + sown_kl
        if l2_scale:
            kl = kl + l2_scale * l2_of_plain_params(params)
        loss = kl_rescaling / dataset_size * kl + data_loss / (mc_samples * components)
        loss.backward()
        # NaN guard (reference bbb.py:81): a skipped step leaves parameters,
        # momentum and the schedule's count as they were
        optimizer.step(torch.isfinite(loss))
        if base is not None:
            with torch.no_grad():
                state.updates.add_(1)
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
