"""SWAG: Stochastic Weight Averaging - Gaussian.

Counterpart of ``beyond_deep_ensembles_tpu/methods/swag.py`` (reference
SwagOptimizer, src/algos/swag.py). The first and second moments ``[D]`` and
the ring of the last K deviations ``[K, D]`` live on the device as method
state, with the counters ``updates`` and ``steps_since_start`` and the
``epoch``, all device tensors: the bookkeeping is branch-free (selects on
the device), so a captured step reads them at every replay and starts
collecting once ``finalize_epoch`` has moved the epoch past
``start_epoch``. As in JAX, the update count is pre-incremented, so the
init point counts as one collected sample, and the ring rolls by one row
per collection, the newest deviation last.

A sample is ``mean + z1 @ dev / sqrt(2(K-1)) + sqrt(diag) * z2`` with
``diag = 0.5 * (relu(sq_mean - mean^2) + 1e-6)``, z1 ``[K]`` and z2 ``[D]``
from the forward's ``NoiseSource``, never a covariance; ``__mle``
parameters keep their current values. It is returned as a mapping from
parameter names to tensors, which ``nn/base.py::Model.apply`` runs through
the model with ``torch.func.functional_call``. As in JAX, a non-finite loss
is not guarded against.

Under ``ring_sharding`` (``methods/rings.py``) the moments and the ring hold
this rank's columns of the padded D (``[D/N]`` and ``[K, D/N]``); a draw is
made of the whole padded width, its columns combined on each rank and
gathered once, where it is unraveled into parameters.

The flat order is the module's parameter order (``tree.ravel``), not
``jax.tree.leaves``' alphabetical one; ``models/jax_convert.py`` maps a JAX
state across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..tree import make_unravel, ravel
from . import rings
from .api import LossFn, MethodState, PosteriorMethod, non_mle_mask

_SWAG_KEYS = ("mean", "sq_mean", "deviations", "updates", "steps_since_start")


@dataclasses.dataclass(kw_only=True)
class SwagState(MethodState):
    mean: torch.Tensor  # [D] running first moment ([D/N] columns when sharded)
    sq_mean: torch.Tensor  # [D] running second moment
    deviations: torch.Tensor  # [K, D] ring of deviation rows, ring_dtype
    updates: torch.Tensor  # int32: moment updates so far
    steps_since_start: torch.Tensor  # int32

    def written_tensors(self) -> list:
        return super().written_tensors() + [getattr(self, k) for k in _SWAG_KEYS]

    def state_dict(self) -> dict:
        return {**super().state_dict(), **{f"swag.{k}": getattr(self, k) for k in _SWAG_KEYS}}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        with torch.no_grad():
            for k in _SWAG_KEYS:
                getattr(self, k).copy_(state[f"swag.{k}"])


def swag_method(
    loss_fn: LossFn,
    tx: Callable,
    update_interval: int,
    start_epoch: int = 0,
    deviation_samples: int = 30,
    ring_dtype: torch.dtype = torch.float32,
    ring_sharding=None,
) -> PosteriorMethod:
    """``tx(params) -> (optimizer, None)``; a collection every
    ``update_interval`` steps from the epoch ``start_epoch`` on, the last
    ``deviation_samples`` deviations kept in ``ring_dtype``."""
    rings.check(ring_sharding)
    update_interval = int(math.floor(update_interval))

    def init(params, model_state=None):
        with torch.no_grad():
            flat = rings.shard(ravel(params), ring_sharding)
        device = flat.device
        return SwagState(
            params=params,
            model_state=model_state or {},
            opt_state=tx(params.parameters()),
            epoch=torch.zeros((), dtype=torch.int32, device=device),
            mean=flat.clone(),
            sq_mean=flat**2,
            deviations=torch.zeros((deviation_samples, flat.shape[0]), dtype=ring_dtype, device=device),
            updates=torch.zeros((), dtype=torch.int32, device=device),
            steps_since_start=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(state: SwagState, noise, batch):
        optimizer, scheduler = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(state.params, state.model_state, noise, batch)
        out.loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        with torch.no_grad():
            # SWAG bookkeeping (reference swag.py:91-105), branch-free
            started = state.epoch >= start_epoch
            steps_since = state.steps_since_start + started.to(torch.int32)
            do_update = started & (steps_since % update_interval == 0)
            flat = rings.shard(ravel(state.params), ring_sharding)
            n = state.updates + 1
            new_mean = (n * state.mean + flat) / (n + 1)
            new_sq = (n * state.sq_mean + flat**2) / (n + 1)
            new_dev = torch.roll(state.deviations, -1, 0)
            new_dev[-1] = rings.store(flat - new_mean, ring_dtype)
            state.mean.copy_(torch.where(do_update, new_mean, state.mean))
            state.sq_mean.copy_(torch.where(do_update, new_sq, state.sq_mean))
            state.deviations.copy_(torch.where(do_update, new_dev, state.deviations))
            state.updates.add_(do_update.to(torch.int32))
            state.steps_since_start.copy_(steps_since)
        state.model_state = out.model_state or state.model_state
        state.step += 1
        return state, {"loss": out.loss.detach(), **{k: v.detach() for k, v in out.metrics.items()}}

    def sample(state: SwagState, noise, index=None):
        """Low-rank plus diagonal Gaussian draw (reference swag.py:107-114):
        z1 then z2 from ``noise``; ``(params mapping, model_state)``."""
        del index
        mean = state.mean
        current = dict(state.params.named_parameters())
        d = sum(p.numel() for p in current.values())
        diag = 0.5 * (F.relu(state.sq_mean - mean**2) + 1e-6)
        z1 = noise.normal((deviation_samples,), mean.device, True, False)
        z2 = noise.normal((rings.padded_width(d, ring_sharding),), mean.device, True, False)
        low_rank = torch.matmul(z1, rings.load(state.deviations))  # fp32, whatever the ring stores
        flat = mean + low_rank / math.sqrt(2 * (deviation_samples - 1)) + torch.sqrt(diag) * rings.shard(
            z2, ring_sharding)
        flat = rings.gather(flat, ring_sharding)
        drawn = make_unravel(state.params)(flat[:d])
        mask = non_mle_mask(state.params)
        params = {name: drawn[name] if mask[name] else current[name].detach() for name in current}
        return params, state.model_state

    def finalize_epoch(state: SwagState):
        with torch.no_grad():
            state.epoch.add_(1)
        return state

    return PosteriorMethod(init=init, update=update, sample=sample, finalize_epoch=finalize_epoch)
