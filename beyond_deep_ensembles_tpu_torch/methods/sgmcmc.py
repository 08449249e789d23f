"""SG-MCMC: SGLD / SGHMC as a gradient transformation, plus a posterior
method that keeps a ring of draws.

Counterpart of ``beyond_deep_ensembles_tpu/methods/sgmcmc.py`` (reference
google-bnn-hmc/bnn_hmc/core/sgmcmc.py:52-183), with its dynamics, in the
loss-gradient (descent) convention:

  m   <- momentum_decay * m - sqrt(lr) * g_U + sqrt(2 (1 - momentum_decay) T) * M^{1/2} eps
  θ   <- θ + sqrt(lr) * M^{-1} m

with g_U the gradient of the potential U = N * minibatch_loss +
||θ||² / (2 prior_std²), M the preconditioner and T the temperature;
momentum_decay = 0 is SGLD, > 0 SGHMC. JAX's ``sgld`` is an optax
transformation; here :class:`SGLD` is a plain object with ``init(params)``
and ``update(grads, state, key=..., noise=...)`` over trees (a flat tensor
or a mapping, ``tree.py``). The method keeps the parameters in one flat
vector in ``tree.sorted_named`` order, the module's parameters views of it,
as ``methods/hmc.py`` does; ``noise`` is a ``torch.Generator`` or a mapping
with the standard-normal draw ``noise`` (``[D]``, flat order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, NamedTuple, Optional, Union

import torch

from .. import tree
from ..parallel import mesh as _mesh
from ..utils.optim import flatten_parameters
from . import rings
from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch


class RMSPreconditioner(NamedTuple):
    """RMSProp-style diagonal mass matrix (reference sgmcmc.py:119-154)."""

    running_average_factor: float = 0.99
    eps: float = 1e-7

    def init(self, params):
        return tree.tree_zeros_like(params)

    def update(self, grads, state):
        a = self.running_average_factor
        return tree.tree_map(lambda e, g: a * e + (1 - a) * g * g, state, grads)

    def m_sqrt(self, vec, state):
        return tree.tree_map(lambda e, v: v * torch.sqrt(self.eps + torch.sqrt(e)), state, vec)

    def m_inv(self, vec, state):
        return tree.tree_map(lambda e, v: v / (self.eps + torch.sqrt(e)), state, vec)


class IdentityPreconditioner(NamedTuple):
    def init(self, params):
        return None

    def update(self, grads, state):
        return None

    def m_sqrt(self, vec, state):
        return vec

    def m_inv(self, vec, state):
        return vec


class SGLDState(NamedTuple):
    count: torch.Tensor  # int64, updates so far
    momentum: Any
    precond_state: Any


def _leaf(t) -> torch.Tensor:
    return next(iter(tree.named(t).values()))


class SGLD:
    """SGLD / SGHMC over potential gradients (``sgld``'s transformation):
    ``update(grads, state, key=None, noise=None) -> (updates, state)``,
    the injected noise the standard normals ``noise`` (a tree like
    ``grads``) or drawn from ``key`` (a ``torch.Generator``), none with
    neither, as the JAX transformation without a key."""

    def __init__(self, step_size_fn: Union[float, Callable], momentum_decay: float = 0.0,
                 temperature: float = 1.0, preconditioner=None):
        self.lr_fn = step_size_fn if callable(step_size_fn) else (lambda _: step_size_fn)
        self.momentum_decay, self.temperature = momentum_decay, temperature
        self.pc = preconditioner or IdentityPreconditioner()

    def init(self, params) -> SGLDState:
        count = torch.zeros((), dtype=torch.int64, device=_leaf(params).device)
        return SGLDState(count, tree.tree_zeros_like(params), self.pc.init(params))

    def update(self, grads, state: SGLDState, params=None, *, key: Optional[torch.Generator] = None, noise=None):
        del params
        device = _leaf(grads).device
        lr_sqrt = torch.sqrt(torch.as_tensor(self.lr_fn(state.count), dtype=torch.float32, device=device))
        noise_std = torch.sqrt(torch.tensor(2.0 * (1.0 - self.momentum_decay) * self.temperature,
                                            dtype=torch.float32, device=device))
        pstate = self.pc.update(grads, state.precond_state)
        if noise is None and key is not None:
            noise = tree.normal_like(key, grads)
        if noise is None:
            noise = tree.tree_zeros_like(grads)
        else:
            noise = self.pc.m_sqrt(noise, pstate)
        md = self.momentum_decay
        momentum = tree.tree_map(lambda m, g, n: md * m - g * lr_sqrt + n * noise_std, state.momentum, grads, noise)
        updates = tree.tree_map(lambda u: u * lr_sqrt, self.pc.m_inv(momentum, pstate))
        return updates, SGLDState(state.count + 1, momentum, pstate)


def sgld(step_size_fn: Union[float, Callable], momentum_decay: float = 0.0, temperature: float = 1.0,
         preconditioner=None) -> SGLD:
    return SGLD(step_size_fn, momentum_decay, temperature, preconditioner)


@dataclasses.dataclass(kw_only=True)
class SgmcmcState(MethodState):
    """``opt_state`` is the :class:`SGLDState` over the flat vector."""

    flat: torch.Tensor  # [D] the parameters, sorted order; the module's are views of it
    samples: torch.Tensor  # [K, D] ring of flat posterior draws, newest last
    n_samples: torch.Tensor  # int32, valid rows

    def _tensors(self) -> dict:
        sgld_state = self.opt_state
        out = {"sgld.count": sgld_state.count, "sgld.momentum": sgld_state.momentum}
        if sgld_state.precond_state is not None:
            out["sgld.precond"] = sgld_state.precond_state
        return {**out, "sgmcmc.samples": self.samples, "sgmcmc.n_samples": self.n_samples}

    def written_tensors(self) -> list:
        return [p.detach() for p in self.params.parameters()] + list(self._tensors().values())

    def state_dict(self) -> dict:
        out = {f"params.{k}": v for k, v in self.params.state_dict().items()}
        out.update(self._tensors())
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        out["epoch"] = torch.tensor(self.epoch, dtype=torch.int64)
        return out

    def load_state_dict(self, state: dict) -> None:
        mine = self.state_dict()
        if mine.keys() != state.keys():
            raise KeyError(f"state keys differ: {sorted(mine.keys() ^ state.keys())}")
        with torch.no_grad():
            for k, v in mine.items():
                if k not in ("step", "epoch"):
                    v.copy_(state[k])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])


def sgmcmc_method(
    loss_fn: LossFn,
    dataset_size: int,
    step_size_fn: Union[float, Callable],
    momentum_decay: float = 0.0,
    temperature: float = 1.0,
    prior_std: float = 1.0,
    preconditioner: Optional[str] = None,
    sample_interval: int = 100,
    max_samples: int = 20,
    burn_in_steps: int = 0,
    ring_dtype: torch.dtype = torch.float32,
    ring_sharding=None,
) -> PosteriorMethod:
    """SGLD / SGHMC as a posterior method: every ``sample_interval`` steps
    past ``burn_in_steps`` the parameters are pushed into the ``[max_samples,
    D]`` ring of ``ring_dtype``; ``sample(index)`` counts back from the
    newest draw. ``preconditioner="rmsprop"`` takes :class:`RMSPreconditioner`.
    ``ring_sharding`` (a ``rings.RingSharding``) splits the ring's columns
    over a data axis. On a data-parallel mesh the potential's data term
    and its gradient are the whole batch's (their mean over the data axis,
    one collective), the prior's gradient added after, so every rank steps
    alike."""
    rings.check(ring_sharding)
    pc = RMSPreconditioner() if preconditioner == "rmsprop" else None
    tx = sgld(step_size_fn, momentum_decay, temperature, pc)

    def init(params, model_state=None):
        flat = flatten_parameters(list(tree.sorted_named(params).values()))
        return SgmcmcState(
            params=params,
            model_state=model_state or {},
            opt_state=tx.init(flat),
            flat=flat,
            samples=torch.zeros((max_samples, rings.shard(flat, ring_sharding).shape[0]), dtype=ring_dtype,
                                device=flat.device),
            n_samples=torch.zeros((), dtype=torch.int32, device=flat.device),
        )

    def update(state: SgmcmcState, noise, batch):
        unravel = tree.make_unravel(tree.sorted_named(state.params))
        with torch.enable_grad():
            theta = state.flat.detach().clone().requires_grad_(True)
            out = loss_fn(unravel(theta), state.model_state, None, batch)
            prior = tree.tree_sq_norm(theta) / (2 * prior_std**2)
            pot = dataset_size * out.loss + prior
            if _mesh.active() is None:
                (grads,) = torch.autograd.grad(pot, theta)
            else:
                (grads,) = torch.autograd.grad(dataset_size * out.loss, theta)
        if _mesh.active() is not None:
            grads, data_term = _mesh.mean_of([grads, (dataset_size * out.loss).detach()])
            grads = grads + state.flat / prior_std**2
            pot = data_term + prior.detach()
        given = noise["noise"].to(grads.device) if isinstance(noise, Mapping) else None
        key = noise if isinstance(noise, torch.Generator) else None
        with torch.no_grad():
            updates, opt_state = tx.update(grads, state.opt_state, key=key, noise=given)
            state.flat.copy_(state.flat + updates)
            state.opt_state = opt_state
            state.step += 1
            if state.step > burn_in_steps and state.step % sample_interval == 0:
                state.samples.copy_(rings.pushed(state.samples, state.flat, ring_dtype, ring_sharding))
                state.n_samples.copy_(torch.clamp(state.n_samples + 1, max=max_samples))
        state.model_state = out.model_state or state.model_state
        return state, {"loss": out.loss.detach(), "potential": pot.detach()}

    def sample(state: SgmcmcState, noise=None, index=None):
        del noise
        with torch.no_grad():
            flat = rings.read(state.samples, state.n_samples, 0 if index is None else index, state.flat,
                              ring_sharding)
        return tree.make_unravel(tree.sorted_named(state.params))(flat), state.model_state

    return PosteriorMethod(init=init, update=update, sample=sample, finalize_epoch=default_finalize_epoch)
