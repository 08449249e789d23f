"""Full-batch Hamiltonian Monte Carlo with an adaptive step size.

Counterpart of ``beyond_deep_ensembles_tpu/methods/hmc.py`` (reference
bnn_hmc/core/hmc.py): leapfrog integration, Metropolis-Hastings acceptance
on the joint kinetic + likelihood + prior energy difference, multiplicative
step-size adaptation toward a target accept rate, and a ``[max_samples, D]``
ring of accepted draws for prediction. ``update`` runs one whole iteration.

The potential is U(θ) = dataset_size * loss(θ) + ||θ||² / (2 prior_std²).

The parameters live in one flat vector, ``state.flat``, in
``tree.sorted_named`` order (``jax.tree.leaves``' order, each leaf in the
port's layout); the module's parameters are views of it, so the live module
always holds the chain's current point. The gradient is taken with respect
to that vector (``torch.func.functional_call`` on its views), so the
leapfrog's kicks and drifts, the energies and the ring are single passes
over ``[D]``. ``noise`` is a ``torch.Generator`` (the momentum drawn as
``randn(D)``, then the accept uniform) or a mapping holding those draws
(``momentum`` ``[D]`` in the flat order, ``uniform`` a 0-dim tensor), so a
test can give the JAX package's draws.

On a data-parallel mesh (``parallel/mesh.py``; the full batch sharded over
the data axis, the chain replicated) the log-likelihood and its gradient are
the whole batch's: the shard's ``-dataset_size * loss`` and its gradient
averaged over the axis by one collective, the prior's added after. Every
rank then holds the same energies and draws the same momentum and uniform,
so the accept test decides alike on every rank. ``ring_sharding`` stores
each rank's columns of the draws (``methods/rings.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from .. import tree
from ..parallel import mesh as _mesh
from ..utils.optim import flatten_parameters
from . import rings
from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch

_HMC_KEYS = ("step_size", "log_likelihood", "grad", "samples", "n_samples", "accept_prob", "accepted")


@dataclasses.dataclass(kw_only=True)
class HmcState(MethodState):
    flat: torch.Tensor  # [D] the parameters, sorted order; the module's are views of it
    step_size: torch.Tensor  # fp32
    log_likelihood: torch.Tensor  # -dataset_size * loss at the parameters
    grad: torch.Tensor  # [D] gradient of -U at the parameters (ascent direction)
    samples: torch.Tensor  # [K, D] ring of accepted draws, newest last ([K, D/N] columns when sharded)
    n_samples: torch.Tensor  # int32
    accept_prob: torch.Tensor
    accepted: torch.Tensor  # bool

    def written_tensors(self) -> list:
        return super().written_tensors() + [getattr(self, k) for k in _HMC_KEYS]

    def state_dict(self) -> dict:
        return {**super().state_dict(), **{f"hmc.{k}": getattr(self, k) for k in _HMC_KEYS}}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        with torch.no_grad():
            for k in _HMC_KEYS:
                getattr(self, k).copy_(state[f"hmc.{k}"])


def leapfrog(grad_fn: Callable, params, momentum, grad, loglik, step_size, n_leapfrog: int):
    """Leapfrog integrator (reference make_leapfrog, bnn_hmc/core/hmc.py:
    36-64): half-kick, drift, gradient, half-kick, ``n_leapfrog`` times.
    ``grad_fn(params) -> (loglik, grad)``, ``grad`` that of -U; ``params``,
    ``momentum`` and ``grad`` are flat tensors or trees with the same
    names. Returns ``(params, momentum, grad, loglik)``."""
    for _ in range(n_leapfrog):
        momentum = tree.tree_add(momentum, grad, scale=0.5 * step_size)
        params = tree.tree_add(params, momentum, scale=step_size)
        loglik, grad = grad_fn(params)
        momentum = tree.tree_add(momentum, grad, scale=0.5 * step_size)
    return params, momentum, grad, loglik


def make_grad_fn(loss_fn: LossFn, dataset_size: int, prior_std: float, template, model_state, batch) -> Callable:
    """``grad_fn(flat) -> (loglik, grad)`` of the potential's negative
    ``-U = -dataset_size * loss + log_prior`` with respect to a flat vector
    in ``template``'s sorted order (``template``: the module or a mapping
    of its parameters)."""
    unravel = tree.make_unravel(tree.sorted_named(template))

    def grad_fn(flat: torch.Tensor):
        with torch.enable_grad():
            theta = flat.detach().requires_grad_(True)
            out = loss_fn(unravel(theta), model_state, None, batch)
            loglik = -dataset_size * out.loss
            if _mesh.active() is None:
                neg_u = loglik + _log_prior(theta, prior_std)
                (grad,) = torch.autograd.grad(neg_u, theta)
                return loglik.detach(), grad
            # a shard of the full batch: the whole batch's likelihood and
            # gradient by one collective, then the prior's gradient
            (grad,) = torch.autograd.grad(loglik, theta)
        grad, loglik = _mesh.mean_of([grad, loglik.detach()])
        return loglik, grad - flat.detach() / prior_std**2

    return grad_fn


def _log_prior(params, prior_std: float) -> torch.Tensor:
    return -tree.tree_sq_norm(params) / (2 * prior_std**2)


def _draws(noise, d: int, device):
    """(momentum ``[D]``, accept uniform) given in ``noise`` or drawn from
    it."""
    if isinstance(noise, Mapping):
        return noise["momentum"].to(device), noise["uniform"].to(device)
    if not isinstance(noise, torch.Generator):
        raise TypeError(f"HMC draws from a torch.Generator or takes them given, got {type(noise).__name__}")
    momentum = torch.randn(d, generator=noise, device=device)
    return momentum, torch.rand((), generator=noise, device=device)


def hmc_method(
    loss_fn: LossFn,
    dataset_size: int,
    step_size: float = 1e-4,
    n_leapfrog: int = 50,
    prior_std: float = 1.0,
    target_accept_rate: float = 0.8,
    step_size_adaptation_speed: float = 0.0,
    max_samples: int = 20,
    do_mh_correction: bool = True,
    ring_dtype: torch.dtype = torch.float32,
    ring_sharding=None,
) -> PosteriorMethod:
    """``ring_dtype`` stores the draw ring (bf16 halves it, rows upcast on
    read); ``ring_sharding`` (a ``rings.RingSharding``) splits its columns
    over a data axis."""
    rings.check(ring_sharding)
    adapt = target_accept_rate > 0 and step_size_adaptation_speed > 0

    def init(params, model_state=None):
        flat = flatten_parameters(list(tree.sorted_named(params).values()))
        device = flat.device

        def scalar(value, dtype=torch.float32):
            return torch.full((), value, dtype=dtype, device=device)

        return HmcState(
            params=params,
            model_state=model_state or {},
            opt_state=None,
            flat=flat,
            step_size=scalar(step_size),
            log_likelihood=scalar(-float("inf")),
            grad=torch.zeros_like(flat),
            samples=torch.zeros((max_samples, rings.shard(flat, ring_sharding).shape[0]), dtype=ring_dtype,
                                device=device),
            n_samples=scalar(0, torch.int32),
            accept_prob=scalar(0.0),
            accepted=scalar(False, torch.bool),
        )

    def update(state: HmcState, noise, batch):
        """One adaptive HMC iteration (reference hmc.py:107-148)."""
        grad_fn = make_grad_fn(loss_fn, dataset_size, prior_std, state.params, state.model_state, batch)
        params0 = state.flat.detach().clone()
        # the energy and gradient at the current point, recomputed: cheap
        # beside n_leapfrog gradients, and it keeps the state minimal
        loglik0, grad0 = grad_fn(params0)
        momentum0, uniform = _draws(noise, params0.shape[0], params0.device)
        params1, momentum1, grad1, loglik1 = leapfrog(
            grad_fn, params0, momentum0, grad0, loglik0, state.step_size, n_leapfrog)

        with torch.no_grad():
            # MH acceptance on the energy difference (reference hmc.py:86-96)
            kinetic_diff = 0.5 * (tree.tree_sq_norm(momentum0) - tree.tree_sq_norm(momentum1))
            energy_diff = (kinetic_diff - (loglik0 - loglik1)
                           - (_log_prior(params0, prior_std) - _log_prior(params1, prior_std)))
            energy_diff = torch.where(torch.isnan(energy_diff), -torch.inf, energy_diff)
            accept_prob = torch.clamp(torch.exp(energy_diff), max=1.0)
            accepted = uniform < accept_prob
            new_step_size = state.step_size
            if adapt:
                new_step_size = state.step_size * torch.exp(
                    step_size_adaptation_speed * (accept_prob - target_accept_rate))
            take = accepted if do_mh_correction else torch.ones_like(accepted)
            params = torch.where(take, params1, params0)
            ring = rings.pushed(state.samples, params, ring_dtype, ring_sharding)
            state.flat.copy_(params)
            state.grad.copy_(torch.where(take, grad1, grad0))
            state.log_likelihood.copy_(torch.where(take, loglik1, loglik0))
            state.samples.copy_(torch.where(take, ring, state.samples))
            state.n_samples.copy_(torch.clamp(state.n_samples + take.to(torch.int32), max=max_samples))
            state.step_size.copy_(new_step_size)
            state.accept_prob.copy_(accept_prob)
            state.accepted.copy_(take)
        state.step += 1
        metrics = {
            "log_likelihood": state.log_likelihood.clone(),
            "accept_prob": accept_prob,
            "accepted": take.to(torch.float32),
            "step_size": state.step_size.clone(),
        }
        return state, metrics

    def sample(state: HmcState, noise=None, index=None):
        """Draw ``index`` counted back from the newest accepted one (modulo
        the draws held); the current parameters while the ring is empty.
        ``(params mapping, model_state)``."""
        del noise
        with torch.no_grad():
            flat = rings.read(state.samples, state.n_samples, 0 if index is None else index, state.flat,
                              ring_sharding)
        return tree.make_unravel(tree.sorted_named(state.params))(flat), state.model_state

    return PosteriorMethod(init=init, update=update, sample=sample, finalize_epoch=default_finalize_epoch)
