"""Mean-field VI over the whole parameter tree (parameter-space MFVI).

Counterpart of ``beyond_deep_ensembles_tpu/methods/vi.py`` (reference
bnn_hmc/core/vi.py:42-131): a Gaussian posterior over every parameter (the
means, and ``rho`` with std = softplus(rho)) trained by reparameterized ELBO
gradients with a tempered KL to an isotropic Gaussian prior. Unlike BBB
(``methods/bbb.py``: Bayesian layers, local reparameterization) it wraps
any deterministic model.

The means are the module's parameters; ``rho`` is a mapping of parameters
with the same names. ``tx(params) -> (optimizer, None)`` (as
``map_method``'s) gets the means then the rhos, each in ``tree.sorted_named``
order, the order of JAX's ``(mean, rho)`` tree, so ``utils/optim.py::Adam``
holds both in one flat buffer as optax holds them. ``noise`` is a
``torch.Generator`` (one ``randn(D)`` an MC sample, flat order) or a mapping
with the draws given: ``eps``, a list of ``[D]`` tensors, one an MC sample,
for ``update``; ``eps``, one ``[D]`` tensor, for ``sample``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .. import tree
from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch


@dataclasses.dataclass(kw_only=True)
class MfviState(MethodState):
    """``params`` (the module) holds the means; ``mean`` maps their sorted
    names to them, ``rho`` to the std parameters. Both are views of the
    optimizer's flat buffer, so the base state's ``opt.*`` carries them."""

    mean: Dict[str, torch.Tensor]
    rho: Dict[str, torch.Tensor]


def _gauss_kl_iso(mean, rho, prior_std: float) -> torch.Tensor:
    """KL( N(mean, softplus(rho)²) || N(0, prior_std²) ), each leaf's sum,
    then the leaves' in order."""
    rho = tree.named(rho)
    total = None
    for name, m in tree.named(mean).items():
        s = F.softplus(rho[name])
        part = torch.sum(torch.log(prior_std / s) - 0.5 + (s**2 + m**2) / (2 * prior_std**2))
        total = part if total is None else total + part
    return total


def _eps(noise, template: Dict[str, torch.Tensor], count: int):
    """``count`` draws of flat standard normals ``[D]``, given or drawn."""
    d = sum(p.numel() for p in template.values())
    device = next(iter(template.values())).device
    if isinstance(noise, Mapping):
        given = noise["eps"]
        given = [given] if isinstance(given, torch.Tensor) else list(given)
        if len(given) != count:
            raise ValueError(f"{count} draws wanted, {len(given)} given")
        return [g.to(device) for g in given]
    if not isinstance(noise, torch.Generator):
        raise TypeError(f"MFVI draws from a torch.Generator or takes them given, got {type(noise).__name__}")
    return [torch.randn(d, generator=noise, device=device) for _ in range(count)]


def _perturbed(mean, rho, eps_flat: torch.Tensor) -> dict:
    eps = tree.make_unravel(mean)(eps_flat)
    return {name: m + F.softplus(rho[name]) * eps[name] for name, m in mean.items()}


def mfvi_method(
    loss_fn: LossFn,
    tx: Callable,
    dataset_size: int,
    prior_std: float = 1.0,
    sigma_init: float = 0.01,
    mc_samples: int = 1,
    kl_weight: float = 1.0,
    temperature: float = 1.0,
) -> PosteriorMethod:
    rho_init = math.log(math.expm1(sigma_init))

    def init(params, model_state=None):
        mean = tree.sorted_named(params)
        rho = {name: nn.Parameter(torch.full_like(p.detach(), rho_init)) for name, p in mean.items()}
        return MfviState(
            params=params,
            model_state=model_state or {},
            opt_state=tx(list(mean.values()) + list(rho.values())),
            mean=mean,
            rho=rho,
        )

    def update(state: MfviState, noise, batch):
        optimizer = state.opt_state[0]
        optimizer.zero_grad(set_to_none=True)
        model_state = state.model_state
        data_loss = torch.zeros((), dtype=torch.float32, device=next(iter(state.mean.values())).device)
        for eps in _eps(noise, state.mean, mc_samples):
            out = loss_fn(_perturbed(state.mean, state.rho, eps), model_state, None, batch)
            model_state = out.model_state or model_state
            data_loss = data_loss + out.loss
        kl = _gauss_kl_iso(state.mean, state.rho, prior_std)
        loss = data_loss / mc_samples + temperature * kl_weight * kl / dataset_size
        loss.backward()
        optimizer.step()
        state.model_state = model_state
        state.step += 1
        return state, {"loss": loss.detach(), "data_loss": (data_loss / mc_samples).detach(), "kl": kl.detach()}

    def sample(state: MfviState, noise, index=None):
        """One draw ``mean + softplus(rho) * eps``: ``(params mapping,
        model_state)``."""
        del index
        (eps,) = _eps(noise, state.mean, 1)
        with torch.no_grad():
            return _perturbed(state.mean, state.rho, eps), state.model_state

    return PosteriorMethod(init=init, update=update, sample=sample, finalize_epoch=default_finalize_epoch)
