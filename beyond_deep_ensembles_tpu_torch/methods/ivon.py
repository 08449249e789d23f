"""iVON: Improved Variational Online Newton.

Counterpart of ``beyond_deep_ensembles_tpu/methods/ivon.py`` (reference
iVONOptimizer, src/algos/ivorn.py). Per element, with t the count of
updates applied, b1/b2 the betas, N = dataset_size * augmentation and
delta_reg = tempering * prior_prec / N:

  g        = mean of the MC gradients
  g_mu     = delta_reg * mean + g
  momentum = b1 * momentum + (1-b1) * g_mu
  g_s      = delta_reg - prec + (N * prec * sum(delta)/mc) * g + damping
  mean    -= lr * (momentum / (1-b1^t)) / (prec / (1-b2^t))
  prec    += ((1-b2) + 0.5 (1-b2)^2 g_s / prec) * g_s

The state (:class:`IvonState`) holds ``mean``, ``momentum`` and
``precision`` as flat ``[D]`` vectors in the module's parameter order, the
parameters rebound as views of one flat buffer (``utils/optim.py::
flatten_parameters``), and ``count`` (JAX ``IvonState.step``), an int64 on
the device that the update advances only when it applies: the bias
corrections read it at every replay of a captured step. Each MC draw
``delta = eps / sqrt(N * max(prec, 1e-4))`` (zero on ``__mle``
parameters) takes ``eps`` ``[D]`` from the step's ``NoiseSource`` in turn,
so two draws of a step differ; the update writes ``mean + delta`` into the
parameters, runs the loss and its backward there, and accumulates the
gradients and the deltas. A non-finite loss or gradient skips the whole
update, ``count`` included, by a select on the device. Afterwards the
parameters hold the mean. ``sample`` returns ``mean + delta`` as a mapping
from parameter names to tensors, as SWAG's draws. There is no optimizer:
the lr is a constant (``configs/cifar.yaml``'s iVON rows set
``lr_schedule: false``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import make_unravel
from ..utils.optim import flat_grad, flatten_parameters
from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch, non_mle_mask

_IVON_KEYS = ("mean", "momentum", "precision", "count")


@dataclasses.dataclass(kw_only=True)
class IvonState(MethodState):
    flat: torch.Tensor  # [D] the parameters' buffer (the parameters are views of it)
    mean: torch.Tensor  # [D]
    momentum: torch.Tensor  # [D]
    precision: torch.Tensor  # [D]
    count: torch.Tensor  # int64: updates applied (JAX ``step``)
    mle_free: Optional[torch.Tensor] = None  # [D] bool, False on ``__mle`` parameters; None when all are free

    def written_tensors(self) -> list:
        return super().written_tensors() + [getattr(self, k) for k in _IVON_KEYS]

    def state_dict(self) -> dict:
        return {**super().state_dict(), **{f"ivon.{k}": getattr(self, k) for k in _IVON_KEYS}}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        with torch.no_grad():
            for k in _IVON_KEYS:
                getattr(self, k).copy_(state[f"ivon.{k}"])


def ivon_method(
    loss_fn: LossFn,
    lr: float,
    prior_prec: float,
    dataset_size: int,
    betas=(0.9, 0.999),
    damping: float = 0.0,
    tempering: float = 1.0,
    augmentation: float = 1.0,
    mc_samples: int = 5,
) -> PosteriorMethod:
    """The JAX package's ``deterministic`` (no perturbation, for its
    last-layer methods) has no caller in the port yet and is not taken."""
    if callable(lr):
        raise NotImplementedError("an iVON lr schedule: not ported yet")
    n_eff = dataset_size * augmentation
    delta_reg = tempering * prior_prec / n_eff
    beta1, beta2 = betas

    def _draw(state: IvonState, noise) -> torch.Tensor:
        """delta = N(0, 1/(N prec)) (reference ivorn.py:102-111), zero on
        ``__mle`` parameters."""
        prec = state.precision
        eps = noise.normal(tuple(prec.shape), prec.device, True, False)
        delta = eps / torch.sqrt(n_eff * torch.clamp(prec, min=1e-4))
        mask = state.mle_free
        return delta if mask is None else torch.where(mask, delta, 0.0)

    def init(params, model_state=None):
        plist = list(params.parameters())
        flat = flatten_parameters(plist)
        mask = non_mle_mask(params)
        mle_free = None
        if not all(mask.values()):
            mle_free = torch.cat([torch.full((p.numel(),), mask[name], device=flat.device)
                                  for name, p in params.named_parameters()])
        return IvonState(
            params=params,
            model_state=model_state or {},
            opt_state=None,
            flat=flat,
            mean=flat.clone(),
            momentum=torch.zeros_like(flat),
            precision=torch.full_like(flat, prior_prec / dataset_size),
            count=torch.zeros((), dtype=torch.int64, device=flat.device),
            mle_free=mle_free,
        )

    def update(state: IvonState, noise, batch):
        plist = list(state.params.parameters())
        acc_grad = torch.zeros_like(state.flat)
        acc_delta = torch.zeros_like(state.flat)
        acc_loss, model_state = 0.0, state.model_state
        for _ in range(mc_samples):
            delta = _draw(state, noise)
            with torch.no_grad():
                state.flat.copy_(state.mean + delta)
            for p in plist:
                p.grad = None
            out = loss_fn(state.params, model_state, noise, batch)
            out.loss.backward()
            with torch.no_grad():
                acc_grad += flat_grad(plist)
                acc_delta += delta
            acc_loss = acc_loss + out.loss.detach()
            model_state = out.model_state or model_state
        for p in plist:
            p.grad = None
        avg_loss = acc_loss / mc_samples
        with torch.no_grad():
            mean, mom, prec = state.mean, state.momentum, state.precision
            t = (state.count + 1).to(torch.float32)
            g = acc_grad / mc_samples
            g_mu = delta_reg * mean + g
            new_mom = beta1 * mom + (1 - beta1) * g_mu
            g_s = delta_reg - prec + (n_eff * prec * acc_delta / mc_samples) * g + damping
            corr_mom = new_mom / (1 - torch.pow(beta1, t))
            corr_prec = prec / (1 - torch.pow(beta2, t))
            new_mean = mean - lr * corr_mom / corr_prec
            new_prec = prec + ((1 - beta2) + 0.5 * (1 - beta2) ** 2 * g_s / prec) * g_s
            # skip the whole update on a non-finite loss or gradient
            # (reference ivorn.py:60-61), the count included
            ok = torch.isfinite(avg_loss) & torch.isfinite(acc_grad).all()
            mean.copy_(torch.where(ok, new_mean, mean))
            mom.copy_(torch.where(ok, new_mom, mom))
            prec.copy_(torch.where(ok, new_prec, prec))
            state.count.add_(ok.to(torch.int64))
            state.flat.copy_(mean)
        state.model_state = model_state
        state.step += 1
        # ``backbone_loss``: the sum over MC samples (JAX :174)
        return state, {"loss": avg_loss, "backbone_loss": acc_loss}

    def sample(state: IvonState, noise, index=None):
        """``mean + delta`` as ``(params mapping, model_state)``."""
        del index
        drawn = make_unravel(state.params)(state.mean + _draw(state, noise))
        return drawn, state.model_state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=default_finalize_epoch,
    )
