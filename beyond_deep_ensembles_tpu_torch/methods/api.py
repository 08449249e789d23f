"""The posterior-method protocol and shared variational machinery.

Counterpart of ``beyond_deep_ensembles_tpu/methods/api.py``. Parameters live
in an ``nn.Module``; a method reads them by name:

  * a Gaussian variational parameter ``w`` is two parameters named
    ``{w}__gmean`` and ``{w}__grho`` (std = softplus(rho));
  * a parameter trained by MLE only carries the suffix ``__mle``.

``params`` below is an ``nn.Module`` or a mapping from dotted parameter
names (``BasicBlock_0.BBBConv_0.kernel__gmean``) to tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, NamedTuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..tree import named as _named

GMEAN_SUFFIX = "__gmean"
GRHO_SUFFIX = "__grho"
MLE_SUFFIX = "__mle"

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class LossOutput(NamedTuple):
    """Return value of a loss function.

    loss:        scalar data loss (mean over the batch).
    kl:          extra KL from layers that compute their own (none on the
                 ported path); closed-form Gaussian KL of ``__gmean``/
                 ``__grho`` pairs is computed by the method itself.
    model_state: updated mutable model state.
    metrics:     auxiliary scalars for logging.
    """

    loss: torch.Tensor
    kl: Union[torch.Tensor, float] = 0.0
    model_state: Any = None
    metrics: dict = {}


LossFn = Callable[..., LossOutput]  # (params, model_state, noise, batch) -> LossOutput


@dataclasses.dataclass
class MethodState:
    """Common chassis for posterior-method state. Unlike the JAX package's
    immutable pytree, it is updated in place: ``params`` is the live model
    module and the optimizer steps it.

    Every state says which tensors its update writes
    (:meth:`written_tensors`: the runners save and restore them around a
    capture's warm-up) and has a flat ``state_dict`` of tensors that
    :meth:`load_state_dict` copies back in place (the checkpoints). Methods
    that keep more state extend both.

    What the JAX package keeps as mutable model state (SNGP's precision, a
    spectral norm's ``u``) the port keeps as module buffers, which a
    forward updates in place: they are among the written tensors and in
    ``params.state_dict()``, and ``model_state`` stays empty."""

    params: nn.Module
    model_state: dict
    opt_state: Any
    step: int = 0
    epoch: int = 0

    def written_tensors(self) -> list:
        """Every tensor an update writes in place: the parameters, the
        module's buffers and the optimizer's buffers and count (a state
        without an optimizer, iVON's, lists its own)."""
        if self.opt_state is None:
            return _module_tensors(self.params)
        optimizer = self.opt_state[0]
        if not hasattr(optimizer, "tensors"):
            raise TypeError(
                f"capturing a step needs an optimizer whose state exists before its first step "
                f"(utils.optim.SGD), not {type(optimizer).__name__}"
            )
        return _module_tensors(self.params) + list(optimizer.tensors())

    def state_dict(self) -> dict:
        """``params.*`` (the module's parameters and buffers), ``opt.*`` (the
        optimizer's, where there is one), ``step`` and ``epoch``: the live
        tensors, not copies."""
        out = {f"params.{k}": v for k, v in self.params.state_dict().items()}
        if self.opt_state is not None:
            out.update({f"opt.{k}": v for k, v in self.opt_state[0].state_dict().items()})
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        out["epoch"] = torch.as_tensor(self.epoch).to(torch.int64)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Copies ``state`` (a :meth:`state_dict`, on any device) into this
        state's tensors in place, so that the optimizer's views and a
        captured graph's addresses stay valid; the keys must match."""
        mine = self.state_dict()
        if mine.keys() != state.keys():
            raise KeyError(f"state keys differ: {sorted(mine.keys() ^ state.keys())}")
        self.params.load_state_dict(
            {k[len("params."):]: v for k, v in state.items() if k.startswith("params.")}, strict=True)
        if self.opt_state is not None:
            self.opt_state[0].load_state_dict({k[len("opt."):]: v for k, v in state.items() if k.startswith("opt.")})
        self.step = int(state["step"])
        if isinstance(self.epoch, torch.Tensor):
            with torch.no_grad():
                self.epoch.copy_(state["epoch"])
        else:
            self.epoch = int(state["epoch"])


def _module_tensors(module: nn.Module) -> list:
    """A module's parameters and buffers (what its forward and an update
    write)."""
    return [p.detach() for p in module.parameters()] + list(module.buffers())


@dataclasses.dataclass(frozen=True)
class PosteriorMethod:
    """A Bayesian training/prediction algorithm.

    init(params, model_state) -> state
    update(state, noise, batch) -> (state, metrics); ``metrics['loss']`` is
        the pre-update minibatch loss.
    sample(state, noise, index) -> (params, model_state) for one prediction;
        methods whose models sample in the forward (BBB) return the live
        params and set ``sample_is_identity``.
    finalize_epoch(state) -> state at an epoch boundary.
    """

    init: Callable[..., MethodState]
    update: Callable[..., tuple]
    sample: Callable[..., tuple]
    finalize_epoch: Callable[[MethodState], MethodState] = lambda s: s
    sample_is_identity: bool = False
    multisample: bool = False


def default_finalize_epoch(state: MethodState) -> MethodState:
    state.epoch += 1
    return state


# ---------------------------------------------------------------------------
# Priors (reference src/algos/bbb.py:9-37)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GaussianPrior:
    """N(mu, sigma) prior with the reference's closed-form KL(q||p)."""

    mu: float = 0.0
    sigma: float = 1.0

    def log_prob(self, x):
        return (
            -((x - self.mu) ** 2) / (2 * self.sigma**2)
            - math.log(self.sigma)
            - 0.5 * math.log(2 * math.pi)
        )

    def kl_divergence(self, mu_q, sigma_q):
        return gaussian_kl(mu_q, sigma_q, self.mu, self.sigma)


@dataclasses.dataclass(frozen=True)
class MixturePrior:
    """Blundell scale-mixture prior. ``kl_divergence`` is the reference's
    surrogate -log p(mu_q), ignoring sigma_q, with per-component log-probs
    clamped to [-23, 0] (reference bbb.py:32-37)."""

    pi: float = 0.5
    sigma1: float = 1.0
    sigma2: float = 0.01

    def log_prob(self, value):
        def comp(sigma):
            lp = (
                -(value**2) / (2 * sigma**2)
                - math.log(sigma)
                - 0.5 * math.log(2 * math.pi)
            )
            return torch.clamp(lp, -23.0, 0.0)

        prob1 = math.log(self.pi) + comp(self.sigma1)
        prob2 = math.log(1 - self.pi) + comp(self.sigma2)
        return torch.logaddexp(prob1, prob2)

    def kl_divergence(self, mu_q, sigma_q):
        del sigma_q
        return -torch.sum(self.log_prob(mu_q))


def to_sigma(rho):
    """std = softplus(rho) (reference bbb_layers.py:262-263)."""
    return F.softplus(rho)


def softplus_inverse(x):
    return torch.log(torch.expm1(x))


def gaussian_kl(mu_q, sig_q, mu_p, sig_p):
    """Closed-form KL(q || p) between diagonal Gaussians, summed
    (reference bbb_layers.py:274-276). ``mu_p``/``sig_p`` may be floats."""
    kl = 0.5 * (
        2 * torch.log(sig_p / sig_q)
        - 1
        + (sig_q / sig_p) ** 2
        + ((mu_p - mu_q) / sig_p) ** 2
    )
    return torch.sum(kl)


# ---------------------------------------------------------------------------
# Parameter partitioning by naming convention
# ---------------------------------------------------------------------------


def _label(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith(GMEAN_SUFFIX):
        return "gmean"
    if leaf.endswith(GRHO_SUFFIX):
        return "grho"
    if leaf.endswith(MLE_SUFFIX):
        return "mle"
    return "plain"


def split_gaussian_labels(params: Params) -> dict:
    """Label every parameter 'gmean' / 'grho' / 'mle' / 'plain' by name."""
    return {name: _label(name) for name in _named(params)}


def collect_gaussian_kl(params: Params, prior) -> torch.Tensor:
    """Sum of closed-form KL(q||prior) over every ``__gmean``/``__grho``
    pair (reference bbb.py:70-76 KL collection)."""
    named = _named(params)
    pairs = {}
    for name, leaf in named.items():
        label = _label(name)
        if label == "gmean":
            pairs.setdefault(name[: -len(GMEAN_SUFFIX)], {})["mean"] = leaf
        elif label == "grho":
            pairs.setdefault(name[: -len(GRHO_SUFFIX)], {})["rho"] = leaf
    device = next(iter(named.values())).device if named else None
    kl = torch.zeros((), dtype=torch.float32, device=device)
    for pair in pairs.values():
        if "mean" in pair and "rho" in pair:
            kl = kl + prior.kl_divergence(pair["mean"], to_sigma(pair["rho"]))
    return kl


def l2_of_plain_params(params: Params) -> torch.Tensor:
    """0.5 * sum of squares over non-Gaussian, non-MLE parameters
    (reference bbb.py:75-76)."""
    named = _named(params)
    device = next(iter(named.values())).device if named else None
    total = torch.zeros((), dtype=torch.float32, device=device)
    for name, leaf in named.items():
        if _label(name) == "plain":
            total = total + 0.5 * torch.sum(leaf.float() ** 2)
    return total


def non_mle_mask(params: Params) -> dict:
    """True for parameters that take part in parameter-space VI/SVGD
    (reference util.py:188-189 non_mle_params)."""
    return {name: lab != "mle" for name, lab in split_gaussian_labels(params).items()}
