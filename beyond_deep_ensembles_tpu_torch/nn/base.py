"""Model wrapper standardizing the apply signature, and KL collection.

Counterpart of ``beyond_deep_ensembles_tpu/nn/base.py``. There ``params`` is
a pytree handed to a flax module; here it is the ``nn.Module`` that holds
the parameters, and ``Model.apply`` runs it. Submodules are registered
under flax's automatic names (``BBBConv_0``, ``BasicBlock_3``) so that a
state_dict key is the flax parameter path joined with dots.

A layer whose KL is not a ``__gmean``/``__grho`` pair
(``nn/bbb.py::LowRankBBBDense``) records it with :func:`sow_kl` during a
forward; ``Model.apply`` returns the sum of what its forward recorded (the
JAX ``kl_terms`` collection). A forward run outside ``Model.apply`` records
nothing, as flax's ``sow`` into a collection that is not mutable.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping

import torch
from torch import nn

from .gaussian import NoiseSource

KL_COLLECTION = "kl_terms"

# the KL terms of this thread's forwards in progress, innermost last (a
# context variable: each thread, and so each rank of a threaded world, has
# its own; a checkpoint's recompute on the autograd engine's thread records
# nothing)
_KL_FRAMES: contextvars.ContextVar = contextvars.ContextVar("kl_frames", default=())


def sow_kl(module: nn.Module, value: torch.Tensor) -> None:
    """Record ``module``'s KL contribution for the current forward (JAX
    ``sow_kl``); dropped outside :func:`collecting_kl`."""
    del module
    frames = _KL_FRAMES.get()
    if frames:
        frames[-1].append(value)


@contextlib.contextmanager
def collecting_kl():
    """Within the block :func:`sow_kl` records into the list it yields."""
    frame: list = []
    token = _KL_FRAMES.set(_KL_FRAMES.get() + (frame,))
    try:
        yield frame
    finally:
        _KL_FRAMES.reset(token)


def _sum_kl(terms: list, device) -> torch.Tensor:
    """The recorded terms' sum, an fp32 zero where there is none (JAX
    ``_sum_kl``)."""
    if not terms:
        return torch.zeros((), dtype=torch.float32, device=device)
    return sum(torch.sum(t) for t in terms)


def add_auto_named(parent: nn.Module, layer: nn.Module) -> nn.Module:
    """Register ``layer`` on ``parent`` as ``{ClassName}_{k}``, k counting the
    children of that class so far, as flax names layers made in a compact
    ``__call__``."""
    cls = type(layer).__name__
    k = sum(type(m).__name__ == cls for m in parent.children())
    parent.add_module(f"{cls}_{k}", layer)
    return layer


class Model:
    """A module plus the calling convention every method uses:

    apply(params, model_state, noise, *inputs, train, **kwargs) -> (out, kl, new_model_state)

    ``params`` is the module to run (a method's live parameters), or a
    mapping from parameter names to tensors (a SWAG draw), which runs
    through :attr:`module` by ``torch.func.functional_call``. ``noise``
    feeds every stochastic layer; ``kwargs`` go to the module's forward (a
    Rank-1 model's ``component``, an SNGP model's ``n_samples``). ``kl`` is
    the sum of what the forward's layers recorded (:func:`sow_kl`), zero
    for every layer but ``LowRankBBBDense``; the methods collect the
    Gaussian KL from the parameters. Mutable state lives in the module's
    buffers, so ``new_model_state`` is ``model_state`` as given.
    """

    def __init__(self, module: nn.Module):
        self.module = module

    def apply(self, params, model_state, noise: NoiseSource, *inputs, train: bool = True, **kwargs):
        kwargs = {"noise": noise, "train": train, **kwargs}
        with collecting_kl() as terms:
            if isinstance(params, Mapping):
                out = torch.func.functional_call(self.module, dict(params), inputs, kwargs)
            else:
                out = params(*inputs, **kwargs)
        return out, _sum_kl(terms, inputs[0].device), model_state or {}
