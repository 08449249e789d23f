"""Model wrapper standardizing the apply signature.

Counterpart of ``beyond_deep_ensembles_tpu/nn/base.py``. There ``params`` is
a pytree handed to a flax module; here it is the ``nn.Module`` that holds
the parameters, and ``Model.apply`` runs it. Submodules are registered
under flax's automatic names (``BBBConv_0``, ``BasicBlock_3``) so that a
state_dict key is the flax parameter path joined with dots.
"""
from __future__ import annotations

import torch
from torch import nn

from .gaussian import NoiseSource


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

    apply(params, model_state, noise, *inputs, train) -> (out, kl, new_model_state)

    ``params`` is the module to run (a method's live parameters). ``noise``
    feeds every stochastic layer. No layer on the ported path computes its
    own KL, so ``kl`` is zero; the methods collect the Gaussian KL from the
    parameters.
    """

    def __init__(self, module: nn.Module):
        self.module = module

    def apply(self, params: nn.Module, model_state, noise: NoiseSource, *inputs, train: bool = True):
        out = params(*inputs, noise=noise, train=train)
        kl = torch.zeros((), dtype=torch.float32, device=out.device)
        return out, kl, model_state or {}
