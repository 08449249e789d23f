"""Deterministic -> Bayesian parameter initialization.

Counterpart of ``beyond_deep_ensembles_tpu/nn/convert.py`` (reference
``make_module_bbb`` / ``make_module_rank1``, src/algos/bbb_layers.py:278-300,
rank1.py:127-149, which rewrite trained modules in place, seeding the
variational means from the trained weights). The architecture swap is the
``conv_kind`` of the model; these functions copy a trained plain model's
parameters into the Bayesian model of the same architecture, in place, on
the dotted parameter names:

  * a parameter with the same name and shape takes the plain value;
  * a ``__gmean`` parameter takes the plain parameter of its base name at the
    same path, or else the first unused plain parameter of that base name
    and shape, in the plain model's parameter order (BBB layers live in
    scopes of other names, ``BBBConv_0`` against ``Conv_0``);
  * ``__grho`` parameters keep their init (Blundell rho = -3);
  * a Rank-1 layer's ``[C, out]`` bias takes the plain ``[out]`` bias of the
    same name in every row.

This departs from the JAX rule in one place. The JAX package takes the
unused leaves in its sorted-key order, where the stem ``BBBConv_0`` sorts
before every block but ``Conv_0`` after them: on a BBB ResNet-20 the seven
16-wide conv biases shift by one layer (the stem's mean takes the first
block's bias). The port takes them in the module's order, so each layer
gets its own. Everything else matches the JAX rule. The Rank-1 case
matches by name only, as in JAX: with ResNet-20's scopes (``Rank1Conv_k``
against ``Conv_k``) only the FRN parameters carry over there. No
experiment calls these yet.
"""
from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from ..methods.api import GMEAN_SUFFIX

Source = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(source: Source) -> dict:
    return dict(source.named_parameters()) if isinstance(source, nn.Module) else dict(source)


@torch.no_grad()
def init_bbb_from_plain(bbb: nn.Module, plain: Source) -> nn.Module:
    """Copy trained plain weights into the Gaussian means of ``bbb`` (JAX
    ``init_bbb_from_plain``); returns ``bbb``."""
    plain = _named(plain)
    by_base: dict = {}
    for name, leaf in plain.items():
        by_base.setdefault(name.rsplit(".", 1)[-1], []).append(leaf)
    for name, leaf in bbb.named_parameters():
        prefix, _, last = name.rpartition(".")
        if last.endswith(GMEAN_SUFFIX):
            base = last[: -len(GMEAN_SUFFIX)]
            src = f"{prefix}.{base}" if prefix else base
            if src in plain and plain[src].shape == leaf.shape:
                leaf.copy_(plain[src])
                continue
            candidates = by_base.get(base, [])
            for i, cand in enumerate(candidates):
                if cand.shape == leaf.shape:
                    leaf.copy_(candidates.pop(i))
                    break
        elif name in plain and plain[name].shape == leaf.shape:
            leaf.copy_(plain[name])
    return bbb


@torch.no_grad()
def init_rank1_from_plain(rank1: nn.Module, plain: Source) -> nn.Module:
    """Copy trained plain weights into a Rank-1 model (JAX
    ``init_rank1_from_plain``): same-name parameters, and every component's
    bias row from the plain bias; returns ``rank1``."""
    plain = _named(plain)
    for name, leaf in rank1.named_parameters():
        if name in plain and plain[name].shape == leaf.shape:
            leaf.copy_(plain[name])
        elif name.rsplit(".", 1)[-1] == "bias" and leaf.ndim == 2 and name in plain \
                and plain[name].shape == leaf.shape[1:]:
            leaf.copy_(plain[name].expand(leaf.shape))
    return rank1
