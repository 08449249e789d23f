"""The UCI regression MLP: in -> 50 -> ReLU -> 1 -> GaussLayer.

Counterpart of ``beyond_deep_ensembles_tpu/models/mlp.py`` (reference
experiments/uci/models.py:43-51). The dense layers come from
``models/layers.py::make_dense`` (``plain``, ``bbb`` or ``rank1`` with
``components``), with ``FixableDropout(dropout_p)`` after the hidden layer
when ``dropout_p`` > 0 (MC-Dropout). Submodules carry flax's names
(``Dense_0``, ``Dense_1`` or ``BBBDense_k`` / ``Rank1Dense_k``,
``FixableDropout_0``, ``GaussLayer_0``): the last-layer Laplace picks the
highest ``Dense_k`` by name, and ``models/jax_convert.py`` maps by name.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.base import add_auto_named
from ..nn.dropout import FixableDropout
from ..nn.gauss import GaussLayer
from ..nn.rank1 import Component
from .layers import call_layer, make_dense


class RegressionMLP(nn.Module):
    """Output ``[B, out_dim, 2]``: (mean, std) per output."""

    def __init__(
        self,
        in_dim: int,
        hidden: int = 50,
        out_dim: int = 1,
        dense_kind: str = "plain",
        dropout_p: float = 0.0,
        components: int = 1,
        std_init: float = 1.0,
        learn_var: bool = False,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        # a tuple, so that the layers stay registered under their flax names only
        self._layers = (
            add_auto_named(self, make_dense(dense_kind, in_dim, hidden, components=components, generator=generator)),
            add_auto_named(self, FixableDropout(dropout_p)) if dropout_p > 0 else None,
            add_auto_named(self, make_dense(dense_kind, hidden, out_dim, components=components, generator=generator)),
            add_auto_named(self, GaussLayer(std_init, learn_var)),
        )

    def forward(self, x, noise=None, train: bool = True, component: Component = None):
        hidden, dropout, out, gauss = self._layers
        h = call_layer(hidden, x, noise, train, component)
        if dropout is not None:
            h = dropout(h, noise, train=train)
        h = call_layer(out, torch.relu(h), noise, train, component)
        return gauss(h, noise, train=train)
