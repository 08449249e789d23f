"""IMDB CNN-LSTM (the bnn-hmc model zoo).

Counterpart of ``beyond_deep_ensembles_tpu/models/cnn_lstm.py`` (reference
make_cnn_lstm / make_smooth_cnn_lstm, google-bnn-hmc/bnn_hmc/utils/
models.py:199-259): Embed(20000, 128) -> Conv1D(64, k5, VALID) -> relu or
swish -> [max-pool 4] -> LSTM(128) over time -> last hidden ->
Dense(classes).

The 1-D convolution is ``nn/plain.py``'s ``Conv`` with a ``(1, k)`` kernel
over ``[B, E, 1, T]``. The LSTM is ``torch.lstm`` (cuDNN's on a card) over
one ``[4H, F]`` input kernel, one ``[4H, H]`` recurrent kernel and one
``[4H]`` bias, gates stacked in torch's order (i, f, g, o); flax's
``OptimizedLSTMCell`` keeps one dense a gate, ``ii/if/ig/io`` without bias
and ``hi/hf/hg/ho`` with one, and ``models/jax_convert.py::
cnn_lstm_from_jax`` stacks them. torch's second bias (``b_ih``) is a zero
constant, not a parameter, so the parameter count is the JAX model's. The
initial carry is zero, as flax's ``nn.RNN`` starts it. Submodules carry
flax's names (``Embed_0``, ``Conv_0``, ``OptimizedLSTMCell_0``,
``Dense_0``).
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import add_auto_named
from ..nn.plain import Conv, Dense, lecun_normal_
from .bert import Embed


class OptimizedLSTMCell(nn.Module):
    """One LSTM layer run over a whole sequence: ``[B, T, F]`` -> the
    hidden states ``[B, T, H]``. Init as flax's cell: lecun-normal input
    kernels, orthogonal recurrent kernels (one a gate), zero biases."""

    def __init__(self, in_features: int, features: int, *, generator: torch.Generator):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * features, in_features))
        lecun_normal_(self.weight_ih, in_features, generator)
        self.weight_hh = nn.Parameter(torch.empty(4 * features, features))
        with torch.no_grad():
            for gate in self.weight_hh.split(features):
                nn.init.orthogonal_(gate, generator=generator)
        self.bias = nn.Parameter(torch.zeros(4 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x.new_zeros((1, x.shape[0], self.weight_hh.shape[1]))
        params = [self.weight_ih, self.weight_hh, torch.zeros_like(self.bias), self.bias]
        with warnings.catch_warnings():
            # cuDNN compacts separately held weights at each call
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            out, _, _ = torch.lstm(x, (h0, h0), params, True, 1, 0.0, torch.is_grad_enabled(), False, True)
        return out


class CNNLSTM(nn.Module):
    """``forward(tokens [B, T])`` -> logits ``[B, classes]``."""

    def __init__(
        self,
        classes: int = 2,
        max_features: int = 20000,
        embedding_size: int = 128,
        cell_size: int = 128,
        num_filters: int = 64,
        kernel_size: int = 5,
        pool_size: int = 4,
        use_swish: bool = False,
        use_maxpool: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.use_swish, self.use_maxpool, self.pool_size = use_swish, use_maxpool, pool_size
        embed = add_auto_named(self, Embed(max_features, embedding_size, generator=generator))
        conv = add_auto_named(self, Conv(embedding_size, num_filters, (1, kernel_size), padding="VALID",
                                         generator=generator))
        cell = add_auto_named(self, OptimizedLSTMCell(num_filters, cell_size, generator=generator))
        head = add_auto_named(self, Dense(cell_size, classes, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (embed, conv, cell, head)

    def forward(self, tokens, noise=None, train: bool = True):
        del noise, train
        embed, conv, cell, head = self._layers
        x = embed(tokens).transpose(1, 2)[:, :, None, :]  # [B, E, 1, T]
        x = conv(x)
        x = F.silu(x) if self.use_swish else F.relu(x)
        if self.use_maxpool:
            x = F.max_pool2d(x, (1, self.pool_size), (1, self.pool_size))
        h = cell(x[:, :, 0, :].transpose(1, 2))  # [B, T', H]
        return head(h[:, -1])


def smooth_cnn_lstm(classes: int = 2, *, generator: torch.Generator, **kw) -> CNNLSTM:
    """The swish / no-maxpool variant HMC chains use (reference
    models.py:242-259)."""
    return CNNLSTM(classes=classes, use_swish=True, use_maxpool=False, generator=generator, **kw)
