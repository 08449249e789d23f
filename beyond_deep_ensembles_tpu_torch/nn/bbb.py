"""Bayes-by-Backprop layers with local reparameterization.

Counterpart of ``beyond_deep_ensembles_tpu/nn/bbb.py`` (``sampling=
"activations"``; the ``"parameters"`` mode and ``LowRankBBBDense`` are not
ported yet). The layer computes the mean plane ``x * W_mean`` and the
variance plane ``max(x^2, 1e-4) * max(W_std^2, 1e-4)`` without bias, then
hands both, with the bias mean and variance, to the K1 epilogue
(``ops/sampling.py``) through the forward's :class:`NoiseSource`. The 1e-4
floors follow the reference (bbb_layers.py:65-67,73): the dense bias
variance is clamped, the conv bias variance is not.

Like the JAX layers these sow no KL: the BBB method collects it from the
``__gmean``/``__grho`` parameters.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from .convops import Padding, conv2d
from .gaussian import NoiseSource, gaussian_mean_std, gaussian_param

VAR_CLAMP = 1e-4


def _check_sampling(sampling: str) -> None:
    if sampling != "activations":
        raise NotImplementedError(f"sampling={sampling!r}: not ported yet")


class BBBDense(nn.Module):
    """Variational dense layer (reference BBBLinear, bbb_layers.py:10-102);
    kernel ``[features, in_features]``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        use_bias: bool = True,
        sampling: str = "activations",
        freeze_on_eval: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        _check_sampling(sampling)
        self.use_bias = use_bias
        self.freeze_on_eval = freeze_on_eval
        gaussian_param(self, "kernel", (features, in_features), generator)
        if use_bias:
            gaussian_param(self, "bias", (features,), generator)

    def forward(self, x, noise: NoiseSource, train: bool = True):
        w_mean, w_std = gaussian_mean_std(self, "kernel")
        act_mean = x @ w_mean.T
        act_var = torch.clamp(x * x, min=VAR_CLAMP) @ torch.clamp(w_std * w_std, min=VAR_CLAMP).T
        b_mean = b_var = None
        if self.use_bias:
            b_mean, b_std = gaussian_mean_std(self, "bias")
            b_var = torch.clamp(b_std * b_std, min=VAR_CLAMP)
        return noise.gaussian(act_mean, act_var, b_mean, b_var, train, self.freeze_on_eval)


class BBBConv(nn.Module):
    """Variational conv layer (reference BBBConv2d, bbb_layers.py:105-163);
    NCHW input, kernel ``[features, in_features, kh, kw]``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: Union[int, Sequence[int]] = 1,
        padding: Padding = 0,
        use_bias: bool = True,
        sampling: str = "activations",
        freeze_on_eval: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        _check_sampling(sampling)
        kh, kw = kernel_size
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self.use_bias = use_bias
        self.freeze_on_eval = freeze_on_eval
        gaussian_param(self, "kernel", (features, in_features, kh, kw), generator)
        if use_bias:
            gaussian_param(self, "bias", (features,), generator)

    def forward(self, x, noise: NoiseSource, train: bool = True):
        w_mean, w_std = gaussian_mean_std(self, "kernel")
        act_mean = conv2d(x, w_mean, self.strides, self.padding)
        act_var = conv2d(
            torch.clamp(x * x, min=VAR_CLAMP),
            torch.clamp(w_std * w_std, min=VAR_CLAMP),
            self.strides,
            self.padding,
        )
        b_mean = b_var = None
        if self.use_bias:
            b_mean, b_std = gaussian_mean_std(self, "bias")
            b_var = b_std * b_std  # the reference does not clamp conv bias variance
        return noise.gaussian(act_mean, act_var, b_mean, b_var, train, self.freeze_on_eval)
