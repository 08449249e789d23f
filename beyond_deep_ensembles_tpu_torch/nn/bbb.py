"""Bayes-by-Backprop layers with local reparameterization.

Counterpart of ``beyond_deep_ensembles_tpu/nn/bbb.py``. With ``sampling=
"activations"`` (local reparameterization) the layer computes the mean
plane ``x * W_mean`` and the variance plane ``max(x^2, 1e-4) * max(W_std^2,
1e-4)`` without bias, then hands both, with the bias mean and variance, to
the K1 epilogue (``ops/sampling.py``) through the forward's
:class:`NoiseSource`. The 1e-4 floors follow the reference
(bbb_layers.py:65-67,73): the dense bias variance is clamped, the conv bias
variance is not. With ``sampling="parameters"`` it draws the kernel and the
bias, ``mean + std * z`` with a fresh z at train and at eval
(``freeze_on_eval`` shapes the activations path only), through K1 as well
(``NoiseSource.parameter``: K1 with var = std^2, so key mode and CUDA-graph
capture hold), and runs one product.

:class:`LowRankBBBDense` (reference LowRankBBBLinear) has a low-rank plus
diagonal covariance over its flat ``(in + 1) * out`` weights; it records
its KL in the forward (``nn/base.py::sow_kl``), which ``Model.apply``
returns and the BBB method adds to the Gaussian KL.

``dtype`` is the JAX layers' compute dtype (``nn/bbb.py:47``, ``:116``):
the input and the kernels' mean and variance are cast to it, and in bf16 the
planes stay bf16 end to end (the JAX ``acc_t``), as do the bias vectors K1
reads; K1 adds, draws and rounds once. Without one the layer computes in
the promoted type of its input and parameters (fp32 for a bf16 input, as the
JAX layers' fp32 default casts it).

Like the JAX layers ``BBBDense`` and ``BBBConv`` sow no KL: the BBB
method collects it from the ``__gmean``/``__grho`` parameters.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .base import sow_kl
from .convops import Padding, conv2d
from .gaussian import NoiseSource, blundell_mean_init, gaussian_mean_std, gaussian_param
from .plain import promote_dtype

VAR_CLAMP = 1e-4
SAMPLING_MODES = ("activations", "parameters")


def _check_sampling(sampling: str) -> None:
    if sampling not in SAMPLING_MODES:
        raise ValueError(f"invalid sampling mode {sampling!r}")


def _draw(module: nn.Module, name: str, noise: NoiseSource) -> torch.Tensor:
    """One draw of the Gaussian parameter ``name`` (``sampling="parameters"``)."""
    mean, std = gaussian_mean_std(module, name)
    return noise.parameter(mean, std * std)


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
        dtype=None,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        _check_sampling(sampling)
        self.sampling = sampling
        self.use_bias = use_bias
        self.freeze_on_eval = freeze_on_eval
        self.dtype = dtype
        gaussian_param(self, "kernel", (features, in_features), generator)
        if use_bias:
            gaussian_param(self, "bias", (features,), generator)

    def forward(self, x, noise: NoiseSource, train: bool = True):
        w_mean, w_std = gaussian_mean_std(self, "kernel")
        dt = promote_dtype(x, w_mean, dtype=self.dtype)
        x = x.to(dt)
        if self.sampling == "parameters":
            out = x @ _draw(self, "kernel", noise).to(dt).T
            return out + _draw(self, "bias", noise).to(dt) if self.use_bias else out
        act_mean = x @ w_mean.to(dt).T
        act_var = torch.clamp(x * x, min=VAR_CLAMP) @ torch.clamp(w_std * w_std, min=VAR_CLAMP).to(dt).T
        b_mean = b_var = None
        if self.use_bias:
            b_mean, b_std = gaussian_mean_std(self, "bias")
            b_mean, b_var = b_mean.to(dt), torch.clamp(b_std * b_std, min=VAR_CLAMP).to(dt)
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
        dtype=None,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        _check_sampling(sampling)
        self.sampling = sampling
        self.dtype = dtype
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
        dt = promote_dtype(x, w_mean, dtype=self.dtype)
        x = x.to(dt)
        if self.sampling == "parameters":
            out = conv2d(x, _draw(self, "kernel", noise), self.strides, self.padding, dtype=dt)
            if self.use_bias:
                out = out + _draw(self, "bias", noise).to(dt)[:, None, None]
            return out
        act_mean = conv2d(x, w_mean, self.strides, self.padding, dtype=dt)
        act_var = conv2d(
            torch.clamp(x * x, min=VAR_CLAMP),
            torch.clamp(w_std * w_std, min=VAR_CLAMP),
            self.strides,
            self.padding,
            dtype=dt,
        )
        b_mean = b_var = None
        if self.use_bias:
            b_mean, b_std = gaussian_mean_std(self, "bias")
            # the reference does not clamp conv bias variance
            b_mean, b_var = b_mean.to(dt), (b_std * b_std).to(dt)
        return noise.gaussian(act_mean, act_var, b_mean, b_var, train, self.freeze_on_eval)


class LowRankBBBDense(nn.Module):
    """Low-rank plus diagonal covariance variational dense layer (reference
    LowRankBBBLinear, bbb_layers.py:165-260; JAX :173-240). Its parameters
    are flat over the ``(in + 1) * out`` weights (the bias as the last input
    row, in JAX's ``[in + 1, out]`` order): ``param_mean`` (N(0, 0.01)),
    ``param_diag_rho`` (``rho_init``) and ``rank`` low-rank factors
    ``param_lr_vars`` (``offdiag_init``). The output is ``a_mean +
    a_diag_std * e + rank^-1/2 sum_k a_k * e_k`` with ``a_k`` the input
    through factor k, ``e`` per element and ``e_k`` per example and factor;
    at eval under ``freeze_on_eval`` one ``e`` row and one ``e_k`` for the
    batch. In training (or with ``kl_on_eval``) it records the KL against
    N(0, gamma) in the capacitance form (:func:`sow_kl`)."""

    def __init__(self, in_features: int, features: int, rank: int, gamma: float = 1.0, rho_init: float = -3.0,
                 offdiag_init: float = 0.0, freeze_on_eval: bool = True, kl_on_eval: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.in_features, self.features, self.rank = in_features, features, rank
        self.gamma, self.freeze_on_eval, self.kl_on_eval = gamma, freeze_on_eval, kl_on_eval
        n_params = (in_features + 1) * features
        self.param_mean = nn.Parameter(blundell_mean_init()((n_params,), generator))
        self.param_diag_rho = nn.Parameter(torch.full((n_params,), float(rho_init)))
        self.param_lr_vars = nn.Parameter(torch.full((rank, n_params), float(offdiag_init)))

    def forward(self, x, noise: NoiseSource, train: bool = True):
        k, batch = self.rank, x.shape[0]
        alpha = 1.0 / math.sqrt(k) if k != 0 else 1.0
        shape = (self.in_features + 1, self.features)
        pad = torch.cat([x, torch.ones((batch, 1), dtype=x.dtype, device=x.device)], dim=-1)
        diag_sig = F.softplus(self.param_diag_rho)
        act_mean = pad @ self.param_mean.reshape(shape)
        act_diag_std = torch.sqrt(torch.clamp((pad * pad) @ (diag_sig * diag_sig).reshape(shape), min=0.0))
        act_lr = torch.einsum("bi,kio->kbo", pad, self.param_lr_vars.reshape((k,) + shape))
        frozen = not train and self.freeze_on_eval
        eps_diag = noise.normal(act_mean.shape, x.device, train, self.freeze_on_eval, batch_axis=0)
        eps_lr = noise.normal((k, 1, 1) if frozen else (k, batch, 1), x.device, True, False,
                              batch_axis=None if frozen else 1)
        out = act_mean + act_diag_std * eps_diag + alpha * torch.sum(act_lr * eps_lr, dim=0)
        if train or self.kl_on_eval:
            lr_vars = self.param_lr_vars
            capacitance = torch.eye(k, dtype=lr_vars.dtype, device=lr_vars.device) + (lr_vars / diag_sig[None, :]) @ lr_vars.T
            n_params = self.param_mean.numel()
            kl = 0.5 * (
                torch.sum(diag_sig / self.gamma - torch.log(diag_sig))
                + alpha / self.gamma * torch.sum(torch.sum(lr_vars**2, dim=1))
                - torch.linalg.slogdet(capacitance)[1]
                + torch.sum(self.param_mean**2) / self.gamma
                + n_params * (math.log(self.gamma) - 1.0)
            )
            sow_kl(self, kl)
        return out
