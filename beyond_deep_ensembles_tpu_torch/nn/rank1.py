"""Rank-1 variational layers (https://arxiv.org/abs/2005.07186).

Counterpart of ``beyond_deep_ensembles_tpu/nn/rank1.py`` (reference
src/algos/rank1.py): a shared deterministic kernel with per-component rank-1
multiplicative Gaussian factors ``s`` (input side, ``[C, in]``) and ``r``
(output side, ``[C, out]``), each a ``__gmean``/``__grho`` pair with the +-1
mean init, and a per-component deterministic bias ``[C, out]``:

    out = ((x * s) (*) W) * r + bias[c]

One draw of ``s`` and one of ``r`` per forward, shared by the batch (not per
example), from the forward's :class:`~.gaussian.NoiseSource`, ``s`` first.
The BBB method collects the factors' closed-form KL over every component.

The active component ``c`` is an explicit argument: a Python int (the
component of an eval sample) or a 0-dim int64 tensor on the device (a train
step's, computed from a device counter, so that a captured step moves on at
every replay); it is selected by ``index_select``, never read on the host.
With one component it defaults to 0. The JAX layer draws a uniform component
when none is given and ``C > 1``; here that raises, since every caller on
the ported paths (``methods/bbb.py``, ``methods/ensemble.py::predict``)
passes one.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from .convops import Padding, conv2d
from .gaussian import NoiseSource, gaussian_mean_std, gaussian_param, sign_mean_init
from .plain import lecun_normal_

Component = Optional[Union[int, torch.Tensor]]


def take_component(arr: torch.Tensor, component: Union[int, torch.Tensor]) -> torch.Tensor:
    """Row ``component`` of ``arr`` (components on axis 0)."""
    if isinstance(component, torch.Tensor):
        return torch.index_select(arr, 0, component.reshape(1).to(torch.int64))[0]
    return arr[component]


def _resolve_component(component: Component, components: int):
    if component is not None:
        return component
    if components == 1:
        return 0
    raise ValueError(f"a mixture of {components} components needs an explicit component")


def _uniform_bias(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


class _Rank1(nn.Module):
    def _factors(self, in_features: int, features: int, generator: torch.Generator) -> None:
        gaussian_param(self, "s", (self.components, in_features), generator, mean_init=sign_mean_init)
        gaussian_param(self, "r", (self.components, features), generator, mean_init=sign_mean_init)

    def _sample(self, name: str, component, noise: NoiseSource) -> torch.Tensor:
        mean, std = gaussian_mean_std(self, name)
        m, s = take_component(mean, component), take_component(std, component)
        return m + s * noise.normal(tuple(m.shape), m.device, True, False)


class Rank1Dense(_Rank1):
    """Reference Rank1Linear (rank1.py:9-64); kernel ``[features,
    in_features]`` (lecun-normal), bias ``[C, features]`` uniform in
    +-1/sqrt(in_features)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        components: int = 1,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.components = components
        self._factors(in_features, features, generator)
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        lecun_normal_(self.kernel, in_features, generator)
        self.bias = nn.Parameter(_uniform_bias((components, features), in_features, generator)) if use_bias else None

    def forward(self, x, noise: NoiseSource, train: bool = True, component: Component = None):
        del train
        component = _resolve_component(component, self.components)
        s = self._sample("s", component, noise)
        r = self._sample("r", component, noise)
        out = ((x * s) @ self.kernel.T) * r
        if self.bias is not None:
            out = out + take_component(self.bias, component)
        return out


class Rank1Conv(_Rank1):
    """Reference Rank1Conv2D (rank1.py:66-125); NCHW input, kernel OIHW
    (lecun-normal at fan-in ``I * kh * kw``), bias ``[C, features]`` uniform in
    +-1/sqrt(fan-in)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: Union[int, Sequence[int]] = 1,
        padding: Padding = 0,
        components: int = 1,
        use_bias: bool = True,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        kh, kw = kernel_size
        self.components = components
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self._factors(in_features, features, generator)
        self.kernel = nn.Parameter(torch.empty(features, in_features, kh, kw))
        fan_in = in_features * kh * kw
        lecun_normal_(self.kernel, fan_in, generator)
        self.bias = nn.Parameter(_uniform_bias((components, features), fan_in, generator)) if use_bias else None

    def forward(self, x, noise: NoiseSource, train: bool = True, component: Component = None):
        del train
        component = _resolve_component(component, self.components)
        s = self._sample("s", component, noise)
        r = self._sample("r", component, noise)
        out = conv2d(x * s[:, None, None], self.kernel, self.strides, self.padding) * r[:, None, None]
        if self.bias is not None:
            out = out + take_component(self.bias, component)[:, None, None]
        return out
