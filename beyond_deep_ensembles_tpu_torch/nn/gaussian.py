"""Gaussian variational parameters and the noise every stochastic layer draws.

Counterpart of ``beyond_deep_ensembles_tpu/nn/gaussian.py``. A parameter
``w`` becomes two ``nn.Parameter``s ``w__gmean`` and ``w__grho`` with
std = softplus(rho); methods discover them by suffix (``methods/api.py``).

The JAX layers draw their noise from flax RNG streams (``eval_noise``). Here
each forward takes one :class:`NoiseSource`, passed down to every
``BBBConv``/``BBBDense``/``VariationalFilterResponseNorm``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..methods.api import GMEAN_SUFFIX, GRHO_SUFFIX
from ..ops.sampling import gaussian_sample

RHO_INIT = -3.0  # Blundell init (reference util.py:161-163)
MEAN_STD_INIT = 0.1


def gaussian_param(
    module: nn.Module,
    name: str,
    shape: Sequence[int],
    generator: torch.Generator,
    mean_init: Optional[float] = None,
    rho_init: float = RHO_INIT,
) -> None:
    """Register ``{name}__gmean`` and ``{name}__grho`` on ``module``. The mean
    is N(0, 0.1) from ``generator``, or the constant ``mean_init``; rho is
    ``rho_init``."""
    if mean_init is None:
        mean = MEAN_STD_INIT * torch.randn(tuple(shape), generator=generator)
    else:
        mean = torch.full(tuple(shape), float(mean_init))
    module.register_parameter(name + GMEAN_SUFFIX, nn.Parameter(mean))
    module.register_parameter(
        name + GRHO_SUFFIX, nn.Parameter(torch.full(tuple(shape), float(rho_init)))
    )


def gaussian_mean_std(module: nn.Module, name: str):
    """(mean, std) of the Gaussian parameter ``name`` of ``module``."""
    mean = getattr(module, name + GMEAN_SUFFIX)
    return mean, F.softplus(getattr(module, name + GRHO_SUFFIX))


class NoiseSource:
    """The standard-normal noise of one or more forwards.

    Generator mode (``generator``, a CPU ``torch.Generator``): every BBB
    epilogue takes a fresh 62-bit Philox seed from it. On CUDA the K1 kernel
    draws its noise in-kernel from that seed; on the CPU the plain version
    seeds ``torch.randn`` with it. The per-example draws of
    ``VariationalFilterResponseNorm`` use ``torch.randn`` with a generator on
    the layer's device, seeded once from ``generator``.

    Given mode (``given``, a sequence of tensors): draws are handed out in
    call order, so a test can feed the JAX package's noise to the port. A
    frozen-eval draw is one per-example tensor (the shape without batch).

    At eval with ``freeze_on_eval`` one noise row is broadcast over the
    batch (reference bbb_layers.py:76-78), so one posterior sample behaves
    like one fixed network.
    """

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        given: Optional[Sequence[torch.Tensor]] = None,
    ):
        if (generator is None) == (given is None):
            raise ValueError("pass exactly one of generator= and given=")
        self.generator = generator
        self._given = None if given is None else list(given)
        self.draws = 0
        self._device_generators = {}

    @classmethod
    def seeded(cls, seed: int) -> "NoiseSource":
        return cls(generator=torch.Generator().manual_seed(seed))

    def _take(self, shape) -> torch.Tensor:
        if self.draws >= len(self._given):
            raise IndexError(f"given noise exhausted after {self.draws} draws")
        eps = self._given[self.draws]
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(
                f"given noise draw {self.draws} has shape {tuple(eps.shape)}, "
                f"the layer asks for {tuple(shape)}"
            )
        self.draws += 1
        return eps

    def seed(self) -> int:
        """A fresh Philox seed for one kernel launch."""
        return int(torch.randint(0, 2**62, (1,), generator=self.generator))

    def _device_generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        gen = self._device_generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.seed())
            self._device_generators[key] = gen
        return gen

    def normal(self, shape, device, train: bool, freeze_on_eval: bool) -> torch.Tensor:
        """N(0, 1) of ``shape`` (batch first), one row broadcast over the
        batch at frozen eval."""
        frozen = not train and freeze_on_eval
        draw_shape = tuple(shape[1:]) if frozen else tuple(shape)
        if self._given is not None:
            eps = self._take(draw_shape).to(device)
        else:
            eps = torch.randn(
                draw_shape, generator=self._device_generator(device), device=device
            )
            self.draws += 1
        return eps.expand(tuple(shape)) if frozen else eps

    def gaussian(self, act_mean, act_var, b_mean, b_var, train: bool, freeze_on_eval: bool):
        """The local-reparameterization epilogue of a BBB layer through K1:
        ``(act_mean + b_mean) + sqrt(act_var + b_var) * eps``."""
        frozen = not train and freeze_on_eval
        if self._given is not None:
            shape = act_mean.shape[1:] if frozen else act_mean.shape
            eps = self._take(shape).to(device=act_mean.device, dtype=act_mean.dtype)
            return gaussian_sample(act_mean, act_var, b_mean, b_var, eps=eps.contiguous())
        self.draws += 1
        return gaussian_sample(act_mean, act_var, b_mean, b_var, seed=self.seed(), frozen=frozen)
