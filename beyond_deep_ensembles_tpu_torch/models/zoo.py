"""The bnn-hmc model zoo registry.

Counterpart of ``beyond_deep_ensembles_tpu/models/zoo.py`` (reference
get_model, google-bnn-hmc/bnn_hmc/utils/models.py:293-318): the names the
HMC / SG-MCMC / MFVI entry points accept, each a module in the port's
``Model`` calling convention. A flax module sizes its layers at its first
call; a torch module at construction, so ``get_model`` takes the shape of
one example, ``in_shape``, in the JAX package's layout (``(H, W, C)`` for
images, ``(D,)`` for vectors, ``(T,)`` for token ids), and the generator the
weights are drawn from.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import Model, add_auto_named
from ..nn.plain import Dense
from .cnn_lstm import CNNLSTM, smooth_cnn_lstm
from .lenet import LeNet5, flatten_nhwc
from .resnet import WilsonResNet20


class MLP(nn.Module):
    """Plain flatten -> Dense stack (reference make_mlp, models.py:262-283):
    relu after each of ``layer_dims``, then ``Dense(out_dim)``; the
    regression variants emit 2 channels, the mean and the pre-softplus std
    of ``evals/losses.py::heteroscedastic_gaussian_ll``. Images flatten in
    NHWC order, as the JAX model flattens them."""

    def __init__(self, in_dim: int, layer_dims: Sequence[int] = (100, 100), out_dim: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        dims, layers = [in_dim, *layer_dims], []
        for cin, cout in zip(dims[:-1], dims[1:]):
            layers.append(add_auto_named(self, Dense(cin, cout, generator=generator)))
        head = add_auto_named(self, Dense(dims[-1], out_dim, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (tuple(layers), head)

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        hidden, head = self._layers
        x = flatten_nhwc(x)
        for layer in hidden:
            x = F.relu(layer(x))
        return head(x)


_DEFAULT_SHAPES = {"lenet": (28, 28, 1), "resnet20_frn": (32, 32, 3), "resnet20_frn_swish": (32, 32, 3)}


def get_model(name: str, num_classes: int = 10, in_shape: Optional[Sequence[int]] = None,
              generator: Optional[torch.Generator] = None, **kw) -> Model:
    """The JAX registry's nine names (models.py:293-318); ``kw`` goes to the
    ResNet and the CNN-LSTMs, as in JAX. ``in_shape`` defaults to 28x28x1
    for LeNet-5 and 32x32x3 for the ResNets; the MLPs need it."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    shape = tuple(in_shape) if in_shape is not None else _DEFAULT_SHAPES.get(name)

    def mlp(layer_dims, out_dim):
        def build():
            if shape is None:
                raise ValueError(f"model {name!r} needs in_shape, the shape of one example")
            return MLP(math.prod(shape), layer_dims, out_dim, generator=generator)

        return build

    builders = {
        "lenet": lambda: LeNet5(num_classes, in_channels=shape[-1], image_size=shape[0], generator=generator),
        # the vendored make_resnet_fn arch (initial FRN, normalized biased
        # shortcut, models.py:95-176), not the torch reference's ResNet20
        "resnet20_frn": lambda: WilsonResNet20(num_classes, activation="relu", generator=generator, **kw),
        "resnet20_frn_swish": lambda: WilsonResNet20(num_classes, activation="swish", generator=generator, **kw),
        "cnn_lstm": lambda: CNNLSTM(classes=num_classes, generator=generator, **kw),
        "smooth_cnn_lstm": lambda: smooth_cnn_lstm(classes=num_classes, generator=generator, **kw),
        "mlp_regression": mlp((100, 100), 2),
        "mlp_regression_small": mlp((50,), 2),
        "mlp_classification": mlp((256, 256), num_classes),
        "logistic_regression": mlp((), num_classes),
    }
    if name not in builders:
        raise ValueError(f"unknown model {name!r}; available: {sorted(builders)}")
    return Model(builders[name]())
