"""LeNet-5 (the bnn-hmc model zoo).

Counterpart of ``beyond_deep_ensembles_tpu/models/lenet.py`` (reference
make_lenet5_fn, google-bnn-hmc/bnn_hmc/utils/models.py:46-69), in NCHW:
three SAME 5x5 convs (6, 16, 120 channels) each followed by relu and a 3x3
stride-2 VALID max pool, then Dense 84 -> relu -> Dense ``classes``. The
features are flattened in NHWC order, as the JAX model flattens them, so
``Dense_0``'s kernel converts by a transpose alone
(``models/jax_convert.py``). A plain deterministic module: the
parameter-space methods (HMC, SG-MCMC, MFVI) sample its whole tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import add_auto_named
from ..nn.plain import Conv, Dense


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, H * W * C]`` in the JAX package's NHWC
    order; lower ranks flatten as they are."""
    if x.dim() == 4:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


class LeNet5(nn.Module):
    def __init__(self, classes: int = 10, in_channels: int = 1, image_size: int = 28, *,
                 generator: torch.Generator):
        super().__init__()
        convs, cin, size = [], in_channels, image_size
        for ch in (6, 16, 120):
            convs.append(add_auto_named(self, Conv(cin, ch, (5, 5), padding="SAME", generator=generator)))
            cin, size = ch, (size - 3) // 2 + 1
        hidden = add_auto_named(self, Dense(size * size * cin, 84, generator=generator))
        head = add_auto_named(self, Dense(84, classes, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (tuple(convs), hidden, head)

    def forward(self, x, noise=None, train: bool = True):
        del noise, train
        convs, hidden, head = self._layers
        for conv in convs:
            x = F.max_pool2d(F.relu(conv(x)), 3, 2)
        return head(F.relu(hidden(flatten_nhwc(x))))
