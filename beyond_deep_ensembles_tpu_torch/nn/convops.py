"""2-D convolution with the JAX package's padding forms.

Counterpart of ``beyond_deep_ensembles_tpu/nn/convops.py``, in NCHW x OIHW.
The JAX version lowers 1x1 kernels to ``dot_general`` (``lhs[:, ::s, ::s]``
times a matrix) to dodge an XLA partitioner fault; that product is exactly
``F.conv2d`` with stride ``s`` and no padding, so every kernel size goes
through ``F.conv2d`` here.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

Padding = Union[str, int, Sequence[Sequence[int]]]


def _pairs(padding: Padding, lhs: torch.Tensor, rhs: torch.Tensor, strides) -> list:
    """((top, bottom), (left, right)) for any padding form of ``conv2d``."""
    if isinstance(padding, int):
        return [(padding, padding)] * 2
    if padding == "VALID":
        return [(0, 0)] * 2
    if padding == "SAME":
        pairs = []
        for size, k, s in zip(lhs.shape[2:], rhs.shape[2:], strides):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(padding, str):
        raise ValueError(f"unknown padding {padding!r}")
    return [tuple(int(v) for v in p) for p in padding]


def conv2d(
    lhs: torch.Tensor, rhs: torch.Tensor, strides: Sequence[int], padding: Padding, dtype=None
) -> torch.Tensor:
    """NCHW x OIHW -> NCHW. ``padding``: an int, ``"VALID"``, ``"SAME"`` or
    ``((top, bottom), (left, right))``. ``dtype`` (the JAX function's
    ``preferred_element_type``; default the operands' common type): both
    operands are cast to it and the output is in it. In bf16 the card's
    cuDNN and the CPU both accumulate in fp32 and round the output once."""
    if dtype is None:
        dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    lhs, rhs = lhs.to(dtype), rhs.to(dtype)
    strides = tuple(strides)
    (top, bottom), (left, right) = _pairs(padding, lhs, rhs, strides)
    if top == bottom and left == right:
        return F.conv2d(lhs, rhs, stride=strides, padding=(top, left))
    return F.conv2d(F.pad(lhs, (left, right, top, bottom)), rhs, stride=strides)
