"""Flax parameters to a PyTorch state_dict.

The reverse of ``beyond_deep_ensembles_tpu/models/torch_convert.py``. The
port registers its submodules under flax's names (``nn/base.py``), so a key
is the flax path joined with dots and only layouts change: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``; ``__gmean``/
``__grho`` leaves keep their names and FRN vectors pass as they are.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _leaf(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    elif a.ndim > 2:
        raise ValueError(f"no layout rule for a rank-{a.ndim} leaf")
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def params_from_jax(params: Mapping) -> dict:
    """``flax_params_as_numpy`` (nested mappings of arrays) -> state_dict."""
    out = {}

    def walk(prefix, node):
        for key, value in node.items():
            path = prefix + (str(key),)
            if isinstance(value, Mapping):
                walk(path, value)
            else:
                out[".".join(path)] = _leaf(value)

    walk((), params)
    return out
