"""Flax parameters to a PyTorch state_dict.

The reverse of ``beyond_deep_ensembles_tpu/models/torch_convert.py``. The
port registers its submodules under flax's names (``nn/base.py``), so a key
is the flax path joined with dots and only layouts change: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``; ``__gmean``/
``__grho`` leaves keep their names and FRN vectors pass as they are. Plain
``Conv_k``/``Dense_k`` kernels follow the same rules. A DistilBERT tree has
2-D leaves that are not kernels (the embeddings), so it has its own
:func:`bert_from_jax`.
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


def _convert(params: Mapping, leaf) -> dict:
    """Nested mappings of arrays -> {dotted path: ``leaf(name, array)``}."""
    out = {}

    def walk(prefix, node):
        for key, value in node.items():
            path = prefix + (str(key),)
            if isinstance(value, Mapping):
                walk(path, value)
            else:
                out[".".join(path)] = leaf(str(key), np.asarray(value))

    walk((), params)
    return out


def params_from_jax(params: Mapping) -> dict:
    """``flax_params_as_numpy`` (nested mappings of arrays) -> state_dict."""
    return _convert(params, lambda name, a: _leaf(a))


def bert_from_jax(params: Mapping) -> dict:
    """A flax ``BertClassifier`` param tree (numpy) -> the port's state_dict:
    dense ``kernel`` ``[in, out]`` -> ``[out, in]``; embeddings, LayerNorm
    ``scale``/``bias`` and the dense biases as they are."""
    return _convert(
        params, lambda name, a: torch.from_numpy(np.array(a.T if name == "kernel" else a, np.float32, order="C"))
    )


def particles_from_jax(stacked: Mapping) -> list:
    """Flax parameters stacked on a leading particle axis (the JAX SVGD
    state's ``params``) -> one state_dict per particle."""

    def index(node, i):
        return {k: index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in node.items()}

    def count(node):
        first = next(iter(node.values()))
        return count(first) if isinstance(first, Mapping) else np.asarray(first).shape[0]

    return [params_from_jax(index(stacked, i)) for i in range(count(stacked))]
