"""Flax parameters to a PyTorch state_dict.

The reverse of ``beyond_deep_ensembles_tpu/models/torch_convert.py``. The
port registers its submodules under flax's names (``nn/base.py``), so a key
is the flax path joined with dots and only layouts change: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``; ``__gmean``/
``__grho`` leaves keep their names and FRN vectors pass as they are. Plain
``Conv_k``/``Dense_k`` kernels follow the same rules. A DistilBERT tree has
2-D leaves that are not kernels (the embeddings), so it has its own
:func:`bert_from_jax`.

Method states: :func:`particles_from_jax` splits parameters stacked on a
leading axis (SVGD's particles, an ensemble's members);
:func:`state_from_jax` turns one JAX ``MethodState`` or ``SwagState`` (its
optax state the CIFAR chain's: a ``trace`` and a schedule ``count``) into
the port's ``state_dict`` for a given module. JAX flattens a parameter tree
in sorted-key order (``jax.tree.leaves``), the port in the module's
parameter order (``tree.ravel``), so the flat vectors (the SGD buffers,
SWAG's moments and ring rows) are unraveled by the first and raveled by the
second. Only numpy is used: the JAX objects are read by their fields.
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


def _index(node: Mapping, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in node.items()}


def particles_from_jax(stacked: Mapping) -> list:
    """Flax parameters stacked on a leading axis (the JAX SVGD state's
    particles, a ``deep_ensemble`` state's members) -> one state_dict
    each."""

    def count(node):
        first = next(iter(node.values()))
        return count(first) if isinstance(first, Mapping) else np.asarray(first).shape[0]

    return [params_from_jax(_index(stacked, i)) for i in range(count(stacked))]


def _unravel_sorted(template: Mapping, flat) -> dict:
    """A JAX flat vector (``tree.ravel``: leaves in sorted-key order) as a
    nested tree shaped like ``template``."""
    flat, start = np.asarray(flat), 0

    def walk(node):
        nonlocal start
        out = {}
        for key in sorted(node):
            value = node[key]
            if isinstance(value, Mapping):
                out[key] = walk(value)
            else:
                size = int(np.prod(np.shape(value)))
                out[key] = flat[start : start + size].reshape(np.shape(value))
                start += size
        return out

    tree = walk(template)
    if start != flat.shape[0]:
        raise ValueError(f"a flat vector of {flat.shape[0]} values for a tree of {start}")
    return tree


def _port_flat(module: torch.nn.Module, state_dict: Mapping) -> torch.Tensor:
    return torch.cat([state_dict[name].reshape(-1) for name, _ in module.named_parameters()])


def _field(node, name):
    """The first ``name`` field in a nest of named tuples (an optax state)."""
    if name in getattr(node, "_fields", ()):
        return getattr(node, name)
    if isinstance(node, tuple):
        for child in node:
            found = _field(child, name)
            if found is not None:
                return found
    return None


def _numpy_tree(node):
    return {k: _numpy_tree(v) for k, v in node.items()} if isinstance(node, Mapping) else np.asarray(node)


def state_from_jax(module: torch.nn.Module, state, lr: float) -> dict:
    """A JAX ``MethodState`` (``map_method``, the CIFAR optax chain) or
    ``SwagState`` -> the port's ``state_dict`` for ``module`` (its
    parameter names and order), ``lr`` the optimizer's base lr."""
    params = _numpy_tree(state.params)
    named = params_from_jax(params)

    def flat_of(vector):
        return _port_flat(module, params_from_jax(_unravel_sorted(params, vector)))

    out = {f"params.{k}": v for k, v in named.items()}
    count = _field(state.opt_state, "count")
    out.update({
        "opt.flat": _port_flat(module, named),
        "opt.trace": _port_flat(module, params_from_jax(_numpy_tree(_field(state.opt_state, "trace")))),
        "opt.count": torch.tensor(0 if count is None else int(count), dtype=torch.int64),
        "opt.lr": torch.tensor(lr, dtype=torch.float64),
        "step": torch.tensor(int(state.step), dtype=torch.int64),
        "epoch": torch.tensor(int(state.epoch), dtype=torch.int64),
    })
    if hasattr(state, "deviations"):
        out.update({
            "swag.mean": flat_of(state.mean),
            "swag.sq_mean": flat_of(state.sq_mean),
            "swag.deviations": torch.stack([flat_of(row) for row in np.asarray(state.deviations, np.float32)]),
            "swag.updates": torch.tensor(int(state.updates), dtype=torch.int32),
            "swag.steps_since_start": torch.tensor(int(state.steps_since_start), dtype=torch.int32),
        })
    return out
