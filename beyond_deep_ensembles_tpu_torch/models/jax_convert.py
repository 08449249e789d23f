"""Flax parameters and JAX method states to PyTorch state_dicts.

The reverse of ``beyond_deep_ensembles_tpu/models/torch_convert.py``. The
port registers its submodules under flax's names (``nn/base.py``), so a key
is the flax path joined with dots and only layouts change: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]`` (the leaves named
``kernel``, ``kernel__gmean``, ``kernel__grho``); every other leaf passes as
it is: FRN vectors, Rank-1 layers' ``[C, in]`` / ``[C, out]`` factors and
``[C, out]`` biases. A DistilBERT tree has 2-D leaves that are not kernels
(the embeddings), so it has its own :func:`bert_from_jax`. JAX mutable
collections (a spectral norm's ``kernel_u``, SNGP's ``precision``,
``covariance``, ``seen_data``, the RFF ``W`` and ``b``) are the port's module
buffers under the same paths, in the same layouts (:func:`buffers_from_jax`).

Method states: :func:`particles_from_jax` splits parameters stacked on a
leading axis (SVGD's particles, an ensemble's members);
:func:`state_from_jax` turns one JAX ``MethodState`` (its optax state the
CIFAR chain's, a ``trace`` and a schedule ``count``, or the UCI
``multi_transform``'s, an Adam ``mu``, ``nu`` and ``count`` beside the
``__mle`` parameters' stateless SGD), ``SvgdState`` (particles stacked),
``SwagState``, ``IvonState`` or ``LaplaceState`` into the port's
``state_dict`` for a given module (an ``nn.ModuleList`` of particles for
SVGD). JAX flattens a parameter tree in sorted-key order
(``jax.tree.leaves``), the port in the module's parameter order
(``tree.ravel``), so the flat vectors (the SGD buffers, SWAG's moments and
ring rows, iVON's mean, momentum and precision) are unraveled by the first
and raveled by the second; the Laplace vectors keep the JAX order, which the
port's ``methods/laplace.py`` uses. :func:`last_layer_state_from_jax` turns a
JAX ``LastLayerState`` (its inner state over the head tree, the backbone
tree and its optimizer state, each with zero-size placeholders where a leaf
belongs to the other side) into the port's ``LastLayerState`` state_dict,
the inner state through :func:`state_from_jax` on the head view(s). The
DistilBERT heads (plain, BBB, Rank-1, SNGP) follow the rules above: their
kernels ``[in, out]`` are transposed, Rank-1 factors and biases and the SNGP
buffers kept. Only numpy is used: the JAX objects are read by their fields.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Mapping

import numpy as np
import torch

from ..methods.api import MLE_SUFFIX


def _leaf(name: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if name.startswith("kernel") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif name.startswith("kernel") and a.ndim == 2:
        a = a.T
    elif a.ndim > 2:
        raise ValueError(f"no layout rule for the rank-{a.ndim} leaf {name!r}")
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
    return _convert(params, _leaf)


def buffers_from_jax(model_state: Mapping) -> dict:
    """A JAX model state (``{collection: tree}``: ``spectral_norm``,
    ``sngp``, ``buffers``) -> the port's buffers, each tree's paths joined
    with dots, layouts and dtypes kept (``seen_data`` int32)."""
    out = {}
    for tree in model_state.values():
        out.update(_convert(tree, lambda name, a: torch.from_numpy(np.array(a, order="C"))))
    return out


def bert_from_jax(params: Mapping) -> dict:
    """A flax ``BertClassifier`` or ``BertSNGP`` param tree (numpy) -> the
    port's state_dict: dense kernels ``[in, out]`` (``kernel``, a BBB head's
    ``kernel__gmean`` and ``kernel__grho``) -> ``[out, in]``; embeddings,
    LayerNorm ``scale``/``bias``, the biases and Rank-1 factors as they
    are."""
    return _convert(
        params,
        lambda name, a: torch.from_numpy(
            np.array(a.T if name.startswith("kernel") and a.ndim == 2 else a, np.float32, order="C")),
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
    """The first ``name`` field in a nest of named tuples and mappings (an
    optax state; a ``multi_transform``'s partitions are a mapping)."""
    if name in getattr(node, "_fields", ()):
        return getattr(node, name)
    if isinstance(node, (tuple, Mapping)):
        for child in (node.values() if isinstance(node, Mapping) else node):
            found = _field(child, name)
            if found is not None:
                return found
    return None


def _numpy_tree(node):
    return {k: _numpy_tree(v) for k, v in node.items()} if isinstance(node, Mapping) else np.asarray(node)


def _unmasked(node):
    """A tree without the ``optax.MaskedNode`` leaves (empty tuples) that a
    ``multi_transform`` state holds where a leaf belongs to the other
    partition."""
    out = {}
    for key, value in node.items():
        if isinstance(value, Mapping):
            out[key] = _unmasked(value)
        elif not (isinstance(value, tuple) and len(value) == 0):
            out[key] = value
    return out


def _named_from(tree: Mapping, stacked: bool) -> dict:
    """A JAX tree (numpy) -> {port name: tensor}; ``stacked``: the leading
    axis is an ``nn.ModuleList``'s index (SVGD's particles)."""
    if not stacked:
        return params_from_jax(tree)
    return {f"{i}.{k}": v for i, sd in enumerate(particles_from_jax(tree)) for k, v in sd.items()}


def _is_mle(name: str) -> bool:
    return name.rsplit(".", 1)[-1].endswith(MLE_SUFFIX)


def _adam_from_jax(module: torch.nn.Module, opt_state, named: dict, lr: float, var_lr: float,
                   stacked: bool) -> dict:
    """The UCI optimizer's state (``utils/optim.py``: ``Adam`` over every
    parameter but the ``__mle`` ones, a momentum-free ``SGD`` over those, a
    ``Split`` when there are both) from a JAX ``multi_transform`` state
    whose ``main`` partition holds a ``ScaleByAdamState``. The SGD keeps no
    state in JAX: its count is the Adam count (the two step together) and
    its trace zeros."""
    names = [name for name, _ in module.named_parameters()]
    main = [n for n in names if not _is_mle(n)]
    mle = [n for n in names if _is_mle(n)]
    mu = _named_from(_numpy_tree(_unmasked(_field(opt_state, "mu"))), stacked)
    nu = _named_from(_numpy_tree(_unmasked(_field(opt_state, "nu"))), stacked)
    count = torch.tensor(int(np.asarray(_field(opt_state, "count")).reshape(-1)[0]), dtype=torch.int64)

    def cat(tree, which):
        return torch.cat([tree[n].reshape(-1) for n in which])

    adam = {"flat": cat(named, main), "mu": cat(mu, main), "nu": cat(nu, main), "count": count,
            "lr": torch.tensor(lr, dtype=torch.float64)}
    if not mle:
        return {f"opt.{k}": v for k, v in adam.items()}
    flat = cat(named, mle)
    sgd = {"flat": flat, "trace": torch.zeros_like(flat), "count": count.clone(),
           "lr": torch.tensor(var_lr, dtype=torch.float64)}
    return {**{f"opt.main.{k}": v for k, v in adam.items()}, **{f"opt.mle.{k}": v for k, v in sgd.items()}}


def state_from_jax(module: torch.nn.Module, state, lr: float = 0.0, var_lr: float = 0.0) -> dict:
    """A JAX ``MethodState`` (``map_method``, ``bbb_method``; the CIFAR optax
    chain or the UCI ``multi_transform``), ``SvgdState``, ``SwagState``,
    ``IvonState`` or ``LaplaceState`` -> the port's ``state_dict`` for
    ``module`` (its parameter names and order; the particles'
    ``nn.ModuleList`` for SVGD), ``lr`` the optimizer's base lr and
    ``var_lr`` the ``__mle`` parameters' (UCI). A Rank-1 mixture's (factors
    of more than one component) carries the JAX step as ``bbb.updates``."""
    stacked = isinstance(module, torch.nn.ModuleList)
    params = _numpy_tree(state.params)
    named = _named_from(params, stacked)
    if not stacked:
        named.update(buffers_from_jax(_numpy_tree(state.model_state or {})))

    def flat_of(vector):
        return _port_flat(module, params_from_jax(_unravel_sorted(params, vector)))

    def flat_tree(tree):
        return _port_flat(module, _named_from(_numpy_tree(tree), stacked))

    out = {f"params.{k}": v for k, v in named.items()}
    step = torch.tensor(int(state.step), dtype=torch.int64)
    if hasattr(state, "ll_mean"):
        out.update({f"laplace.{k}": torch.from_numpy(np.array(getattr(state, k), np.float32))
                    for k in ("ll_mean", "scale_tril", "diag_scale", "prior_prec", "kron_ua", "kron_ub",
                              "kron_sa", "kron_sb")})
    elif hasattr(state, "momentum"):
        out.update({
            "ivon.mean": flat_tree(state.mean),
            "ivon.momentum": flat_tree(state.momentum),
            "ivon.precision": flat_tree(state.precision),
            "ivon.count": step.clone(),
        })
    elif _field(state.opt_state, "mu") is not None:
        out.update(_adam_from_jax(module, state.opt_state, named, lr, var_lr, stacked))
    else:
        count = _field(state.opt_state, "count")
        out.update({
            "opt.flat": _port_flat(module, named),
            "opt.trace": flat_tree(_field(state.opt_state, "trace")),
            "opt.count": torch.tensor(0 if count is None else int(count), dtype=torch.int64),
            "opt.lr": torch.tensor(lr, dtype=torch.float64),
        })
    out.update({"step": step, "epoch": torch.tensor(int(state.epoch), dtype=torch.int64)})
    if any(k.rsplit(".", 1)[-1] == "s__gmean" and v.shape[0] > 1 for k, v in named.items()):
        out["bbb.updates"] = step.clone()
    if hasattr(state, "deviations"):
        out.update({
            "swag.mean": flat_of(state.mean),
            "swag.sq_mean": flat_of(state.sq_mean),
            "swag.deviations": torch.stack([flat_of(row) for row in np.asarray(state.deviations, np.float32)]),
            "swag.updates": torch.tensor(int(state.updates), dtype=torch.int32),
            "swag.steps_since_start": torch.tensor(int(state.steps_since_start), dtype=torch.int32),
        })
    return out


def strip_placeholders(tree):
    """A tree without its zero-size leaves (the JAX last-layer split's
    placeholders) and the subtrees left empty."""
    if not isinstance(tree, Mapping):
        return tree
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            value = strip_placeholders(value)
            if value:
                out[key] = value
        elif not (isinstance(value, tuple) and len(value) == 0) and np.asarray(value).size:
            out[key] = value
    return out


# an optax state's fields as ``state_from_jax`` reads them (``_field``)
_AdamFields = namedtuple("_AdamFields", "mu nu count")
_TraceFields = namedtuple("_TraceFields", "trace count")


def _stripped_opt(opt_state):
    """An optax state's moments without placeholders, as the fields
    :func:`state_from_jax` reads."""
    count = _field(opt_state, "count")
    mu = _field(opt_state, "mu")
    if mu is not None:
        return _AdamFields(strip_placeholders(_unmasked(_numpy_tree(mu))),
                           strip_placeholders(_unmasked(_numpy_tree(_field(opt_state, "nu")))), count)
    return _TraceFields(strip_placeholders(_numpy_tree(_field(opt_state, "trace"))), count)


class _Stripped:
    """A JAX method state read through :func:`state_from_jax` with the
    placeholders of its trees removed."""

    _TREES = ("params", "mean", "momentum", "precision")

    def __init__(self, state):
        self._state = state

    def __getattr__(self, name):
        value = getattr(self._state, name)
        if name in self._TREES and isinstance(value, Mapping):
            return strip_placeholders(_numpy_tree(value))
        if name == "opt_state":
            return _stripped_opt(value)
        return value


def last_layer_state_from_jax(template, state, lr: float = 0.0) -> dict:
    """A JAX ``LastLayerState`` -> the state_dict of the port's
    ``LastLayerState`` ``template`` (``methods/last_layer.py``): the inner
    state on ``template.inner.params`` (a head view, or a ``ModuleList`` of
    them for stacked head particles), the backbone parameters by name, and
    their optimizer (Adam or SGD, its moments raveled in the template's
    backbone order), ``lr`` both optimizers' base rate."""
    out = {f"inner.{k}": v for k, v in state_from_jax(template.inner.params, _Stripped(state.inner), lr).items()}
    backbone = params_from_jax(strip_placeholders(_numpy_tree(state.backbone)))
    names = list(template.backbone)
    if set(names) != set(backbone):
        raise KeyError(f"backbone names differ: {sorted(set(names) ^ set(backbone))[:8]}")
    out.update({f"backbone.{n}": backbone[n] for n in names})
    opt = _stripped_opt(state.backbone_opt)

    def flat(tree):
        named = params_from_jax(tree)
        return torch.cat([named[n].reshape(-1) for n in names])

    count = torch.tensor(int(np.asarray(opt.count).reshape(-1)[0]) if opt.count is not None else 0, dtype=torch.int64)
    fields = {"flat": flat(strip_placeholders(_numpy_tree(state.backbone)))}
    if isinstance(opt, _AdamFields):
        fields.update({"mu": flat(opt.mu), "nu": flat(opt.nu)})
    else:
        fields["trace"] = flat(opt.trace)
    fields.update({"count": count, "lr": torch.tensor(lr, dtype=torch.float64)})
    out.update({f"backbone_opt.{k}": v for k, v in fields.items()})
    out.update({"step": torch.tensor(int(state.step), dtype=torch.int64),
                "epoch": torch.tensor(int(state.epoch), dtype=torch.int64)})
    return out
