"""Flat-vector helpers over named parameters.

Counterpart of ``beyond_deep_ensembles_tpu/tree.py``. A tree here is an
``nn.Module`` (its ``named_parameters()``), a mapping from dotted names to
tensors, or, for the arithmetic helpers (``tree_add`` ... ``normal_like``),
one tensor (a flat vector is a tree of one leaf).

``ravel`` flattens in the tree's own order (a module's registration order).
SVGD's Gram matrix, distances and Stein direction do not depend on the
column order, as long as the particles and their gradients are raveled in
one order, which ``ravel`` guarantees for trees with the same names. The
bnn-hmc methods and the loss surface ravel :func:`sorted_named` trees
instead: leaves in ``jax.tree.leaves``' order (the dotted paths sorted
component by component, as JAX sorts nested dict keys), so a ring row or a
surface vector holds the JAX leaves in the JAX order, each leaf in the
port's layout.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Sequence, Union

import torch
from torch import nn

Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


def named(tree: Tree) -> Dict[str, torch.Tensor]:
    """The leaves by name (one tensor: a leaf named "")."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        return {"": tree}
    return dict(tree)


def sorted_named(tree: Tree) -> Dict[str, torch.Tensor]:
    """The leaves in ``jax.tree.leaves``' order: dotted names sorted by their
    components (``conv_10`` before ``conv_2``, as strings)."""
    leaves = named(tree)
    return {name: leaves[name] for name in sorted(leaves, key=lambda n: tuple(n.split(".")))}


def ravel(tree: Tree, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All leaves flattened in the tree's order and concatenated: ``[P]``."""
    return torch.cat([leaf.detach().reshape(-1).to(dtype) for leaf in named(tree).values()])


def make_unravel(template: Tree) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """``unravel(vec) -> {name: tensor}`` with ``template``'s names, shapes
    and order. The tensors are views into ``vec`` where the dtype matches."""
    leaves = named(template)
    shapes = {name: leaf.shape for name, leaf in leaves.items()}
    dtypes = {name: leaf.dtype for name, leaf in leaves.items()}
    sizes = [math.prod(s) for s in shapes.values()]

    def unravel(vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        if vec.shape != (sum(sizes),):
            raise ValueError(f"expected a vector of {sum(sizes)} elements, got {tuple(vec.shape)}")
        parts = torch.split(vec, sizes)
        return {name: part.reshape(shapes[name]).to(dtypes[name]) for name, part in zip(shapes, parts)}

    return unravel


def tree_cast(a, dtype: torch.dtype):
    """Every leaf cast to ``dtype`` (a dict by name, or a tensor)."""
    return tree_map(lambda x: x.to(dtype), a)


def tree_where(pred: torch.Tensor, a, b):
    """Select a whole tree by a 0-dim bool tensor on the device (the NaN
    guards: a skipped step keeps the old parameters and optimizer buffers).
    ``a`` and ``b``: trees with the same names, or sequences of tensors; the
    result has ``a``'s form, a dict or a list. The predicate is never read
    on the host, so a CUDA graph can capture the select."""
    if isinstance(a, (nn.Module, Mapping)):
        a, b = named(a), named(b)
        return {name: torch.where(pred, leaf, b[name]) for name, leaf in a.items()}
    return [torch.where(pred, x, y) for x, y in zip(a, b, strict=True)]


def tree_stack(trees: Sequence[Tree]) -> Dict[str, torch.Tensor]:
    """Stack trees with the same names along a new leading axis (the
    particle or member axis)."""
    maps = [named(t) for t in trees]
    return {name: torch.stack([m[name].detach() for m in maps]) for name in maps[0]}


def tree_map(fn, *trees):
    """``fn`` leafwise over trees with the same names (or over tensors)."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    maps = [named(t) for t in trees]
    return {name: fn(*(m[name] for m in maps)) for name in maps[0]}


def tree_size(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(leaf.numel() for leaf in named(tree).values())


def tree_add(a, b, scale=1.0):
    """``a + scale * b``, leafwise (``scale`` a number or a 0-dim tensor)."""
    return tree_map(lambda x, y: x + scale * y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: s * x, a)


def tree_dot(a, b) -> torch.Tensor:
    """Inner product of two trees: each leaf's fp32 sum, then the leaves'
    sums added in order."""
    la, lb = named(a), named(b)
    total = None
    for name, x in la.items():
        part = torch.sum(x.float() * lb[name].float())
        total = part if total is None else total + part
    return total


def tree_sq_norm(a) -> torch.Tensor:
    return tree_dot(a, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def normal_like(generator: torch.Generator, tree):
    """Standard normals with the shapes and dtypes of ``tree``'s leaves,
    drawn from ``generator`` leaf after leaf in the tree's order (the JAX
    function takes a key; the draws are the port's own)."""
    return tree_map(lambda x: torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device), tree)


def tree_unstack(tree, n: int) -> list:
    """The inverse of :func:`tree_stack`: ``n`` trees, the i-th the slice i
    of every leaf."""
    return [tree_map(lambda leaf: leaf[i], tree) for i in range(n)]
