"""Flat-vector helpers over named parameters.

Counterpart of ``beyond_deep_ensembles_tpu/tree.py`` (``ravel``,
``make_unravel``, ``tree_where``, ``tree_stack``). A tree here is an ``nn.Module`` (its
``named_parameters()``) or a mapping from dotted names to tensors.

The flat order is the tree's own order (a module's registration order), not
``jax.tree.leaves``' alphabetical one. SVGD's Gram matrix, distances and
Stein direction do not depend on the column order, as long as the particles
and their gradients are raveled in one order, which ``ravel`` guarantees for
trees with the same names.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Sequence, Union

import torch
from torch import nn

Tree = Union[nn.Module, Mapping[str, torch.Tensor]]


def named(tree: Tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


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
