"""Posterior / loss-surface plane evaluation.

Counterpart of ``beyond_deep_ensembles_tpu/evals/surface.py`` (reference
bnn_hmc/make_posterior_surface_plot.py): the loss (or log-density) on the
2-D plane through three parameter vectors (three posterior samples or
checkpoints, Garipov et al. style). A parameter tree is a module, a mapping
of names to tensors, or one flat tensor; trees are raveled in
``tree.sorted_named`` order (JAX's), and ``loss_of_params`` gets a mapping of
the same names (a flat tensor where the anchors are flat). The grid is
evaluated in chunks of at most 64 points, each chunk one ``torch.func.vmap``
of the loss, as the JAX function's ``lax.map(batch_size=64)``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree


def _flat(params) -> torch.Tensor:
    if isinstance(params, torch.Tensor):
        return params.detach().reshape(-1).float()
    return tree.ravel(tree.sorted_named(params))


def plane_basis(p0, p1, p2):
    """Orthonormal basis ``(u, v)`` of the plane through three parameter
    trees, and the in-plane coordinates of the three anchors ``[3, 2]``."""
    base = _flat(p0)
    d1, d2 = _flat(p1) - base, _flat(p2) - base
    u = d1 / torch.linalg.norm(d1)
    d2_orth = d2 - (d2 @ u) * u
    v = d2_orth / torch.linalg.norm(d2_orth)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    coords = torch.stack([torch.stack([zero, zero]), torch.stack([d1 @ u, zero]), torch.stack([d2 @ u, d2 @ v])])
    return u, v, coords


def loss_surface(loss_of_params: Callable, p0, p1, p2, grid: int = 20, margin: float = 0.2):
    """``loss_of_params(params) -> scalar`` on a ``grid`` x ``grid`` plane
    spanned by (p0, p1, p2), widened by ``margin`` of the anchors' span on
    each side. Returns ``(xs, ys, values [grid, grid], anchor_coords)``."""
    u, v, coords = plane_basis(p0, p1, p2)
    base = _flat(p0)
    unravel = (lambda vec: vec) if isinstance(p0, torch.Tensor) else tree.make_unravel(tree.sorted_named(p0))

    lo = coords.min(dim=0).values
    hi = coords.max(dim=0).values
    span = hi - lo
    xs = torch.linspace(float(lo[0] - margin * span[0]), float(hi[0] + margin * span[0]), grid, device=u.device)
    ys = torch.linspace(float(lo[1] - margin * span[1]), float(hi[1] + margin * span[1]), grid, device=u.device)

    def at(xy):
        return loss_of_params(unravel(base + xy[0] * u + xy[1] * v))

    pts = torch.stack(torch.meshgrid(xs, ys, indexing="ij"), dim=-1).reshape(-1, 2)
    chunk = min(64, grid * grid)
    with torch.no_grad():
        values = torch.cat([torch.func.vmap(at)(pts[i : i + chunk]) for i in range(0, pts.shape[0], chunk)])
    return xs, ys, values.reshape(grid, grid), coords
