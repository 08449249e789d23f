"""SVGD: Stein Variational Gradient Descent.

Counterpart of ``beyond_deep_ensembles_tpu/methods/svgd.py`` (reference
SVGDOptimizer, src/algos/svgd.py). The particles are n copies of the model,
an ``nn.ModuleList`` held in ``MethodState.params``. Each step runs the
reference's sequential loop, one forward and backward per particle (each
drawing its own augmentation from the step's ``NoiseSource``), then ravels
the parameters and gradients to ``[n, P]``, adds the L2 prior
``l2_reg / 2 * particle``, takes the Stein direction phi (``rbf_phi``, whose
Gram matrix is the K2 kernel on a card) and writes ``-phi`` as every
parameter's gradient. Parameters whose names carry ``__mle`` keep their raw
gradient (reference util.py:188-189 ``non_mle_params``).

One ``tx`` optimizer (the port's ``SGD``, whose ``step(ok)`` takes the
guard) steps every particle's parameters. SGD with weight
decay, momentum and one learning-rate schedule acts per element, so this
equals the JAX package's ``vmap(tx.update)`` over particles; the weight
decay it adds to ``-phi`` comes on top of the L2 term inside phi, as in JAX.
A non-finite gradient skips the parameters and the optimizer state,
momentum and the schedule's count included, by a select on the device
(``utils/optim.py::SGD.step``; JAX ``methods/svgd.py:158-165``), so the
step reads nothing on the host and a CUDA graph can capture it (K2's counter
is zeroed by a first call outside capture, which a runner's warm-up makes).

Particle p draws its noise from ``noise.member(p)`` (JAX splits its step
key per particle): in key mode a source of its own, in generator and given
mode this source, whose draws the particles take in turn.

On a mesh (``parallel/mesh.py``) the particles are whole on every rank; a
rank runs the forwards and backwards of its share of the member axis
(``mesh.member_range``), averages their gradients and losses over the data
axis and gathers them over the member axis (the JAX package's
``test_svgd_particle_data_parallel_equals_single_device`` arrangement), so
every rank takes K2 on the same gathered ``[n, P]`` block and steps every
particle alike. A member-split update needs per-particle sources (key mode,
or given draws per particle) and raises otherwise.

Each particle keeps its own mutable model state (a running-statistics
BatchNorm's ``mean`` and ``var``) in its module's buffers, which its own
forwards step: the port's form of JAX's per-particle stacked
``model_state``. ``init`` copies a given state into them, row p into
particle p where it is stacked, else the one state into every particle
(JAX :76-113, with its ``model_state_stacked`` knob). K2 and the Stein
direction see the parameters only (``tree.ravel`` reads
``named_parameters``), never the buffers.

``SvgdState`` is the port's ``MethodState`` (JAX's ``SvgdState`` holds the
same fields, its particles stacked where the port's are an
``nn.ModuleList``).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..ops.svgd_kernel import _median_linear, rbf_phi
from ..parallel import mesh as _mesh
from ..tree import make_unravel, ravel
from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch, non_mle_mask
from .ensemble import load_stacked_buffers

SvgdState = MethodState


def rbf(particles: torch.Tensor, h_override=None):
    """RBF kernel and its analytic gradient with the median heuristic
    (reference svgd.py:14-32), the three-term form that ``rbf_phi`` folds
    into one product; like the JAX ``rbf`` it takes the Gram as a plain
    product, not through K2. particles: ``[n, P]``. Returns
    ``(kernel [n, n], grad_kernel [n, P])``."""
    n = particles.shape[0]
    sq_norms = torch.sum(particles * particles, dim=1)
    d2 = torch.clamp(sq_norms[:, None] + sq_norms[None, :] - 2 * (particles @ particles.T), min=0.0)
    if h_override is None:
        h = torch.sqrt(0.5 * _median_linear(d2) / math.log(n + 1.0)) + 1e-8
    else:
        h = h_override
    kernel = torch.exp(-d2 / (2 * h**2))
    grad_kernel = (torch.sum(kernel, dim=1)[:, None] * particles - kernel @ particles) / h**2
    return kernel, grad_kernel


def svgd_method(
    loss_fn: LossFn,
    tx: Callable,
    particle_count: int,
    dataset_size: int,
    l2_reg: float = 0.0,
    kernel_grad_scale: float = 1.0,
    model_state_stacked: bool | None = None,
) -> PosteriorMethod:
    def init(params: nn.ModuleList, model_state=None):
        """``model_state``: ``{buffer name: tensor}`` copied into the
        particles' buffers, stacked on a leading particle axis where
        ``model_state_stacked`` says so or, left None, where every tensor's
        leading size is the particle count (JAX's rule), else one state
        broadcast to every particle."""
        if len(params) != particle_count:
            raise ValueError(f"expected {particle_count} particles, got {len(params)}")
        if model_state:
            stacked = model_state_stacked
            if stacked is None:
                stacked = all(torch.as_tensor(v).ndim >= 1 and torch.as_tensor(v).shape[0] == particle_count
                              for v in model_state.values())
            load_stacked_buffers(params, model_state, stacked)
        return MethodState(params=params, model_state={}, opt_state=tx(params.parameters()))

    def update(state: MethodState, noise, batch):
        particles = state.params
        optimizer, _ = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        mesh = _mesh.active()
        own = range(particle_count) if mesh is None else _mesh.member_range(mesh, particle_count)
        if len(own) < particle_count and noise is not None and not noise.per_member:
            raise ValueError("particles split over ranks draw from per-particle sources: key mode or given draws "
                             "per particle")
        losses = []
        for i in own:
            out = loss_fn(particles[i], state.model_state, None if noise is None else noise.member(i), batch)
            out.loss.backward()
            losses.append(out.loss.detach())
        losses = torch.stack(losses)

        with torch.no_grad():
            raw = torch.stack([ravel({k: q.grad for k, q in particles[i].named_parameters()}) for i in own])
            if mesh is not None:
                raw, losses = _mesh.mean_of([raw, losses])
                if len(own) < particle_count:
                    raw = _mesh.all_gather(raw, _mesh.MEMBER_AXIS)
                    losses = _mesh.all_gather(losses, _mesh.MEMBER_AXIS)
            particle_mat = torch.stack([ravel(p) for p in particles])  # [n, P]
            # prior as L2 (reference svgd.py:86)
            grad_mat = raw + (l2_reg / 2.0) * particle_mat
            phi = rbf_phi(particle_mat, grad_mat, kernel_grad_scale, dataset_size)
            # descend along -phi (reference svgd.py:89-95 writes -phi into
            # .grad); the __mle parameters keep their raw gradient
            unravel = make_unravel(particles[0])
            mask = non_mle_mask(particles[0])
            for particle, direction, grad in zip(particles, -phi, raw):
                stein, plain = unravel(direction), unravel(grad)
                for name, p in particle.named_parameters():
                    p.grad = stein[name] if mask[name] else plain[name]
            # skip the whole update on a non-finite gradient (reference
            # svgd.py:78-79, GradScaler's inf check); the gradients are
            # global already
            optimizer.step(torch.isfinite(grad_mat).all(), reduce=False)
            if mesh is not None and len(own) < particle_count:
                _mesh.broadcast_member_buffers(mesh, particles, particle_count)
        state.step += 1
        # ``backbone_loss`` is the SUM over particles: under a last-layer
        # composition the reference's shared backbone accumulates every
        # particle's backward (methods/svgd.py:182-193 in the JAX package);
        # the user-facing loss is the mean.
        return state, {"loss": losses.mean(), "backbone_loss": losses.sum()}

    def sample(state: MethodState, noise=None, index=None):
        """Cycle through the particles (reference svgd.py:107-112): the
        prediction index selects the particle, and with it the particle's
        own buffers."""
        del noise
        return state.params[(index or 0) % particle_count], state.model_state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=default_finalize_epoch,
    )
