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

Only an empty model state is ported (FRN keeps none); a stacked per-particle
state raises.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..ops.svgd_kernel import _median_linear, rbf_phi
from ..tree import make_unravel, ravel
from .api import LossFn, MethodState, PosteriorMethod, default_finalize_epoch, non_mle_mask


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
) -> PosteriorMethod:
    def init(params: nn.ModuleList, model_state=None):
        if len(params) != particle_count:
            raise ValueError(f"expected {particle_count} particles, got {len(params)}")
        if model_state:
            raise NotImplementedError("a per-particle model state: not ported yet")
        return MethodState(params=params, model_state={}, opt_state=tx(params.parameters()))

    def update(state: MethodState, noise, batch):
        particles = state.params
        optimizer, _ = state.opt_state
        optimizer.zero_grad(set_to_none=True)
        losses = []
        for particle in particles:
            out = loss_fn(particle, state.model_state, noise, batch)
            out.loss.backward()
            losses.append(out.loss.detach())
        losses = torch.stack(losses)

        with torch.no_grad():
            particle_mat = torch.stack([ravel(p) for p in particles])  # [n, P]
            grad_mat = torch.stack([ravel({k: q.grad for k, q in p.named_parameters()}) for p in particles])
            # prior as L2 (reference svgd.py:86)
            grad_mat = grad_mat + (l2_reg / 2.0) * particle_mat
            phi = rbf_phi(particle_mat, grad_mat, kernel_grad_scale, dataset_size)
            # descend along -phi (reference svgd.py:89-95 writes -phi into .grad)
            unravel = make_unravel(particles[0])
            mask = non_mle_mask(particles[0])
            for particle, direction in zip(particles, -phi):
                stein = unravel(direction)
                for name, p in particle.named_parameters():
                    if mask[name]:
                        p.grad = stein[name]
            # skip the whole update on a non-finite gradient (reference
            # svgd.py:78-79, GradScaler's inf check)
            optimizer.step(torch.isfinite(grad_mat).all())
        state.step += 1
        # ``backbone_loss`` is the SUM over particles: under a last-layer
        # composition the reference's shared backbone accumulates every
        # particle's backward (methods/svgd.py:182-193 in the JAX package);
        # the user-facing loss is the mean.
        return state, {"loss": losses.mean(), "backbone_loss": losses.sum()}

    def sample(state: MethodState, noise=None, index=None):
        """Cycle through the particles (reference svgd.py:107-112): the
        prediction index selects the particle."""
        del noise
        return state.params[(index or 0) % particle_count], state.model_state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=default_finalize_epoch,
    )
