"""Deep Ensembles / Multi-X and the posterior-predictive entry.

Counterpart of ``beyond_deep_ensembles_tpu/methods/ensemble.py`` (reference
DeepEnsemble, src/algos/ensemble.py). :func:`deep_ensemble` wraps any
posterior method: its state holds the M members' inner states, and an
update runs each member's inner update, one after another, with the
member's own noise (``NoiseSource.member``: in key mode the step key folded
with the member's index, as the JAX ensemble splits its key per member), so
Multi-X over MAP, MCD, SWAG or BBB is the same wrapper.

:func:`predict` takes S predictions as S forwards: of the live parameters,
each drawing fresh noise, for methods whose model samples in its forward
(``sample_is_identity``: BBB, MAP, MCD); of the parameters ``method.sample``
returns for index i otherwise (SVGD: particle ``i % n``; an ensemble:
member ``i % M``'s sample ``i // M``; SWAG: a draw of the Gaussian). Nothing
on the identity and particle paths materializes sampled parameters, so the
JAX ``chunk_size`` has no counterpart. With ``components`` = C > 1 (Rank-1
mixtures) sample i runs the joint component ``i % C`` in every layer of its
forward; a multisample method (SNGP) makes one forward that returns all S.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import torch
from torch import nn

from .api import PosteriorMethod


@dataclasses.dataclass
class EnsembleState:
    """The members' inner states. ``step`` reads member 0's and sets every
    member's (the runners restore it after their warm-up). ``first``: the
    index of ``members[0]`` in the whole ensemble, nonzero on a rank that
    holds its share of a member-split ensemble
    (``parallel/mesh.py::shard_member_state``)."""

    members: List
    first: int = 0

    @property
    def step(self) -> int:
        return self.members[0].step

    @step.setter
    def step(self, value: int) -> None:
        for member in self.members:
            member.step = value

    @property
    def params(self) -> nn.ModuleList:
        """The members' parameter modules (for reading them)."""
        return nn.ModuleList(member.params for member in self.members)

    def written_tensors(self) -> list:
        return [t for member in self.members for t in member.written_tensors()]

    def state_dict(self) -> dict:
        return {f"members.{i}.{k}": v for i, member in enumerate(self.members)
                for k, v in member.state_dict().items()}

    def load_state_dict(self, state: dict) -> None:
        mine = self.state_dict()
        if mine.keys() != state.keys():
            raise KeyError(f"ensemble state keys differ: {sorted(mine.keys() ^ state.keys())[:8]}")
        for i, member in enumerate(self.members):
            prefix = f"members.{i}."
            member.load_state_dict({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})


def load_stacked_buffers(modules: Sequence[nn.Module], model_state, stacked: bool) -> None:
    """``model_state`` (``{buffer name: tensor}``) copied in place into the
    buffers of each of ``modules``: row i of every tensor into module i
    where ``stacked``, else every tensor into every module (JAX SVGD's
    broadcast of an unstacked state). Every name must be a buffer of the
    modules; buffers it does not name keep their values."""
    for i, module in enumerate(modules):
        buffers = dict(module.named_buffers())
        unknown = sorted(set(model_state) - set(buffers))
        if unknown:
            raise KeyError(f"not buffers of the model: {unknown[:8]}")
        with torch.no_grad():
            for name, value in model_state.items():
                buffers[name].copy_(torch.as_tensor(value)[i] if stacked else torch.as_tensor(value))


def deep_ensemble(inner: PosteriorMethod, n_members: int) -> PosteriorMethod:
    """M independent members of ``inner`` (JAX ``deep_ensemble``, :26-63).

    init(params, model_state=None): ``params`` a sequence of M member
        modules (an ``nn.ModuleList``); each member's state is
        ``inner.init(module, {})``. Each member keeps its own mutable
        state (running statistics, SNGP's precision) in its module's
        buffers, the port's form of JAX's ``stacked_model_state``; a given
        ``model_state`` (``{buffer name: [M, ...]}``, stacked on the member
        axis) is copied into them, member m taking row m
        (:func:`load_stacked_buffers`).
    update: each member's ``inner.update`` under ``noise.member(m)``, m
        the member's index in the whole ensemble; the metrics are the
        members' means, and ``{k}_per_member`` the ``[M]`` values (of the
        rank's members where they are split over ranks).
    sample(state, noise, index): member ``index % M``'s
        ``inner.sample(member, noise, index // M)``.
    finalize_epoch: each member's."""

    def init(params: Sequence[nn.Module], model_state=None):
        params = list(params)
        if len(params) != n_members:
            raise ValueError(f"expected {n_members} members, got {len(params)}")
        if model_state:
            load_stacked_buffers(params, model_state, stacked=True)
        return EnsembleState([inner.init(p, {}) for p in params])

    def update(state: EnsembleState, noise, batch):
        per_member = []
        for m, member in enumerate(state.members):
            state.members[m], metrics = inner.update(member, noise.member(state.first + m), batch)
            per_member.append(metrics)
        stacked = {k: torch.stack([metrics[k] for metrics in per_member]) for k in per_member[0]}
        out = {k: torch.mean(v) for k, v in stacked.items()}
        out.update({f"{k}_per_member": v for k, v in stacked.items()})
        return state, out

    def sample(state: EnsembleState, noise=None, index=None):
        index = index or 0
        return inner.sample(state.members[index % n_members], noise, index // n_members)

    def finalize_epoch(state: EnsembleState):
        state.members = [inner.finalize_epoch(member) for member in state.members]
        return state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=finalize_epoch,
        multisample=inner.multisample,
    )


def predict(
    method: PosteriorMethod,
    state,
    apply_fn: Callable,
    x: torch.Tensor,
    n_samples: int,
    noise,
    components: int = 1,
) -> torch.Tensor:
    """apply_fn(params, model_state, noise, x, **kwargs) -> output of one
    draw, ``kwargs`` ``n_samples`` (multisample methods) or ``component``
    (Rank-1 mixtures). Returns ``[n_samples, ...]`` stacked outputs."""
    if method.multisample:
        # one forward of all S (reference ensemble.py:34-35); a multisample
        # model returns [B, ...] at S = 1, restored to [1, B, ...] here
        params, model_state = method.sample(state, noise, 0)
        out = apply_fn(params, model_state, noise, x, n_samples=n_samples)
        return out[None] if n_samples == 1 else out

    def kwargs(i):
        return {"component": i % components} if components > 1 else {}

    if method.sample_is_identity:
        params, model_state = method.sample(state, noise, 0)
        return torch.stack([apply_fn(params, model_state, noise, x, **kwargs(i)) for i in range(n_samples)])
    outs = []
    for i in range(n_samples):
        params, model_state = method.sample(state, noise, i)
        outs.append(apply_fn(params, model_state, noise, x, **kwargs(i)))
    return torch.stack(outs)
