"""Last-layer Bayesian composition.

Counterpart of ``beyond_deep_ensembles_tpu/methods/last_layer.py``
(reference LastLayerBayesianOptimizer, src/algos/algo.py:83-133): a
Bayesian method over the model's head composed with a deterministic
optimizer over the rest, the backbone: the WILDS tasks' ``swag_ll``,
``ll_ivon``, ``ll_svgd`` and ``ll_bbb`` variants.

The head is a :class:`HeadView`: the head's layers (the whole layers whose
parameters ``mask_fn`` selects) registered again under their own paths in a
module of their own, whose forward runs the whole model with the view's
parameters in place of the head's (``torch.func.functional_call``). The
inner method is handed the view, so it owns, steps, ravels and samples the
head alone (its draws are mappings under the model's own parameter names,
which ``nn/base.py::Model.apply`` runs through the whole model), while every
backward it makes reaches the backbone's live parameters too.

An update zeroes the backbone's gradients, runs the inner update, then steps
the backbone optimizer: the backbone's gradient is the SUM of every backward
the inner method made (the JAX ``joint`` differentiates the inner update's
``backbone_loss``, :125-158: SVGD's particles and iVON's MC draws each add
theirs; BBB's one backward carries ``data_loss / mc_samples``), as the
reference accumulates them (algo.py:96-104). The inner methods zero and step
only their own optimizer's parameters, the head's, and the composition never
scales the sum down to a mean. The backbone step is not guarded, as in JAX.

``head_particles`` > 0 (last-layer SVGD, reference iwildcam
models.py:123-154): the inner method runs over that many views, each a copy
of the head perturbed leaf by leaf, ``l + l.std() * eps`` (JAX :99-112,
``eps`` from the composition's generator), all on the one backbone; the
model's own head layers then only hold the initial values.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from .api import LossFn, PosteriorMethod
from .laplace import last_layer_mask


class HeadView(nn.Module):
    """The head layers of ``model`` as a module: ``layers`` maps each layer's
    dotted path in ``model`` to the layer (the model's own, or a copy).
    ``forward(*inputs, **kwargs)`` runs ``model`` with this view's parameters
    in place of the head's. ``model`` is held outside the module tree, so
    ``parameters()`` and ``state_dict()`` are the head's alone, under the
    model's names."""

    def __init__(self, model: nn.Module, layers: dict):
        super().__init__()
        for path, layer in layers.items():
            parent = self
            *scopes, leaf = path.split(".")
            for scope in scopes:
                if not hasattr(parent, scope):
                    parent.add_module(scope, nn.Module())
                parent = getattr(parent, scope)
            parent.add_module(leaf, layer)
        object.__setattr__(self, "model", model)

    def forward(self, *inputs, **kwargs):
        return torch.func.functional_call(self.model, dict(self.named_parameters()), inputs, kwargs)


def head_layers(model: nn.Module, mask: dict) -> dict:
    """``{path: layer}`` of the layers whose parameters ``mask`` selects;
    a layer must be selected whole."""
    owners = {name.rsplit(".", 1)[0] for name, selected in mask.items() if selected}
    if not owners or "" in owners:
        raise ValueError("the last-layer mask selects no layer")
    layers = {path: model.get_submodule(path) for path in sorted(owners)}
    for path, layer in layers.items():
        for name, _ in layer.named_parameters():
            if not mask[f"{path}.{name}"]:
                raise ValueError(f"the last-layer mask selects part of {path!r}")
    return layers


@torch.no_grad()
def perturbed_copy(layers: dict, generator: torch.Generator) -> dict:
    """Copies of ``layers`` with every parameter ``l + l.std() * eps``,
    ``eps`` standard normal from ``generator`` (a CPU generator; the std is
    the population one, as ``jnp.std``)."""
    out = {}
    for path, layer in layers.items():
        layer = copy.deepcopy(layer)
        for p in layer.parameters():
            eps = torch.randn(tuple(p.shape), generator=generator).to(p.device)
            p.add_(p.std(unbiased=False) * eps)
        out[path] = layer
    return out


def split_params(params, mask: dict) -> tuple:
    """``(backbone, head)``: the named parameters of ``params`` (a module or
    a mapping) split by ``mask`` (name -> True for the head), each side a
    dict over every name, the other side's entries zero-size placeholders
    (JAX ``split_params``: their emptiness encodes the mask)."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)

    def empty(p):
        return torch.zeros((0,), dtype=p.dtype, device=p.device)

    head = {k: p if mask[k] else empty(p) for k, p in named.items()}
    backbone = {k: empty(p) if mask[k] else p for k, p in named.items()}
    return backbone, head


def merge_params(backbone: dict, head: dict) -> dict:
    """The inverse of :func:`split_params`: each name's non-empty entry."""
    return {k: head[k] if b.numel() == 0 else b for k, b in backbone.items()}


@dataclasses.dataclass
class LastLayerState:
    """``inner``: the inner method's state over the head view(s);
    ``model``: the whole model; ``backbone``: its parameters outside the
    head (by name) and ``backbone_opt`` their optimizer. ``params`` is the
    whole model (its head the initial one under ``head_particles``)."""

    inner: Any
    model: nn.Module
    backbone: dict
    backbone_opt: Any
    step: int = 0
    epoch: int = 0

    @property
    def params(self) -> nn.Module:
        return self.model

    @property
    def model_state(self):
        return self.inner.model_state

    def written_tensors(self) -> list:
        return (self.inner.written_tensors() + [p.detach() for p in self.backbone.values()]
                + list(self.model.buffers()) + list(self.backbone_opt.tensors()))

    def state_dict(self) -> dict:
        out = {f"inner.{k}": v for k, v in self.inner.state_dict().items()}
        out.update({f"backbone.{k}": p for k, p in self.backbone.items()})
        out.update({f"backbone_opt.{k}": v for k, v in self.backbone_opt.state_dict().items()})
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        out["epoch"] = torch.tensor(self.epoch, dtype=torch.int64)
        return out

    def load_state_dict(self, state: dict) -> None:
        mine = self.state_dict()
        if mine.keys() != state.keys():
            raise KeyError(f"last-layer state keys differ: {sorted(mine.keys() ^ state.keys())[:8]}")

        def part(prefix):
            return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

        self.inner.load_state_dict(part("inner."))
        with torch.no_grad():
            for name, value in part("backbone.").items():
                self.backbone[name].copy_(value)
        self.backbone_opt.load_state_dict(part("backbone_opt."))
        self.step, self.epoch = int(state["step"]), int(state["epoch"])


def last_layer_method(
    loss_fn: LossFn,
    inner_factory: Callable[[LossFn], PosteriorMethod],
    backbone_tx: Callable,
    mask_fn: Callable = last_layer_mask,
    head_particles: int = 0,
    generator: Optional[torch.Generator] = None,
) -> PosteriorMethod:
    """``inner_factory(loss_fn)`` -> the inner method, which will own only
    the head view(s); ``backbone_tx(params) -> (optimizer, None)`` steps the
    rest; ``mask_fn(model) -> {name: bool}`` selects the head (default: the
    last dense layer, ``methods/laplace.py::last_layer_mask``).
    ``generator`` draws the particles' perturbations (``head_particles``)."""
    inner = inner_factory(loss_fn)

    def init(params: nn.Module, model_state=None):
        mask = mask_fn(params)
        layers = head_layers(params, mask)
        if head_particles:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            head = nn.ModuleList(HeadView(params, perturbed_copy(layers, gen)) for _ in range(head_particles))
        else:
            head = HeadView(params, layers)
        inner_state = inner.init(head, model_state)
        backbone = {n: p for n, p in params.named_parameters() if not mask[n] and p.requires_grad}
        optimizer, _ = backbone_tx(list(backbone.values()))
        return LastLayerState(inner=inner_state, model=params, backbone=backbone, backbone_opt=optimizer)

    def update(state: LastLayerState, noise, batch):
        state.backbone_opt.zero_grad(set_to_none=True)
        state.inner, metrics = inner.update(state.inner, noise, batch)
        state.backbone_opt.step()
        state.step += 1
        return state, metrics

    def sample(state: LastLayerState, noise=None, index=None):
        return inner.sample(state.inner, noise, index)

    def finalize_epoch(state: LastLayerState):
        state.inner = inner.finalize_epoch(state.inner)
        state.epoch += 1
        return state

    return PosteriorMethod(
        init=init,
        update=update,
        sample=sample,
        finalize_epoch=finalize_epoch,
        sample_is_identity=inner.sample_is_identity,
        multisample=inner.multisample,
    )
