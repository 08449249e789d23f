"""The CIFAR optimizer, with its state, its schedule and the posterior
methods' NaN guard on the device.

Counterpart of the JAX package's optax chain ``add_decayed_weights(wd)`` then
``sgd(schedule, momentum, nesterov)`` (``experiments/cifar.py::_base_tx``)
and of its guards (``tree.tree_where`` over the parameters and ``opt_state``,
``methods/bbb.py:97-107``, ``methods/svgd.py:158-165``).

:class:`SGD` rebinds its parameters as views into one flat buffer and keeps
the momentum (optax's ``trace``, zeros at the start, so the first step is
the steady formula) in another and the update count in an int64 tensor,
all on the parameters' device. The learning rate is computed there from the
count, ``lr * factor(count // steps_per_epoch)``, never read on the host. A
step is a few elementwise passes over the flat buffers whatever the number
of parameter tensors, and :meth:`SGD.step` with a predicate keeps the old
parameters, momentum and count where it is false (``tree_where``), so a CUDA
graph can capture the whole step, guard included.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from ..tree import tree_where


@torch.no_grad()
def flatten_parameters(params) -> torch.Tensor:
    """One flat buffer holding ``params`` (a list of parameters, on one
    device) in order, each parameter rebound as a view of it: a write to the
    buffer is a write to the module's weights."""
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    start = 0
    for p in params:
        p.data = flat[start : start + p.numel()].view_as(p)
        start += p.numel()
    return flat


def flat_grad(params) -> torch.Tensor:
    """The parameters' gradients as one flat vector, zero where a parameter
    has none (as JAX's ``grad`` gives)."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])


class SGD:
    """optax ``add_decayed_weights(weight_decay)`` then ``sgd`` over one flat
    buffer, per element:

        g = grad + weight_decay * p
        trace = g + momentum * trace
        p = p - lr * (g + momentum * trace if nesterov else trace)

    with lr = ``lr * schedule(count // steps_per_epoch)`` at the count before
    the step (constant without a schedule). A parameter without a gradient
    takes a zero one, as JAX's ``grad`` gives. Parameters are rebound as
    views of :attr:`flat`, in the order given, so build the optimizer after
    the module has moved to its device."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float,
        momentum: float = 0.0,
        nesterov: bool = False,
        weight_decay: float = 0.0,
        schedule: Optional[Callable] = None,
        steps_per_epoch: int = 1,
    ):
        self.params = list(params)
        if not self.params:
            raise ValueError("SGD got no parameters")
        self.lr0, self.momentum, self.nesterov = lr, momentum, nesterov
        self.weight_decay, self.schedule, self.steps_per_epoch = weight_decay, schedule, steps_per_epoch
        self.flat = flatten_parameters(self.params)
        self.trace = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int64, device=self.flat.device)

    def tensors(self):
        """Every tensor a step writes: parameters, momentum, count."""
        return [self.flat, self.trace, self.count]

    def state_dict(self) -> dict:
        """The flat parameter and momentum buffers, the count and the lr
        (the live tensors, not copies)."""
        return {"flat": self.flat, "trace": self.trace, "count": self.count,
                "lr": torch.tensor(self.lr0, dtype=torch.float64)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copies a :meth:`state_dict` into the buffers in place: the
        parameters are views of :attr:`flat`, and a captured graph holds the
        buffers' addresses. The lr is a host number that a graph captured
        before the load keeps."""
        if state.keys() != {"flat", "trace", "count", "lr"}:
            raise KeyError(f"an SGD state has flat, trace, count and lr, got {sorted(state)}")
        for name in ("flat", "trace", "count"):
            mine, theirs = getattr(self, name), state[name]
            if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
                raise ValueError(f"SGD {name}: {tuple(theirs.shape)} {theirs.dtype} does not fit "
                                 f"{tuple(mine.shape)} {mine.dtype}")
            mine.copy_(theirs)
        self.lr0 = float(state["lr"])

    def zero_grad(self, set_to_none: bool = True) -> None:
        del set_to_none  # gradients are always dropped: the step gathers them
        for p in self.params:
            p.grad = None

    def lr(self) -> torch.Tensor:
        """The learning rate of the next step, an fp32 tensor on the device."""
        if self.schedule is None:
            return torch.full((), self.lr0, dtype=torch.float32, device=self.flat.device)
        return self.lr0 * self.schedule(self.count // self.steps_per_epoch)

    @torch.no_grad()
    def step(self, ok: Optional[torch.Tensor] = None) -> None:
        """One update; with ``ok`` (a 0-dim bool tensor) only where it holds,
        the parameters, momentum and count otherwise left as they were."""
        grad = flat_grad(self.params)
        if self.weight_decay:
            grad = grad + self.weight_decay * self.flat
        trace = grad + self.momentum * self.trace
        update = grad + self.momentum * trace if self.nesterov else trace
        new = [self.flat - self.lr() * update, trace, self.count + 1]
        if ok is not None:
            new = tree_where(ok, new, self.tensors())
        for old, value in zip(self.tensors(), new):
            old.copy_(value)

