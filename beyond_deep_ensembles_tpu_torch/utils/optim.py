"""The optimizers, with their state, their schedule and the posterior
methods' NaN guard on the device.

Counterparts of the JAX package's optax chains: ``add_decayed_weights(wd)``
then ``sgd(schedule, momentum, nesterov)`` (CIFAR, ``experiments/cifar.py::
_base_tx``) as :class:`SGD`; ``add_decayed_weights(wd)`` then ``adam(lr)``
on every parameter but the ``__mle`` ones and ``sgd(var_lr)`` on those (UCI,
``experiments/uci.py::_base_tx``, an ``optax.multi_transform``) as
:class:`Adam` and :class:`SGD` under :func:`mle_split`; and their guards
(``tree.tree_where`` over the parameters and ``opt_state``,
``methods/bbb.py:97-107``, ``methods/svgd.py:158-165``).

:class:`SGD` rebinds its parameters as views into one flat buffer and keeps
the momentum (optax's ``trace``, zeros at the start, so the first step is
the steady formula) in another and the update count in an int64 tensor,
all on the parameters' device. The learning rate is computed there from the
count by the optimizer's ``schedule`` (count -> rate, as an optax schedule),
never read on the host. A
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

    with lr = ``schedule(count)`` at the count before the step (an optax
    schedule: the rate itself, e.g. ``lr * factor(count // steps_per_epoch)``
    of an epoch schedule, or ``utils/schedules.py::cosine_with_warmup``), the
    constant ``lr`` without one. A parameter without a gradient
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
    ):
        self.params = list(params)
        if not self.params:
            raise ValueError("SGD got no parameters")
        self.lr0, self.momentum, self.nesterov = lr, momentum, nesterov
        self.weight_decay, self.schedule = weight_decay, schedule
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
        _load_buffers(self, state, ("flat", "trace", "count"))
        self.lr0 = float(state["lr"])

    def zero_grad(self, set_to_none: bool = True) -> None:
        del set_to_none  # gradients are always dropped: the step gathers them
        for p in self.params:
            p.grad = None

    def lr(self) -> torch.Tensor:
        """The learning rate of the next step, an fp32 tensor on the device."""
        if self.schedule is None:
            return torch.full((), self.lr0, dtype=torch.float32, device=self.flat.device)
        return self.schedule(self.count)

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



class Adam:
    """optax ``add_decayed_weights(weight_decay)`` (coupled L2, when set) then
    ``adam(lr, b1, b2, eps)`` over one flat buffer, per element:

        g = grad + weight_decay * p
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g^2 + b2 * nu
        p = p + (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) * -lr

    with t the count after the step, ``b^t`` in fp32 on the device, as optax
    takes it (fp64 bias corrections, ``torch.optim.Adam``'s, differ from it
    by about 4e-5 lr a step). With a ``schedule`` the lr is
    ``schedule(count)`` at the count before the step, on the device (optax's
    ``scale_by_schedule``), as :class:`SGD`'s. The moments
    and the int64 count live on the parameters' device, the parameters are
    rebound as views of :attr:`flat` (as :class:`SGD`'s), and :meth:`step`
    takes the posterior methods' guard, so a CUDA graph can capture the whole
    step."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        schedule: Optional[Callable] = None,
    ):
        self.params = list(params)
        if not self.params:
            raise ValueError("Adam got no parameters")
        self.lr0, self.b1, self.b2, self.eps, self.weight_decay = lr, b1, b2, eps, weight_decay
        self.schedule = schedule
        self.flat = flatten_parameters(self.params)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int64, device=self.flat.device)

    def tensors(self):
        """Every tensor a step writes: parameters, moments, count."""
        return [self.flat, self.mu, self.nu, self.count]

    def state_dict(self) -> dict:
        """The flat parameter and moment buffers, the count and the lr (the
        live tensors, not copies)."""
        return {"flat": self.flat, "mu": self.mu, "nu": self.nu, "count": self.count,
                "lr": torch.tensor(self.lr0, dtype=torch.float64)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copies a :meth:`state_dict` into the buffers in place (as
        :meth:`SGD.load_state_dict`)."""
        _load_buffers(self, state, ("flat", "mu", "nu", "count"))
        self.lr0 = float(state["lr"])

    def zero_grad(self, set_to_none: bool = True) -> None:
        del set_to_none
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, ok: Optional[torch.Tensor] = None) -> None:
        """One update; with ``ok`` (a 0-dim bool tensor) only where it holds,
        the parameters, moments and count otherwise left as they were."""
        grad = flat_grad(self.params)
        if self.weight_decay:
            grad = grad + self.weight_decay * self.flat
        mu = (1 - self.b1) * grad + self.b1 * self.mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * self.nu
        count = self.count + 1
        t = count.to(torch.float32)
        # a Python base: no host tensor to copy, so a CUDA graph can capture it
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if self.schedule is None:
            new_flat = self.flat + update * -self.lr0
        else:
            new_flat = self.flat + update * -self.schedule(self.count)
        new = [new_flat, mu, nu, count]
        if ok is not None:
            new = tree_where(ok, new, self.tensors())
        for old, value in zip(self.tensors(), new):
            old.copy_(value)


def _load_buffers(optimizer, state: dict, names) -> None:
    """Copies ``state``'s ``names`` into ``optimizer``'s buffers of the same
    names, in place; the keys must be ``names`` and ``lr``."""
    if state.keys() != set(names) | {"lr"}:
        raise KeyError(f"a {type(optimizer).__name__} state has {sorted(names)} and lr, got {sorted(state)}")
    for name in names:
        mine, theirs = getattr(optimizer, name), state[name]
        if mine.shape != theirs.shape or mine.dtype != theirs.dtype:
            raise ValueError(f"{type(optimizer).__name__} {name}: {tuple(theirs.shape)} {theirs.dtype} does not fit "
                             f"{tuple(mine.shape)} {mine.dtype}")
        mine.copy_(theirs)


class Split:
    """Two optimizers over disjoint parameter lists, stepped together under
    one guard: ``main`` and ``mle`` (optax ``multi_transform``). Its state is
    both states, keys ``main.*`` and ``mle.*``."""

    def __init__(self, main, mle):
        self.main, self.mle = main, mle

    def tensors(self):
        return self.main.tensors() + self.mle.tensors()

    def state_dict(self) -> dict:
        return {f"{part}.{k}": v for part in ("main", "mle") for k, v in getattr(self, part).state_dict().items()}

    def load_state_dict(self, state: dict) -> None:
        for part in ("main", "mle"):
            prefix = part + "."
            getattr(self, part).load_state_dict({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.main.zero_grad(set_to_none)
        self.mle.zero_grad(set_to_none)

    def step(self, ok: Optional[torch.Tensor] = None) -> None:
        self.main.step(ok)
        self.mle.step(ok)


def mle_split(mle_params: Iterable[torch.nn.Parameter], main: Callable, mle: Callable) -> Callable:
    """``tx(params) -> (optimizer, None)`` for the posterior methods, which
    hand ``tx`` their parameters without names: ``mle_params`` (the ``__mle``
    parameters of the models the method will train, found by name before the
    method sees them) are told apart by identity. ``main(params)`` builds the
    optimizer of the others, ``mle(params)`` that of the ``mle_params``; the
    two are a :class:`Split`, or ``main``'s alone where ``params`` holds none
    of ``mle_params``."""
    mle_ids = {id(p) for p in mle_params}

    def tx(params):
        params = list(params)
        var = [p for p in params if id(p) in mle_ids]
        optimizer = main([p for p in params if id(p) not in mle_ids])
        return (Split(optimizer, mle(var)) if var else optimizer), None

    return tx
