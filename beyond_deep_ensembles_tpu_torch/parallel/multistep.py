"""Runners: K optimizer steps, a whole epoch, or a whole test set per host
call, replayed from CUDA graphs on a card.

Counterpart of ``beyond_deep_ensembles_tpu/parallel/multistep.py``, with its
functions' names and contracts. There K steps fold into one ``lax.scan``
program; here an update (or a batch's posterior prediction) is captured
once into a ``torch.cuda.CUDAGraph`` with static input buffers and a device
key, and replayed: the host launches one graph a step instead of several
thousand kernels, and reads the device once per epoch (the divergence
check). Everything random inside a step comes from the device key through a
key-mode ``NoiseSource`` (``nn/gaussian.py``, ``keys.py``), so a replay
draws afresh once the key has moved on, and an eager run from the same key
gives the same bits (:func:`eager_steps`, which the CPU takes).

Capture, on a card:
  * warm-up: one update on a side stream, so that cuDNN and cuBLAS have
    chosen their algorithms and workspaces, Triton has compiled K1 and K2's
    counter is zeroed (``ops/svgd_kernel.py``) before capture; the warm-up
    changes the state, so every tensor the update writes, as the state
    lists them (``written_tensors``: the parameters, the optimizer's
    buffers and count, SWAG's moments, ring and counters, every ensemble
    member's), is saved before and written back after, with ``state.step``;
  * one update captured, its metrics added into device sums and the key
    advanced (``keys.advance``) inside the graph, as ``make_multi_step``
    splits its key into one per step;
  * replays: each copies its batch into the static buffers and replays.
Python's cycle collector is run before a capture and kept off during it
(:func:`_capturing`). A capture that fails raises; nothing falls back to
eager steps. The graph
holds the state's tensors, so a runner recaptures when it is handed another
state. The update's optimizer must have its state before its first step
(the port's ``utils/optim.py::SGD``). Launch counters on the kernel wrappers
count the warm-up and the capture, never a replay.

Under a process group (``parallel/mesh.py``) the update is a
``ParallelTrainer.update``, whose NCCL collectives the graph captures with
the rest (the warm-up makes their first calls). A gloo group's collectives
run on the host and cannot be captured: a capture under one raises. A
runner made with ``capture=False`` runs its steps eagerly on a card too
(:func:`eager_steps`), as the engines' flagged runs over gloo do.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import keys
from ..nn.gaussian import NoiseSource
from . import mesh

# eager calls before a capture: one makes every first call (cuDNN, cuBLAS,
# Triton's compile, K2's counter word) outside the capture
_WARMUP = 1


def stack_batches(batches: Sequence[Tuple[torch.Tensor, ...]]) -> Tuple[torch.Tensor, ...]:
    """A list of (x, y, ...) minibatches -> one tuple with a leading axis k."""
    return tuple(torch.stack(parts) for parts in zip(*batches))


def _unstack(stacked: Tuple[torch.Tensor, ...]):
    return [tuple(t[i] for t in stacked) for i in range(stacked[0].shape[0])]


def eager_steps(update: Callable, state, key: int, batches):
    """The steps a runner's replays make, run eagerly: ``update(state,
    NoiseSource(key=k), batch)`` for each batch, k starting at ``key`` and
    advanced after each step. Returns ``(state, metric sums)``."""
    k = keys.as_key(key, batches[0][0].device)
    sums = {}
    for batch in batches:
        state, metrics = update(state, NoiseSource(key=k), batch)
        for name, value in metrics.items():
            sums[name] = sums[name] + value if name in sums else value
        k = keys.advance(k)
    return state, sums


def _written_tensors(state):
    """Every tensor an update writes in place, as the state itself lists
    them (``MethodState.written_tensors``: the parameters and the
    optimizer's buffers; SWAG's moments, ring and counters besides; an
    ensemble's, every member's)."""
    written = getattr(state, "written_tensors", None)
    if written is None:
        raise TypeError(f"a {type(state).__name__} does not list the tensors its update writes")
    return written()


@contextlib.contextmanager
def _capturing(graph: torch.cuda.CUDAGraph):
    """``torch.cuda.graph(graph)`` with Python's cycle collector run first
    and kept off until the capture ends: an unreachable cycle that holds
    another graph (an earlier run's eval runner, say, whose prediction
    closure refers back to its experiment) would otherwise be collected in
    the middle of the capture, and a graph destroyed during a capture
    invalidates it. Raises under a gloo process group."""
    if mesh.is_distributed() and torch.distributed.get_backend() != "nccl":
        raise RuntimeError(
            f"a CUDA graph cannot capture the collectives of a {torch.distributed.get_backend()} process group "
            "(they run on the host): make the runner with capture=False, or launch the ranks on NCCL")
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            yield
    finally:
        if enabled:
            gc.enable()


def _warm_up(update: Callable, state, key: torch.Tensor, batch: Tuple[torch.Tensor, ...]) -> dict:
    """``_WARMUP`` updates, after which every tensor the update writes
    (:func:`_written_tensors`) and ``state.step`` are as they were: so that
    cuDNN, cuBLAS and the kernels have made their first calls before a
    capture, on the state the capture will hold. Returns the last
    metrics."""
    written = _written_tensors(state)
    with torch.no_grad():
        saved = [t.clone() for t in written]
    step = state.step
    for _ in range(_WARMUP):
        _, metrics = update(state, NoiseSource(key=key), batch)
    with torch.no_grad():
        for t, s in zip(written, saved):
            t.copy_(s)
    state.step = step
    return metrics


class _StepGraph:
    """One update captured with static batch buffers and a device key."""

    def __init__(self, update: Callable, state, batch: Tuple[torch.Tensor, ...]):
        device = batch[0].device
        self.state = state
        self.batch = tuple(t.clone() for t in batch)
        self.key = torch.zeros((), dtype=torch.int64, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            metrics = _warm_up(update, state, self.key, self.batch)
        torch.cuda.current_stream(device).wait_stream(side)
        self.sums = {name: torch.zeros_like(value) for name, value in metrics.items()}
        step = state.step
        self.graph = torch.cuda.CUDAGraph()
        with _capturing(self.graph):  # records the writes; runs none of them
            _, metrics = update(state, NoiseSource(key=self.key), self.batch)
            for name, value in metrics.items():
                self.sums[name].add_(value)
            self.key.copy_(keys.advance(self.key))
        state.step = step

    def run(self, key: int, batches) -> dict:
        """Replays, one per batch, from ``key``; the metrics' means."""
        self.key.fill_(key)
        for value in self.sums.values():
            value.zero_()
        for batch in batches:
            for static, t in zip(self.batch, batch):
                static.copy_(t)
            self.graph.replay()
        self.state.step += len(batches)
        return {name: value / len(batches) for name, value in self.sums.items()}


class _Captured:
    """A runner's graph, captured at its first call on a card and again
    when the runner is handed another state."""

    def __init__(self, make: Callable):
        self.make = make
        self.graph = None

    def get(self, state, *args):
        if self.graph is None or self.graph.state is not state:
            self.graph = None  # free the old graph's memory before capturing
            self.graph = self.make(state, *args)
        return self.graph


def _run_steps(captured: _Captured, update: Callable, state, key: int, batches, capture: bool = True):
    if batches[0][0].is_cuda and capture:
        return state, captured.get(state, batches[0]).run(key, batches)
    state, sums = eager_steps(update, state, key, batches)
    return state, {name: value / len(batches) for name, value in sums.items()}


def make_multi_step(update: Callable, k: int, capture: bool = True):
    """Returns ``multi(state, key, stacked_batches) -> (state, metrics)``:
    ``k`` updates, one per batch of ``stacked_batches`` (a tuple of tensors
    with leading axis ``k``), the metrics averaged over them, from the host
    key ``key``. On a card the update is captured once and replayed ``k``
    times (unless ``capture`` is False); on the CPU the same steps run
    eagerly."""
    captured = _Captured(lambda state, batch: _StepGraph(update, state, batch))

    def multi(state, key: int, stacked_batches):
        batches = _unstack(stacked_batches)
        if len(batches) != k:
            raise ValueError(f"expected {k} stacked batches, got {len(batches)}")
        return _run_steps(captured, update, state, key, batches, capture)

    return multi


def make_epoch_runner(
    update: Callable,
    n_data: int,
    batch_size: int,
    epoch_transform: Optional[Callable] = None,
    capture: bool = True,
):
    """Whole-epoch training over data resident on the device. Returns
    ``epoch(state, key, data) -> (state, metrics)``, ``key`` a host int,
    ``data`` a tuple of tensors with leading axis ``n_data``: the epoch's
    permutation drawn on the device from the key (the argsort of distinct
    counter-hash values, ``keys.bits``), one bulk gather, then
    ``epoch_transform(key, data)`` (one bulk augmentation pass, say) where
    given, then ``n_data // batch_size`` updates over contiguous slices (the
    remainder dropped, as the JAX runner drops it), the metrics averaged.
    The three keys are ``fold_in(key, 0)`` (permutation), ``1`` (transform)
    and ``2`` (the steps'). ``capture`` as :func:`make_multi_step`'s."""
    steps = n_data // batch_size
    if steps < 1:
        raise ValueError(f"{n_data} examples make no batch of {batch_size}")
    captured = _Captured(lambda state, batch: _StepGraph(update, state, batch))

    def epoch(state, key: int, data: Tuple[torch.Tensor, ...]):
        if any(d.shape[0] != n_data for d in data):
            raise ValueError(f"the runner was made for {n_data} examples")
        device = data[0].device
        perm = torch.argsort(keys.bits(keys.fold_in(key, 0), 0, n_data, device))[: steps * batch_size]
        shuffled = tuple(d[perm] for d in data)
        if epoch_transform is not None:
            shuffled = epoch_transform(keys.fold_in(key, 1), shuffled)
        batches = [tuple(d[i * batch_size : (i + 1) * batch_size] for d in shuffled) for i in range(steps)]
        return _run_steps(captured, update, state, keys.fold_in(key, 2), batches, capture)

    return epoch


class _PredictGraph:
    """``predict_batch`` captured for one batch shape, with a static input
    and a device key."""

    def __init__(self, predict_batch: Callable, state, x: torch.Tensor):
        device = x.device
        self.state = state
        self.x = x.clone()
        self.key = torch.zeros((), dtype=torch.int64, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(_WARMUP):
                    predict_batch(state, self.key, self.x)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with _capturing(self.graph):
                self.out = predict_batch(state, self.key, self.x)

    def run(self, key: int, x: torch.Tensor) -> torch.Tensor:
        self.key.fill_(key)
        self.x.copy_(x)
        self.graph.replay()
        return self.out


def make_eval_runner(predict_batch: Callable, n_data: int, batch_size: int, capture: bool = True):
    """Whole-test-set evaluation over data resident on the device.

    ``predict_batch(state, key, xb)`` -> per-example outputs with leading axis
    ``batch_size`` (BMA log-marginals, say), ``key`` a 0-dim int64 tensor.
    Returns ``run(state, key, x) -> outputs [n_data, ...]``, ``key`` a host
    int: batch i runs under ``fold_in(key, i)``; the last partial batch is
    padded by repeating its last row on the device and trimmed after, so
    every point counts once. On a card ``predict_batch`` is captured once
    (per state) and replayed once per batch (unless ``capture`` is False);
    on the CPU it runs eagerly."""
    n_batches = -(-n_data // batch_size)
    padded = n_batches * batch_size
    captured = _Captured(lambda state, x: _PredictGraph(predict_batch, state, x))

    def run(state, key: int, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != n_data:
            raise ValueError(f"the runner was made for {n_data} examples, got {x.shape[0]}")
        if padded > n_data:
            x = torch.cat([x, x[-1:].expand(padded - n_data, *x.shape[1:])])
        batches = [x[i * batch_size : (i + 1) * batch_size] for i in range(n_batches)]
        if not (x.is_cuda and capture):
            with torch.no_grad():
                outs = [predict_batch(state, keys.as_key(keys.fold_in(key, i), x.device), xb)
                        for i, xb in enumerate(batches)]
            return torch.cat(outs)[:n_data]
        graph = captured.get(state, batches[0])
        out = None
        for i, xb in enumerate(batches):
            o = graph.run(keys.fold_in(key, i), xb)
            if out is None:
                out = torch.empty((padded,) + tuple(o.shape[1:]), dtype=o.dtype, device=o.device)
            out[i * batch_size : (i + 1) * batch_size].copy_(o)
        return out[:n_data]

    return run
