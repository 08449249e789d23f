"""Profiling / tracing utilities.

Counterpart of ``beyond_deep_ensembles_tpu/utils/profiling.py`` (reference
script_utils.py:151-170 ``time_fn``): a wall-clock timer that waits for the
card before it reads the clock, a ``torch.profiler`` trace written as a
Chrome trace, and an EMA step timer.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable

import torch


def _on_cuda(result) -> bool:
    """True when any tensor in ``result`` (nested in tuples, lists or dicts)
    lives on a card."""
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_cuda(v) for v in result.values())
    if isinstance(result, (tuple, list)):
        return any(_on_cuda(v) for v in result)
    return False


def time_fn(fn: Callable) -> Callable:
    """Returns ``(result, elapsed_seconds)``; when the result holds a tensor
    on a card, the clock is read after ``torch.cuda.synchronize()``, so the
    time covers the work queued, not only its launch."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if _on_cuda(result):
            torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    return wrapped


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card is
    present), written on exit as ``<log_dir>/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """EMA step timer for training-loop telemetry."""

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.ema = None
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        self._last = now
        return self.ema
