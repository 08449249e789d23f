"""Checkpoint / resume.

Counterpart of ``beyond_deep_ensembles_tpu/utils/checkpoint.py``, with its
names and contracts: periodic saves ``<run_dir>/checkpoint_<step>``
(reference cifar.py:175-176), a ``{model}_final`` at the end (cifar.py:98)
that the downstream phases read, and auto-resume from the latest
``checkpoint_<step>`` (bnn_hmc/utils/checkpoint_utils.py:80-96).

A checkpoint is one ``torch.save`` of a flat dict of CPU tensors, the
state's ``state_dict()`` (``methods/api.py::MethodState``: parameters,
optimizer buffers, counters; SWAG's moments and ring; every ensemble
member's), loadable with ``weights_only=True``. A restore copies it into a
template state in place (``load_state_dict``), so the optimizer's views and
a captured graph's addresses stay valid. A file is written under a
temporary name and renamed, so a crash mid-write leaves no
``checkpoint_<step>``.

Asynchronous saves: the state is overwritten in place by the next update
(unlike the JAX package's functional state), so ``save_checkpoint(...,
async_save=True)`` copies it to the host before it returns, and only the
file write runs in a thread, behind the next epoch's steps. Each run
directory has its own saver (one write in flight; a new save, a scan or a
restore of that directory waits for it), so a failed write surfaces in its
own run, at its next wait; :func:`wait_for_async_saves` is the barrier, and
the experiment loops call it in a ``finally``.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import torch

_CKPT_RE = re.compile(r"checkpoint_(\d+)$")


class _AsyncSaver:
    """One background file write at a time for one run directory; its
    error is raised by the next :meth:`wait`."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, path: str, tensors: Dict[str, torch.Tensor]) -> None:
        self.wait()

        def _write():
            try:
                _write_file(path, tensors)
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=_write, name="bde-ckpt-save", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._err = self._err, None
        if err is not None:
            raise err


_SAVERS: Dict[str, _AsyncSaver] = {}
_SAVERS_LOCK = threading.Lock()


def _saver(run_dir: str) -> _AsyncSaver:
    with _SAVERS_LOCK:
        return _SAVERS.setdefault(os.path.abspath(run_dir), _AsyncSaver())


def _host_copy(state: Any) -> Dict[str, torch.Tensor]:
    """The state's tensors copied to the host, complete when this returns."""
    return {k: v.detach().to("cpu", copy=True) for k, v in state.state_dict().items()}


def _write_file(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    tmp = f"{path}.tmp"
    torch.save(tensors, tmp)
    os.replace(tmp, path)


def wait_for_async_saves(run_dir: Optional[str] = None) -> None:
    """Barrier: block until the in-flight write of ``run_dir`` (of every
    run directory when None) has committed, and re-raise its error."""
    if run_dir is not None:
        _saver(run_dir).wait()
        return
    with _SAVERS_LOCK:
        savers = list(_SAVERS.values())
    for saver in savers:
        saver.wait()


def save_checkpoint(run_dir: str, step: int, state: Any, async_save: bool = False) -> str:
    """Write ``<run_dir>/checkpoint_<step>``. With ``async_save`` only the
    file write overlaps what follows; the state may change as soon as this
    returns."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(run_dir), f"checkpoint_{step}")
    tensors = _host_copy(state)
    if async_save:
        _saver(run_dir).save(path, tensors)
    else:
        _saver(run_dir).wait()
        _write_file(path, tensors)
    return path


def save_final(run_dir: str, name: str, state: Any) -> str:
    """The ``{name}_final`` artifact the downstream phases read (reference
    cifar.py:98)."""
    _saver(run_dir).wait()
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(run_dir), f"{name}_final")
    _write_file(path, _host_copy(state))
    return path


def latest_checkpoint_step(run_dir: str) -> Optional[int]:
    _saver(run_dir).wait()
    if not os.path.isdir(run_dir):
        return None
    steps = [int(m.group(1)) for m in map(_CKPT_RE.match, os.listdir(run_dir)) if m]
    return max(steps) if steps else None


def _load_into(path: str, template: Any) -> Any:
    template.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return template


def restore_checkpoint(run_dir: str, state_template: Any, step: Optional[int] = None):
    """Restore the given (or latest) checkpoint into ``state_template`` in
    place; returns ``(state, step)``, or ``(template, None)`` when there is
    nothing to resume from (reference maybe_restore,
    checkpoint_utils.py:80-96)."""
    if step is None:
        step = latest_checkpoint_step(run_dir)
        if step is None:
            return state_template, None
    path = os.path.join(os.path.abspath(run_dir), f"checkpoint_{step}")
    return _load_into(path, state_template), step


def restore_final(run_dir: str, name: str, state_template: Any) -> Any:
    """``{name}_final`` restored into ``state_template`` in place."""
    _saver(run_dir).wait()
    return _load_into(os.path.join(os.path.abspath(run_dir), f"{name}_final"), state_template)
