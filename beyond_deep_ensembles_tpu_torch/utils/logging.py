"""Run logging: human lines on stdout, JSON records in
``<out_dir>/metrics.jsonl`` (appended and flushed), wandb where asked for
and importable.

Counterpart of ``beyond_deep_ensembles_tpu/utils/logging.py`` (reference
wandb runs, cw2 logging and src/log_mock.py's ``VoidLog``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class VoidLog:
    """A logger that drops everything (reference src/log_mock.py VoidLog),
    for HPO trials."""

    def info(self, *_, **__):
        pass

    def metrics(self, *_, **__):
        pass


class RunLogger:
    def __init__(self, out_dir: Optional[str] = None, name: str = "run", use_wandb: bool = False,
                 config: Optional[dict] = None):
        self.name = name
        self.out_dir = out_dir
        self._file = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(name=name, config=config or {})
            except Exception:
                self._wandb = None
        self._t0 = time.time()

    def info(self, msg: str):
        print(f"[{self.name} +{time.time() - self._t0:8.1f}s] {msg}", flush=True)

    def metrics(self, record: dict, step: Optional[int] = None):
        record = {"_name": self.name, "_t": round(time.time() - self._t0, 2), **record}
        if step is not None:
            record["_step"] = step
        if self._file:
            self._file.write(json.dumps(record, default=float) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def close(self):
        if self._file:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
