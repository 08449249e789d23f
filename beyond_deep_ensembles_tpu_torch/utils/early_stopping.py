"""Early stopping on a periodic validation loss.

Counterpart of ``beyond_deep_ensembles_tpu/utils/early_stopping.py``
(reference EarlyStopper, src/algos/util.py:110-141): every ``interval``
epochs ``evaluator(state)`` gives a loss; training should stop once more
than ``patience`` evaluations in a row have not beaten the best by
``delta``. A caller's ``epoch_callback`` to
``experiments/wilds_task.py::train`` can call it (the engine itself does
not, as the JAX package's does not).
"""
from __future__ import annotations

from typing import Callable


class EarlyStopper:
    def __init__(self, evaluator: Callable[[object], float], interval: int, delta: float, patience: int):
        self.evaluator = evaluator
        self.interval = interval
        self.delta = delta
        self.patience = patience
        self.losses: list[float] = []
        self.best_loss = float("inf")
        self.epochs_since_best = 0

    def should_stop(self, state, epoch: int) -> bool:
        if epoch % self.interval != 0:
            return False
        loss = float(self.evaluator(state))
        self.losses.append(loss)
        if loss < self.best_loss - self.delta:
            self.best_loss = loss
            self.epochs_since_best = 0
        else:
            self.epochs_since_best += 1
        return self.epochs_since_best > self.patience
