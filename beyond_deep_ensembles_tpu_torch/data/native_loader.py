"""The batch order of the JAX package's native loader.

Counterpart of ``beyond_deep_ensembles_tpu/data/native_loader.py``. There,
``PrefetchLoader`` walks ``shuffled_indices(n, seed * 1_000_003 + epoch)``,
the SplitMix64 Fisher-Yates shuffle of ``native/libbatcher.so``
(``native/batcher.cc:114-127``) whenever that library loads, as it does from
the repository. Here the same shuffle is written in Python, so the port
imports no native code; the experiments gather each batch on the device, so
``gather_rows`` and the prefetch thread have no counterpart.
"""
from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFFFFFFFFFF
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(seed: int, count: int) -> np.ndarray:
    """The first ``count`` SplitMix64 outputs from ``seed`` (the state adds
    the golden gamma before each draw), vectorized; uint64 wraps as C does."""
    z = np.uint64(seed & _MASK) + np.arange(1, count + 1, dtype=np.uint64) * _GAMMA
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """``native/batcher.cc::shuffle_indices``: for i = n-1 down to 1, swap i
    with next() % (i + 1)."""
    idx = list(range(n))
    if n > 1:
        bounds = np.arange(n, 1, -1, dtype=np.uint64)  # i + 1 for i = n-1 .. 1
        draws = (_splitmix64(seed, n - 1) % bounds).tolist()
        for i, j in zip(range(n - 1, 0, -1), draws):
            idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, np.int64)
