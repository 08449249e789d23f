"""UCI regression data sets with standard, validation and gap splits, and
where the data sets live.

Counterpart of ``beyond_deep_ensembles_tpu/data/uci.py`` (reference
experiments/uci/data.py), plain numpy, so the arrays equal the JAX
package's:

  * ``$BDE_DATA_DIR/uci/<name>.npz`` (arrays ``x``, ``y``) when it is there,
    else a deterministic synthetic regression problem with the data set's
    ``(in_dim, n)`` (:data:`UCI_SHAPES`), seeded with ``crc32`` of the name;
  * a 90/10 fold split by ``RandomState(1234)``; normalization over
    train+test (``ddof=1``, a zero std taken as 1);
  * ``val_train`` the first ``90% * val_percentage`` of train, ``val_test``
    the last 10%;
  * gap split ``d``: all points sorted by input ``d``, the middle third held
    out, each side shuffled by the data set's own ``RandomState``, which
    moves on at every call.
"""
from __future__ import annotations

import os
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

# (in_dim, n) of the benchmark data sets (uci_datasets metadata)
UCI_SHAPES = {
    "yacht": (6, 308),
    "boston": (13, 506),
    "energy": (8, 768),
    "concrete": (8, 1030),
    "wine": (11, 1599),
    "kin8nm": (8, 8192),
    "power": (4, 9568),
    "naval": (14, 11934),
    "protein": (9, 45730),
}


def data_dir() -> str:
    """``$BDE_DATA_DIR``, else ``./data``."""
    return os.environ.get("BDE_DATA_DIR", os.path.join(os.getcwd(), "data"))


def _synthetic_uci(name: str, seed: int = 0):
    in_dim, n = UCI_SHAPES.get(name, (6, 308))
    # crc32, not hash(): Python's string hash is salted per process
    rng = np.random.RandomState(seed + zlib.crc32(name.encode()) % 1000)
    x = rng.randn(n, in_dim).astype(np.float32)
    w1 = rng.randn(in_dim, 16) / np.sqrt(in_dim)
    w2 = rng.randn(16, 1)
    y = np.tanh(x @ w1) @ w2 + 0.1 * rng.randn(n, 1)
    return x.astype(np.float32), y.astype(np.float32)


def _load_uci(name: str) -> Tuple[np.ndarray, np.ndarray]:
    path = os.path.join(data_dir(), "uci", f"{name}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            return f["x"].astype(np.float32), f["y"].astype(np.float32).reshape(f["x"].shape[0], -1)
    return _synthetic_uci(name)


class UCIDataset:
    """Reference UCIDataset (experiments/uci/data.py:7-48)."""

    def __init__(self, name: str, split: int = 0, normalize: bool = True, val_percentage: float = 1.0,
                 seed: int = 0):
        self.name = name
        self.val_percentage = val_percentage
        x, y = _load_uci(name)
        # 90/10 split by index, rotated by ``split`` (10 folds)
        n = x.shape[0]
        perm = np.random.RandomState(1234).permutation(n)
        fold = n // 10
        test_idx = perm[split * fold : (split + 1) * fold]
        train_idx = np.setdiff1d(perm, test_idx, assume_unique=False)
        self.x_train, self.y_train = x[train_idx], y[train_idx]
        self.x_test, self.y_test = x[test_idx], y[test_idx]

        if normalize:
            ax = np.concatenate([self.x_train, self.x_test])
            ay = np.concatenate([self.y_train, self.y_test])
            self.x_mean, self.x_std = ax.mean(0), ax.std(0, ddof=1)
            self.y_mean, self.y_std = ay.mean(0), ay.std(0, ddof=1)
            self.x_std = np.where(self.x_std == 0, 1.0, self.x_std)
        else:
            self.x_mean, self.x_std = 0.0, 1.0
            self.y_mean, self.y_std = 0.0, 1.0
        self._rng = np.random.RandomState(seed)

    @property
    def in_dim(self) -> int:
        return self.x_train.shape[1]

    def get_arrays(self, split: str, gap: Optional[int] = None):
        """Normalized fp32 ``(x, y)`` of ``split`` (``train``, ``test``,
        ``val_train``, ``val_test``), of gap split ``gap`` where given (a new
        gap shuffle at each call)."""
        if gap is None:
            x_train, y_train = self.x_train, self.y_train
            x_test, y_test = self.x_test, self.y_test
        else:
            x_train, y_train, x_test, y_test = self._gap_split(gap)

        if split == "train":
            x, y = x_train, y_train
        elif split == "test":
            x, y = x_test, y_test
        elif split == "val_train":
            k = int(0.9 * x_train.shape[0] * self.val_percentage)
            x, y = x_train[:k], y_train[:k]
        elif split == "val_test":
            k = int(0.9 * x_train.shape[0])
            x, y = x_train[k:], y_train[k:]
        else:
            raise ValueError(f"unknown split {split!r}")

        x = (x - self.x_mean) / self.x_std
        y = (y - self.y_mean) / self.y_std
        return x.astype(np.float32), y.astype(np.float32)

    def _gap_split(self, dim: int):
        """Middle-third holdout along input ``dim`` (reference
        data.py:63-78)."""
        x = np.concatenate([self.x_train, self.x_test])
        y = np.concatenate([self.y_train, self.y_test])
        order = np.argsort(x[:, dim], kind="stable")
        third = len(order) // 3
        train_idx = np.concatenate([order[:third], order[2 * third :]])
        test_idx = order[third : 2 * third]
        train_idx = train_idx[self._rng.permutation(len(train_idx))]
        test_idx = test_idx[self._rng.permutation(len(test_idx))]
        return x[train_idx], y[train_idx], x[test_idx], y[test_idx]


def batch_indices(n: int, batch_size: int, rng: Optional[np.random.RandomState] = None,
                  drop_remainder: bool = False) -> Iterator[np.ndarray]:
    """The rows of each minibatch: a permutation from ``rng`` (else in
    order), the last partial batch padded by wrapping to the permutation's
    first rows, or dropped with ``drop_remainder``."""
    idx = np.arange(n) if rng is None else rng.permutation(n)
    for start in range(0, n, batch_size):
        sel = idx[start : start + batch_size]
        if len(sel) < batch_size:
            if drop_remainder:
                return
            sel = np.concatenate([sel, idx[: batch_size - len(sel)]])
        yield sel


def batch_iter(x: np.ndarray, y: np.ndarray, batch_size: int, rng: Optional[np.random.RandomState] = None,
               drop_remainder: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Minibatches ``(x[sel], y[sel])`` over :func:`batch_indices`."""
    for sel in batch_indices(x.shape[0], batch_size, rng, drop_remainder):
        yield x[sel], y[sel]
