"""IMDB sentiment dataset for the CNN-LSTM bnn-hmc models.

Counterpart of ``beyond_deep_ensembles_tpu/data/imdb.py``, numpy only, equal
array for array. Reference: load_imdb_dataset (google-bnn-hmc/bnn_hmc/utils/data_utils.py:
94-116): keras imdb word-index sequences, vocabulary capped at 20000,
padded/truncated to length 100, first 20000 reviews for train, the rest
of the keras train split as validation, keras test as test. 2 classes.

Cache schema: ``$BDE_DATA_DIR/imdb.npz`` with int32 ``x_train``/``x_test``
[N, 100] padded token ids (< 20000) and int64 ``y_train``/``y_test`` [N].
Built offline from the keras distribution (no egress here); a synthetic
stand-in with a planted class signal engages when the cache is absent.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .uci import data_dir

MAX_FEATURES = 20000
MAX_LEN = 100
NUM_TRAIN = 20000


def _synthetic_imdb(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, size=n).astype(np.int64)
    x = rng.randint(4, MAX_FEATURES, size=(n, MAX_LEN)).astype(np.int32)
    # plant a detectable sentiment token so tiny models can learn
    x[:, 0] = 1
    x[:, 1] = 2 + y
    return x, y


def load_imdb(split: str = "train", subsample=None) -> Tuple[np.ndarray, np.ndarray]:
    """split in {train, test}. Returns (tokens [N, 100] int32, labels [N])."""
    path = os.path.join(data_dir(), "imdb.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            x = f[f"x_{split}"].astype(np.int32)
            y = f[f"y_{split}"].astype(np.int64)
    else:
        n = {"train": 2048, "test": 512}[split]
        x, y = _synthetic_imdb(n, seed=0 if split == "train" else 1)
    if subsample is not None:
        k = int(len(x) * subsample) if subsample <= 1 else int(subsample)
        x, y = x[:k], y[:k]
    return x, y


def write_imdb_cache(x_train, y_train, x_test, y_test, root=None) -> str:
    """Stage the IMDB cache (pair of data/prepare.py's writers): validates
    the documented schema and writes ``imdb.npz``."""
    x_train = np.asarray(x_train, np.int32)
    x_test = np.asarray(x_test, np.int32)
    for x in (x_train, x_test):
        if x.ndim != 2 or x.shape[1] != MAX_LEN:
            raise ValueError(f"tokens must be [N, {MAX_LEN}], got {x.shape}")
        if x.max() >= MAX_FEATURES:
            raise ValueError(f"token ids must be < {MAX_FEATURES}")
    path = os.path.join(root or data_dir(), "imdb.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        x_train=x_train,
        y_train=np.asarray(y_train, np.int64),
        x_test=x_test,
        y_test=np.asarray(y_test, np.int64),
    )
    return path
