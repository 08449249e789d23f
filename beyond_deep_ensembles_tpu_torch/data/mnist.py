"""MNIST family: MNIST, FashionMNIST (+corrupted), MedMNIST subsets.

Counterpart of ``beyond_deep_ensembles_tpu/data/mnist.py`` (reference
experiments/base/mnist.py), numpy only, equal array for array. Sources: standard idx/npz files
under ``$BDE_DATA_DIR`` (``mnist/``, ``fashion_mnist/``,
``medmnist/<subset>.npz``); synthetic stand-ins otherwise. Arrays are
NHWC float32 in [0,1], normalized by the usual per-dataset constants.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .uci import data_dir

MEDMNIST_SUBSETS = [
    "pathmnist",
    "dermamnist",
    "octmnist",
    "pneumoniamnist",
    "retinamnist",
    "breastmnist",
    "bloodmnist",
    "tissuemnist",
    "organamnist",
    "organcmnist",
]


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(root, names):
    for n in names:
        for ext in ("", ".gz"):
            p = os.path.join(root, n + ext)
            if os.path.exists(p):
                return p
    return None


def _synthetic_mnist(n, seed, classes=10, channels=1, size=28):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, size=n)
    base = np.random.RandomState(777).rand(classes, 7, 7, channels).astype(np.float32)
    x = base[y].repeat(size // 7, axis=1).repeat(size // 7, axis=2)
    x = np.clip(x + 0.1 * rng.randn(n, size, size, channels), 0, 1).astype(np.float32)
    return x, y.astype(np.int64)


def load_mnist(
    train: bool, fashion: bool = False, subsample: Optional[int] = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    name = "fashion_mnist" if fashion else "mnist"
    root = os.path.join(data_dir(), name)
    prefix = "train" if train else "t10k"
    xi = _find(root, [f"{prefix}-images-idx3-ubyte"])
    yi = _find(root, [f"{prefix}-labels-idx1-ubyte"])
    if xi and yi:
        x = (_read_idx(xi).astype(np.float32) / 255.0)[..., None]
        y = _read_idx(yi).astype(np.int64)
    else:
        x, y = _synthetic_mnist(8192 if train else 2048, seed + (7 if fashion else 0))
    if subsample is not None:
        x, y = x[:subsample], y[:subsample]
    # standard normalization (mean 0.1307, std 0.3081 for mnist)
    if not fashion:
        x = (x - 0.1307) / 0.3081
    else:
        x = (x - 0.2860) / 0.3530
    return x, y


def load_medmnist(
    subset: str, split: str = "train", subsample: Optional[int] = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """MedMNIST v2 npz layout: {split}_images [N,28,28(,3)], {split}_labels
    (reference mnist.py:77-113)."""
    assert subset in MEDMNIST_SUBSETS, subset
    path = os.path.join(data_dir(), "medmnist", f"{subset}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            x = f[f"{split}_images"].astype(np.float32) / 255.0
            y = f[f"{split}_labels"].reshape(-1).astype(np.int64)
        if x.ndim == 3:
            x = x[..., None]
    else:
        channels = 3 if subset in ("pathmnist", "dermamnist", "bloodmnist") else 1
        import zlib

        # crc32, not salted hash(): stable synthetic data across processes
        x, y = _synthetic_mnist(
            2048 if split == "train" else 512,
            seed + zlib.crc32(subset.encode()) % 100,
            channels=channels,
        )
    x = (x - 0.5) / 0.5
    if subsample is not None:
        x, y = x[:subsample], y[:subsample]
    return x, y


def load_corrupted_mnist(
    subsample: Optional[int] = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-C from the on-disk dump (reference mnist-c/ folder ImageFolder
    loader, mnist.py); synthetic fallback adds noise to clean MNIST."""
    root = os.path.join(data_dir(), "mnist_c")
    if os.path.exists(root):
        xs, ys = [], []
        for corr in sorted(os.listdir(root)):
            d = os.path.join(root, corr)
            if not os.path.isdir(d):
                continue
            x = np.load(os.path.join(d, "test_images.npy")).astype(np.float32) / 255.0
            y = np.load(os.path.join(d, "test_labels.npy")).astype(np.int64)
            xs.append(x if x.ndim == 4 else x[..., None])
            ys.append(y)
        x, y = np.concatenate(xs), np.concatenate(ys)
        x = (x - 0.1307) / 0.3081
    else:
        x, y = load_mnist(train=False, seed=seed)
        rng = np.random.RandomState(seed + 3)
        x = x + 0.5 * rng.randn(*x.shape).astype(np.float32)
    if subsample is not None:
        x, y = x[:subsample], y[:subsample]
    return x, y
