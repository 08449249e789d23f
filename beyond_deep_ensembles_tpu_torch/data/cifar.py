"""CIFAR-10 data.

Counterpart of ``beyond_deep_ensembles_tpu/data/cifar.py`` (reference
experiments/base/cifar.py): Wilson-et-al normalization, the python-pickle
loader, the seeded synthetic stand-in when ``$BDE_DATA_DIR`` holds no
CIFAR-10, random crop (zero-pad 4) + horizontal flip as a batched tensor
function, and the numpy shuffle the JAX package's loader uses. Arrays come
back as numpy NHWC float32, bit-equal to the JAX package's; the experiment
moves them to the device as NCHW and gathers each batch there with the
shuffle, so ``batch_iter`` has no counterpart. STL-10, CIFAR-10-C and the
native batcher are not ported yet.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MEAN = np.asarray([0.49, 0.48, 0.44], np.float32)
STD = np.asarray([0.2, 0.2, 0.2], np.float32)


def data_dir() -> str:
    """``$BDE_DATA_DIR``, else ``./data`` (JAX: ``data/uci.py::data_dir``)."""
    return os.environ.get("BDE_DATA_DIR", os.path.join(os.getcwd(), "data"))


def normalize(images_uint8_or_float: np.ndarray) -> np.ndarray:
    """uint8 [N,32,32,3] or float in [0,1] -> normalized float32 NHWC."""
    x = np.asarray(images_uint8_or_float, np.float32)
    if x.max() > 2.0:
        x = x / 255.0
    return (x - MEAN) / STD


def _synthetic_cifar(n: int, seed: int, classes: int = 10):
    """Class-structured blobs, the same arrays as the JAX package's default
    (not its ``hard`` variant, which is not ported yet): class prototypes
    from a FIXED rng shared by the splits, per-split noise from ``seed``."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, size=n)
    base = np.random.RandomState(1234).randn(classes, 4, 4, 3).astype(np.float32)
    imgs = base[y].repeat(8, axis=1).repeat(8, axis=2)
    noise = np.random.default_rng(seed + 1).standard_normal(size=(n, 32, 32, 3), dtype=np.float32)
    imgs = np.float32(0.5) + np.float32(0.15) * imgs + np.float32(0.1) * noise
    np.clip(imgs, 0, 1, out=imgs)
    return imgs, y.astype(np.int64)


def _load_python_batches(root: str, train: bool):
    # The standard CIFAR-10 python pickles: files this loader was pointed at.
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[b"labels"], np.int64))
    return np.concatenate(xs), np.concatenate(ys)


def load_cifar10(
    train: bool,
    subsample: Optional[int] = None,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (normalized images NHWC float32, labels int64)."""
    root = os.path.join(data_dir(), "cifar-10-batches-py")
    if os.path.exists(root):
        x, y = _load_python_batches(root, train)
    else:
        n = 50_000 if train else 10_000
        if subsample is not None:
            n = min(n, max(subsample * 2, 512))
        x, y = _synthetic_cifar(n, seed + (0 if train else 1))
    x = normalize(x)
    if subsample is not None:
        x, y = x[:subsample], y[:subsample]
    return x, y


def augment(
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Random crop (zero-pad 4) + horizontal flip of an NCHW batch, on the
    batch's device. ``offsets`` ``[b, 2]`` in [0, 8] (row, column) and
    ``flips`` ``[b]`` bool may be given; otherwise both are drawn from the
    CPU ``generator``."""
    b, _, h, w = images.shape
    if offsets is None:
        offsets = torch.randint(0, 9, (b, 2), generator=generator)
        flips = torch.rand(b, generator=generator) < 0.5
    offsets = offsets.to(images.device)
    flips = flips.to(images.device)
    rows = offsets[:, 0:1] + torch.arange(h, device=images.device)  # [b, h]
    cols = offsets[:, 1:2] + torch.arange(w, device=images.device)  # [b, w]
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    padded = F.pad(images, (4, 4, 4, 4))
    bi = torch.arange(b, device=images.device)[:, None, None]
    out = padded[bi, :, rows[:, :, None], cols[:, None, :]]  # [b, h, w, c]
    return out.permute(0, 3, 1, 2).contiguous()


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """The JAX package's numpy shuffle (``data/native_loader.py``)."""
    return np.random.RandomState(seed).permutation(n).astype(np.int64)

