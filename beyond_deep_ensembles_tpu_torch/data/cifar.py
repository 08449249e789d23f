"""CIFAR-10 data (+ the STL-10 test split, + CIFAR-10-C corrupted splits).

Counterpart of ``beyond_deep_ensembles_tpu/data/cifar.py`` (reference
experiments/base/cifar.py): Wilson-et-al normalization, the python-pickle
loader, the seeded synthetic stand-ins when ``$BDE_DATA_DIR`` holds no
CIFAR-10, STL-10 or CIFAR-10-C, the per-intensity corrupted test splits,
random crop (zero-pad 4) + horizontal flip as a batched tensor function
(its offsets and flips drawn by the caller's ``NoiseSource.crops``, on the
device in key mode), and the numpy shuffle the JAX package's loader uses.
Arrays come back as numpy NHWC float32, bit-equal to the JAX package's; the
experiment moves them to the device as NCHW and gathers each batch there
with the shuffle, so ``batch_iter`` and the native batcher have no
counterpart here (``data/native_loader.py`` keeps the batcher's shuffle
order).
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .uci import data_dir

MEAN = np.asarray([0.49, 0.48, 0.44], np.float32)
STD = np.asarray([0.2, 0.2, 0.2], np.float32)

CORRUPTIONS = [
    "gaussian_noise",
    "shot_noise",
    "impulse_noise",
    "defocus_blur",
    "glass_blur",
    "motion_blur",
    "zoom_blur",
    "snow",
    "frost",
    "fog",
    "brightness",
    "contrast",
    "elastic_transform",
    "pixelate",
    "jpeg_compression",
]


def normalize(images_uint8_or_float: np.ndarray) -> np.ndarray:
    """uint8 [N,32,32,3] or float in [0,1] -> normalized float32 NHWC."""
    x = np.asarray(images_uint8_or_float, np.float32)
    if x.max() > 2.0:
        x = x / 255.0
    return (x - MEAN) / STD


def _synthetic_cifar(n: int, seed: int, classes: int = 10, hard: Optional[bool] = None):
    """Class-structured blobs, the same arrays as the JAX package's: class
    prototypes from a FIXED rng shared by the splits, per-split noise from
    ``seed``. ``hard`` (default: ``BDE_SYNTH_HARD=1`` in the environment)
    makes the task non-separable: each image mixes its class prototype
    (weight 0.45-1) with another class's, and 10% of the labels are drawn
    again uniformly, so accuracy 1.0 there is a fault."""
    if hard is None:
        hard = os.environ.get("BDE_SYNTH_HARD", "0") == "1"
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, size=n)
    base = np.random.RandomState(1234).randn(classes, 4, 4, 3).astype(np.float32)
    imgs = base[y]
    if hard:
        other = base[(y + 1 + rng.randint(0, classes - 1, size=n)) % classes]
        mix = rng.uniform(0.45, 1.0, size=(n, 1, 1, 1)).astype(np.float32)
        imgs = mix * imgs + (np.float32(1.0) - mix) * other
    imgs = imgs.repeat(8, axis=1).repeat(8, axis=2)
    noise = np.random.default_rng(seed + 1).standard_normal(size=(n, 32, 32, 3), dtype=np.float32)
    imgs = np.float32(0.5) + np.float32(0.15) * imgs + np.float32(0.1) * noise
    np.clip(imgs, 0, 1, out=imgs)
    if hard:
        flip = rng.rand(n) < 0.1
        y = np.where(flip, rng.randint(0, classes, size=n), y)
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


def load_stl10_test(
    subsample: Optional[int] = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """STL-10 test split resized to 32x32 with the same normalization, the
    reference's OOD split for CIFAR models (cifar.py:16-17,46-48). Source:
    ``$BDE_DATA_DIR/stl10_binary/{test_X.bin,test_y.bin}``; the synthetic
    CIFAR-like set of 2048 otherwise."""
    root = os.path.join(data_dir(), "stl10_binary")
    xp, yp = os.path.join(root, "test_X.bin"), os.path.join(root, "test_y.bin")
    if os.path.exists(xp) and os.path.exists(yp):
        x = np.fromfile(xp, np.uint8).reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
        y = np.fromfile(yp, np.uint8).astype(np.int64) - 1
        # 96 -> 32: 3x3 average pooling (the reference uses PIL resize)
        x = x.reshape(-1, 32, 3, 32, 3, 3).mean(axis=(2, 4)).astype(np.float32)
        x = normalize(x)
    else:
        x, y = _synthetic_cifar(2048, seed + 5)
        x = normalize(x)
    if subsample is not None:
        x, y = x[:subsample], y[:subsample]
    return x, y


def load_cifar10_corrupted(
    intensity: int, subsample: Optional[int] = None, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Every corruption type at one intensity in {0..4}, concatenated
    (reference cifar.py:58-71), from the Hendrycks ``.npy`` dump under
    ``$BDE_DATA_DIR/CIFAR-10-C``: each file stacks the five intensities of
    the test set, ``labels.npy`` beside them. A layout that is not such a
    stack raises rather than serve the wrong intensity. Synthetic fallback:
    the clean (synthetic) test set plus ``0.1 (intensity + 1)`` Gaussian
    noise from ``RandomState(seed + 100 + intensity)``, once for each of the
    first three corruption types."""
    root = os.path.join(data_dir(), "CIFAR-10-C")
    if os.path.exists(root):
        labels = np.load(os.path.join(root, "labels.npy")).astype(np.int64)
        if len(labels) % 5 != 0:
            raise ValueError(
                f"CIFAR-10-C labels.npy has {len(labels)} rows — not a "
                "5-intensity stack; re-stage the dump"
            )
        block = len(labels) // 5
        sel = slice(intensity * block, (intensity + 1) * block)
        xs, ys = [], []
        for file in sorted(os.listdir(root)):
            if file == "labels.npy":
                continue
            arr = np.load(os.path.join(root, file)).astype(np.float32) / 256.0
            if len(arr) != len(labels):
                raise ValueError(
                    f"CIFAR-10-C {file} has {len(arr)} rows but labels.npy "
                    f"has {len(labels)} — mismatched dump"
                )
            xs.append((arr[sel] - MEAN) / STD)
            ys.append(labels[sel])
        x, y = np.concatenate(xs), np.concatenate(ys)
    else:
        x, y = load_cifar10(train=False, seed=seed)
        rng = np.random.RandomState(seed + 100 + intensity)
        n = x.shape[0]
        kept = 3 * n if subsample is None else min(subsample, 3 * n)
        xs, ys = [], []
        for c, _ in enumerate(CORRUPTIONS[:3]):
            # only the rows a subsample keeps are drawn: randn fills its
            # array in order, so the draw of the first rows is the first rows
            # of the whole draw, and a later type needs its predecessors whole
            rows = min(max(kept - c * n, 0), n)
            if rows == 0:
                break
            noise = rng.randn(rows, *x.shape[1:]).astype(np.float32)
            xs.append(x[:rows] + 0.1 * (intensity + 1) * noise)
            ys.append(y[:rows])
        x, y = np.concatenate(xs), np.concatenate(ys)
    if subsample is not None:
        x, y = x[:subsample], y[:subsample]
    return x, y


def augment(images: torch.Tensor, offsets: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Random crop (zero-pad 4) + horizontal flip of an NCHW batch, on the
    batch's device, by ``offsets`` ``[b, 2]`` in [0, 8] (row, column) and
    ``flips`` ``[b]`` bool (the experiments draw them by
    ``NoiseSource.crops``: on the device in key mode)."""
    b, _, h, w = images.shape
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

