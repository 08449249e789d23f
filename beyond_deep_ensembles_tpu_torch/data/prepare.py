"""Real-dataset ingestion: build the on-disk caches the loaders read.

Counterpart of ``beyond_deep_ensembles_tpu/data/prepare.py`` (numpy only,
the same schema and files: a cache either package writes loads through
both packages' loaders).

The reference downloads datasets at runtime through the ``wilds`` /
``uci_datasets`` / torchvision packages (wilds1.py:155-156
``download_dataset``, experiments/uci/data.py:7-78). Nothing here
downloads, so ingestion is a separate, explicit step: given the
standard distribution files (or the optional helper packages) on disk,
one command stages any dataset into ``$BDE_DATA_DIR`` in the documented
cache schema. The synthetic fallbacks in the loaders are untouched — they
engage only when a cache file is absent.

Cache schema (all compressed ``.npz``, little-endian):

  wilds/<task>_<split>.npz   x: float32 [N, H, W, C] images in [0, 1]
                                (text tasks: int32 [N, L, 2] packed
                                (input_ids, attention_mask),
                                wilds1.py:159-174)
                             y: int64 [N] labels (regression: float32 [N, 1])
                             meta: int64 [N, G] group columns —
                                civilcomments: the 8 identity groups
                                (reference civil.py:22-51), poverty: the
                                urban flag, others: first group column.
  uci/<name>.npz             x: float32 [N, D], y: float32 [N, 1]
  cifar-10-batches-py/       the standard python pickle batches (read
                             directly by data/cifar.py — no conversion).
  CIFAR-10-C/<corruption>.npy + labels.npy   standard Hendrycks layout.

Usage:
  python -m beyond_deep_ensembles_tpu_torch.data.prepare wilds camelyon17 [--splits train,val,test]
  python -m beyond_deep_ensembles_tpu_torch.data.prepare uci yacht
  python -m beyond_deep_ensembles_tpu_torch.data.prepare verify
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

from .uci import UCI_SHAPES, data_dir
from .wilds import CIVIL_GROUPS, TASKS


# ---------------------------------------------------------------------------
# Cache writers (schema enforcement lives here, used by every ingest path)
# ---------------------------------------------------------------------------


def write_wilds_cache(task: str, split: str, x, y, meta, root: Optional[str] = None) -> str:
    """Validate against the TaskSpec and write ``wilds/<task>_<split>.npz``."""
    spec = TASKS[task]
    x = np.ascontiguousarray(x)
    y = np.ascontiguousarray(y)
    meta = np.ascontiguousarray(meta)
    if x.shape[1:] != spec.input_shape:
        raise ValueError(
            f"{task}: x shape {x.shape[1:]} != spec {spec.input_shape}"
        )
    if spec.text:
        x = x.astype(np.int32)
    else:
        was_uint8 = x.dtype == np.uint8
        x = x.astype(np.float32)
        # Rescale uint8-derived images to [0, 1]; never rescale tasks
        # whose images are already standardized floats (PovertyMap's
        # 8-channel multispectral data is negative and >1 by design).
        if spec.unit_interval and (was_uint8 or x.max() > 1.5):
            x = x / 255.0
    if spec.classes == 1:
        y = y.astype(np.float32).reshape(len(x), 1)
    else:
        y = y.astype(np.int64).reshape(len(x))
        if y.min() < 0 or y.max() >= spec.classes:
            raise ValueError(f"{task}: labels outside [0, {spec.classes})")
    meta = meta.astype(np.int64)
    if meta.ndim == 1:
        meta = meta[:, None]
    if not (len(x) == len(y) == len(meta)):
        raise ValueError(f"{task}: length mismatch {len(x)}/{len(y)}/{len(meta)}")
    out_dir = os.path.join(root or data_dir(), "wilds")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{task}_{split}.npz")
    np.savez_compressed(path, x=x, y=y, meta=meta)
    return path


def write_uci_cache(name: str, x, y, root: Optional[str] = None) -> str:
    """Write ``uci/<name>.npz`` (x float32 [N, D], y float32 [N, 1])."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32).reshape(len(x), 1)
    out_dir = os.path.join(root or data_dir(), "uci")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez_compressed(path, x=x, y=y)
    return path


# ---------------------------------------------------------------------------
# WILDS ingestion (requires the `wilds` package + raw download on disk)
# ---------------------------------------------------------------------------

# Per-task metadata column extraction, mirroring the group structure the
# official .eval metrics consume (reference wilds1.py per-task transforms
# + civil.py:22-51 identity groups, poverty.py:45 urban flag).
_CIVIL_META_FIELDS = CIVIL_GROUPS  # identity columns, in wilds metadata order


def _resize_chw_image(img, hw):
    """uint8/float HWC image -> float32 HWC resized to hw (PIL if present,
    else nearest-neighbor index sampling — adequate for eval parity prep)."""
    h, w = hw
    arr = np.asarray(img)
    if arr.shape[0] == h and arr.shape[1] == w:
        return arr.astype(np.float32)
    try:
        from PIL import Image

        im = Image.fromarray(arr.astype(np.uint8))
        return np.asarray(im.resize((w, h), Image.BILINEAR), np.float32)
    except Exception:
        yi = (np.arange(h) * arr.shape[0] / h).astype(int)
        xi = (np.arange(w) * arr.shape[1] / w).astype(int)
        return arr[yi][:, xi].astype(np.float32)


def prepare_wilds(
    task: str,
    splits=("train", "val", "test"),
    download_root: Optional[str] = None,
    subsample: Optional[int] = None,
    out_root: Optional[str] = None,
    fold: Optional[str] = None,
    log=print,
):
    """Stage WILDS splits into the npz cache. Requires the ``wilds``
    package and the dataset's raw files under ``download_root``
    (reference get_dataset/get_subset, wilds1.py:55-174). ``fold``: the
    PovertyMap cross-validation fold A-E (reference 5-fold protocol)."""
    try:
        from wilds import get_dataset
    except ImportError as e:  # pragma: no cover - exercised only with wilds installed
        raise SystemExit(
            "the `wilds` package is not installed in this environment; "
            "stage the raw dataset elsewhere and copy the npz cache, or "
            "call write_wilds_cache() with arrays you prepared"
        ) from e

    spec = TASKS[task]
    root = download_root or os.path.join(data_dir(), "wilds_raw")
    name = {"poverty": "poverty", "fmow": "fmow"}.get(task, task)
    kwargs = {"fold": fold} if fold else {}
    dataset = get_dataset(dataset=name, root_dir=root, download=False, **kwargs)

    tokenize = None
    if spec.text:
        from .text import get_tokenizer

        tokenize = get_tokenizer()

    paths = []
    for split in splits:
        sub = dataset.get_subset(split)
        n = len(sub) if subsample is None else min(subsample, len(sub))
        xs, ys, metas = [], [], []
        for i in range(n):
            xi, yi, mi = sub[i]
            if spec.text:
                xs.append(xi)  # raw string; tokenized in bulk below
            else:
                arr = np.asarray(xi, np.float32)
                if arr.ndim == 3 and arr.shape[0] in (3, 8):  # CHW -> HWC
                    arr = np.moveaxis(arr, 0, -1)
                if arr.shape[:2] != spec.input_shape[:2]:
                    arr = _resize_chw_image(arr, spec.input_shape[:2])
                xs.append(arr)
            ys.append(np.asarray(yi))
            metas.append(np.asarray(mi))
        meta = np.stack(metas)
        if task == "civilcomments":
            # columns 0..7 of the wilds metadata are the identity groups
            meta = meta[:, : len(_CIVIL_META_FIELDS)]
        elif task == "poverty":
            idx = list(getattr(dataset, "metadata_fields", [])).index("urban") if (
                "urban" in getattr(dataset, "metadata_fields", [])
            ) else 0
            meta = meta[:, idx : idx + 1]
        else:
            # fmow needs the region column, amazon the user column —
            # both are metadata column 0 in WILDS, but resolve by field
            # name when the dataset exposes it, for robustness.
            want = {"fmow": "region", "amazon": "user"}.get(task)
            fields = list(getattr(dataset, "metadata_fields", []))
            idx = fields.index(want) if want in fields else 0
            meta = meta[:, idx : idx + 1]
        if spec.text:
            ids, mask = tokenize(xs, spec.seq_len)
            x = np.stack([ids, mask], axis=-1)
        else:
            x = np.stack(xs)
        split_name = f"{split}_fold{fold}" if fold else split
        path = write_wilds_cache(task, split_name, x, np.stack(ys), meta, root=out_root)
        log(f"wrote {path}: x{x.shape}")
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# UCI ingestion
# ---------------------------------------------------------------------------


def prepare_uci(name: str, raw_path: Optional[str] = None, out_root: Optional[str] = None, log=print):
    """Stage one UCI regression dataset.

    Sources, in order: the ``uci_datasets`` package (reference
    experiments/uci/data.py:7-30), else a raw whitespace/comma text file
    (``<data_dir>/uci_raw/<name>.data`` or ``raw_path``) whose last column
    is the target — the classic UCI distribution format
    (reference experiments/base/uci.py:7-64 pandas loader)."""
    x = y = None
    try:
        from uci_datasets import Dataset  # type: ignore

        d = Dataset(name)
        x, y = d.x, d.y
    except Exception:
        path = raw_path or os.path.join(data_dir(), "uci_raw", f"{name}.data")
        if not os.path.exists(path):
            raise SystemExit(
                f"no `uci_datasets` package and no raw file at {path}; "
                "place the standard UCI .data file there"
            )
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip().replace(",", " ")
                try:
                    row = [float(v) for v in line.split()]
                except ValueError:
                    continue  # header / comment line
                if row:
                    rows.append(row)
        arr = np.asarray(rows, np.float32)
        x, y = arr[:, :-1], arr[:, -1:]
    dim = UCI_SHAPES.get(name, (None,))[0]
    if dim is not None and x.shape[1] != dim:
        log(f"warning: {name} has {x.shape[1]} features, expected {dim}")
    path = write_uci_cache(name, x, y, root=out_root)
    log(f"wrote {path}: x{x.shape}")
    return path


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def verify_cache(root: Optional[str] = None, log=print) -> dict:
    """Walk the cache and check every staged file against its schema.
    Returns {relative_path: 'ok' | error message}."""
    root = root or data_dir()
    report = {}

    wilds_dir = os.path.join(root, "wilds")
    if os.path.isdir(wilds_dir):
        for fn in sorted(os.listdir(wilds_dir)):
            if not fn.endswith(".npz"):
                continue
            stem = fn[:-4]
            if "_fold" in stem:  # poverty_<split>_fold<F>
                stem = stem[: stem.index("_fold")]
            # strip the known split suffix explicitly: a blind rsplit on
            # the last underscore parses amazon_id_val as task "amazon_id"
            task = stem
            for split in ("id_val", "train", "val", "test"):
                if stem.endswith(f"_{split}"):
                    task = stem[: -len(split) - 1]
                    break
            rel = f"wilds/{fn}"
            if task not in TASKS:
                report[rel] = f"unknown task {task!r}"
                continue
            spec = TASKS[task]
            try:
                with np.load(os.path.join(wilds_dir, fn)) as f:
                    x, y, meta = f["x"], f["y"], f["meta"]
                assert x.shape[1:] == spec.input_shape, f"x shape {x.shape[1:]}"
                assert len(x) == len(y) == len(meta), "length mismatch"
                if spec.classes > 1:
                    assert y.max() < spec.classes, "label out of range"
                if not spec.text and spec.unit_interval:
                    assert 0 <= x.min() and x.max() <= 1.5, "images not in [0,1]"
                if not spec.text:
                    assert np.isfinite(x).all(), "non-finite images"
                report[rel] = "ok"
            except Exception as e:
                report[rel] = str(e)

    uci_dir = os.path.join(root, "uci")
    if os.path.isdir(uci_dir):
        for fn in sorted(os.listdir(uci_dir)):
            if not fn.endswith(".npz"):
                continue
            rel = f"uci/{fn}"
            try:
                with np.load(os.path.join(uci_dir, fn)) as f:
                    x, y = f["x"], f["y"]
                assert x.ndim == 2 and y.shape == (len(x), 1), "bad shapes"
                assert np.isfinite(x).all() and np.isfinite(y).all(), "non-finite"
                report[rel] = "ok"
            except Exception as e:
                report[rel] = str(e)

    cifar = os.path.join(root, "cifar-10-batches-py")
    if os.path.isdir(cifar):
        batches = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        missing = [b for b in batches if not os.path.exists(os.path.join(cifar, b))]
        report["cifar-10-batches-py"] = "ok" if not missing else f"missing {missing}"

    for rel, status in report.items():
        log(f"{rel}: {status}")
    if not report:
        log(f"no staged datasets under {root}")
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_w = sub.add_parser("wilds", help="stage WILDS task splits")
    p_w.add_argument("task", choices=sorted(TASKS))
    p_w.add_argument("--splits", default="train,val,test")
    p_w.add_argument("--download-root", default=None)
    p_w.add_argument("--subsample", type=int, default=None)
    p_w.add_argument("--fold", default=None, help="PovertyMap fold A-E")

    p_u = sub.add_parser("uci", help="stage a UCI regression dataset")
    p_u.add_argument("name")
    p_u.add_argument("--raw", default=None)

    sub.add_parser("verify", help="check every staged cache file's schema")

    args = parser.parse_args(argv)
    if args.cmd == "wilds":
        prepare_wilds(
            args.task,
            splits=tuple(args.splits.split(",")),
            download_root=args.download_root,
            subsample=args.subsample,
            fold=args.fold,
        )
    elif args.cmd == "uci":
        prepare_uci(args.name, raw_path=args.raw)
    else:
        report = verify_cache()
        bad = {k: v for k, v in report.items() if v != "ok"}
        if bad:
            sys.exit(1)


if __name__ == "__main__":
    main()
