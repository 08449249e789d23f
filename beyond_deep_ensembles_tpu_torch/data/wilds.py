"""WILDS distribution-shift tasks: data access and the official metrics.

Counterpart of ``beyond_deep_ensembles_tpu/data/wilds.py`` (reference
experiments/base/wilds1.py), numpy only and copied as it is: the task
registry, the loader that reads a preprocessed cache
(``$BDE_DATA_DIR/wilds/<task>_<split>.npz`` with arrays x, y, meta) or makes
seeded synthetic data of the tasks' shapes (text tasks: ``[n, L, 2]`` int32
packing token ids and an all-ones attention mask), and the official metrics
(macro-F1, worst-group and worst-region accuracy, the 10th-percentile
per-user accuracy, Pearson r). The arrays are bit-equal to the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional, Tuple

import numpy as np

from .uci import data_dir

CIVIL_GROUPS = [
    "male",
    "female",
    "LGBTQ",
    "christian",
    "muslim",
    "other_religions",
    "black",
    "white",
]


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    input_shape: tuple  # per-example
    classes: int  # 1 => regression
    text: bool = False
    seq_len: int = 0
    # accuracy | macro_f1 | worst_group_acc | pearson | worst_region_acc
    # | tenth_percentile_acc
    metric: str = "accuracy"
    # images stored in [0, 1] (uint8-derived). PovertyMap ships
    # standardized multispectral floats that are negative and >1, so its
    # cache must neither be /255-rescaled nor range-checked.
    unit_interval: bool = True


# FMoW metadata region ids (WILDS metadata_map order); id 5 = "Other" is
# excluded from the worst-region metric, matching the official
# dataset.eval (reference fmow.py:70,84 loops regions 0..4 only).
FMOW_REGIONS = ("asia", "europe", "africa", "americas", "oceania", "other")

TASKS = {
    "camelyon17": TaskSpec("camelyon17", (96, 96, 3), 2),
    "iwildcam": TaskSpec("iwildcam", (448, 448, 3), 182, metric="macro_f1"),
    "rxrx1": TaskSpec("rxrx1", (256, 256, 3), 1139),
    "fmow": TaskSpec("fmow", (224, 224, 3), 62, metric="worst_region_acc"),
    "poverty": TaskSpec(
        "poverty", (224, 224, 8), 1, metric="pearson", unit_interval=False
    ),
    "civilcomments": TaskSpec(
        "civilcomments", (300, 2), 2, text=True, seq_len=300, metric="worst_group_acc"
    ),
    "amazon": TaskSpec(
        "amazon", (512, 2), 5, text=True, seq_len=512, metric="tenth_percentile_acc"
    ),
}


def _synthetic(spec: TaskSpec, n: int, seed: int):
    # float32 Generator noise, sized to the requested n only: the poverty
    # spec is 224x224x8, so a float64 full-split draw is gigabytes.
    rng = np.random.RandomState(seed)
    fast = np.random.default_rng(seed)
    n_classes = max(spec.classes, 2)
    y = (
        rng.randn(n, 1).astype(np.float32)
        if spec.classes == 1
        else rng.randint(0, spec.classes, size=n).astype(np.int64)
    )
    if spec.text:
        ids = rng.randint(0, 1000, size=(n,) + spec.input_shape[:1]).astype(np.int32)
        # class signal in the first tokens so tiny models can learn
        if spec.classes > 1:
            ids[:, 0] = y + 1
        mask = np.ones_like(ids)
        x = np.stack([ids, mask], axis=-1)
    else:
        # shared class prototypes across splits (fixed rng)
        base = np.random.RandomState(4321).randn(
            n_classes, 4, 4, spec.input_shape[-1]
        ).astype(np.float32)
        cls = y.astype(int).reshape(-1) % n_classes
        h, w = spec.input_shape[:2]
        imgs = base[cls].repeat(h // 4, axis=1).repeat(w // 4, axis=2)
        noise = fast.standard_normal((n,) + spec.input_shape, dtype=np.float32)
        x = 0.2 * imgs + 0.1 * noise
    # metadata: group ids (8 binary identity columns for civilcomments,
    # urban flag for poverty, region for fmow, user id for amazon,
    # location otherwise)
    if spec.name == "civilcomments":
        meta = rng.randint(0, 2, size=(n, len(CIVIL_GROUPS))).astype(np.int64)
    elif spec.name == "poverty":
        meta = rng.randint(0, 2, size=(n, 1)).astype(np.int64)  # urban flag
    elif spec.name == "fmow":
        # regions 0..5 incl. the excluded "Other" so the metric's
        # exclusion path is exercised
        meta = rng.randint(0, len(FMOW_REGIONS), size=(n, 1)).astype(np.int64)
    elif spec.name == "amazon":
        meta = rng.randint(0, 30, size=(n, 1)).astype(np.int64)  # user id
    else:
        meta = rng.randint(0, 4, size=(n, 1)).astype(np.int64)
    return x, y, meta


def load_wilds(
    task: str,
    split: str,
    subsample: Optional[float] = None,
    seed: int = 0,
    fold: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x, y, metadata). split in {train, val, test, id_val}.
    Fractional ``subsample`` keeps the first fraction (reference
    _wilds_subsample, wilds1.py:193-200). ``fold`` selects a PovertyMap
    cross-validation fold A-E (reference wilds1.py poverty fold=...,
    poverty.py 5-fold protocol); cache file ``poverty_<split>_fold<F>.npz``."""
    spec = TASKS[task]
    stem = f"{task}_{split}" + (f"_fold{fold}" if fold else "")
    path = os.path.join(data_dir(), "wilds", f"{stem}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            x, y, meta = f["x"], f["y"], f["meta"]
        if subsample is not None:
            k = int(len(x) * subsample) if subsample <= 1 else int(subsample)
            x, y, meta = x[:k], y[:k], meta[:k]
        return x, y, meta
    # synthetic fallback: size the generation to the subsample directly.
    # Seed salt must be stable ACROSS processes (the phase workflow trains
    # and evaluates in separate CLI invocations): Python's hash() is
    # salted per-process, crc32 is not.
    n = {"train": 2048, "val": 512, "test": 512, "id_val": 512}[split]
    if subsample is not None:
        n = min(n, int(n * subsample) if subsample <= 1 else int(subsample))
    salt = zlib.crc32(f"{task}/{split}/{fold}".encode()) % 1000
    return _synthetic(spec, n, seed + salt)


# ---------------------------------------------------------------------------
# Official metrics (array re-implementations of wilds .eval)
# ---------------------------------------------------------------------------


def macro_f1(preds: np.ndarray, targets: np.ndarray, n_classes: int) -> float:
    """Macro-averaged F1 over classes present in targets or predictions
    (iWildCam's official metric, reference iwildcam.py:52)."""
    f1s = []
    for c in range(n_classes):
        tp = np.sum((preds == c) & (targets == c))
        fp = np.sum((preds == c) & (targets != c))
        fn = np.sum((preds != c) & (targets == c))
        if tp + fp + fn == 0:
            continue
        f1s.append(2 * tp / max(2 * tp + fp + fn, 1))
    return float(np.mean(f1s)) if f1s else 0.0


def worst_group_accuracy(
    preds: np.ndarray, targets: np.ndarray, group_meta: np.ndarray
) -> dict:
    """Per-identity-group x toxic/non-toxic accuracies and the worst
    (CivilComments fairness eval, reference civil.py:22-89). The
    reference's "worst group accuracy" (civil.py:86) also mins over the
    all / all-toxic / all-non-toxic aggregate rows — they matter when
    examples carrying NO identity flag drag an aggregate below every
    identity cell. Differential test:
    tests/test_reference_parity_civil_groups.py."""
    correct = preds == targets
    out, worst = {}, 1.0
    for gi, gname in enumerate(CIVIL_GROUPS[: group_meta.shape[1]]):
        for label in (0, 1):
            sel = (group_meta[:, gi] == 1) & (targets == label)
            if sel.sum() == 0:
                continue
            acc = float(correct[sel].mean())
            out[f"acc_{gname}_y{label}"] = acc
            worst = min(worst, acc)
    out["accuracy"] = float(correct.mean())
    for label in (0, 1):
        sel = targets == label
        if sel.sum():
            out[f"acc_all_y{label}"] = float(correct[sel].mean())
            worst = min(worst, out[f"acc_all_y{label}"])
    worst = min(worst, out["accuracy"])
    out["worst_group_acc"] = worst
    return out


def worst_region_accuracy(
    preds: np.ndarray, targets: np.ndarray, region_meta: np.ndarray
) -> dict:
    """FMoW official metric: per-region accuracies and the worst over the
    five real regions, excluding the 'Other' region (id 5) — matching the
    WILDS ``dataset.eval`` key ``acc_worst_region`` the reference reports
    (reference fmow.py:70; regions looped 0..4 at fmow.py:84)."""
    correct = preds == targets
    region = region_meta.reshape(len(preds), -1)[:, 0]
    out = {"accuracy": float(correct.mean())}
    worst = []
    for rid, rname in enumerate(FMOW_REGIONS):
        sel = region == rid
        if sel.sum() == 0:
            continue
        acc = float(correct[sel].mean())
        out[f"acc_region_{rname}"] = acc
        if rname != "other":
            worst.append(acc)
    out["worst_region_acc"] = min(worst) if worst else 0.0
    return out


def tenth_percentile_accuracy(
    preds: np.ndarray, targets: np.ndarray, user_meta: np.ndarray
) -> dict:
    """Amazon official metric: accuracy per reviewer (user), reported at
    the 10th percentile across users with at least one example — the
    WILDS ``dataset.eval`` key ``10th_percentile_acc`` the reference
    reports (reference amazon.py:53; WILDS groups by metadata user
    column and takes ``np.percentile(accs, 10)``)."""
    correct = preds == targets
    user = user_meta.reshape(len(preds), -1)[:, 0]
    accs = np.array(
        [float(correct[user == u].mean()) for u in np.unique(user)]
    )
    return {
        "accuracy": float(correct.mean()),
        "10th_percentile_acc": float(np.percentile(accs, 10)) if len(accs) else 0.0,
        "worst_user_acc": float(accs.min()) if len(accs) else 0.0,
        "n_users": int(len(accs)),
    }


def pearson_r(preds: np.ndarray, targets: np.ndarray) -> float:
    p, t = preds.reshape(-1), targets.reshape(-1)
    p = p - p.mean()
    t = t - t.mean()
    denom = np.sqrt((p**2).sum() * (t**2).sum())
    return float((p * t).sum() / denom) if denom > 0 else 0.0


def worst_urban_rural_pearson(
    preds: np.ndarray, targets: np.ndarray, urban_meta: np.ndarray
) -> dict:
    """PovertyMap official metric: worst of urban/rural Pearson r
    (reference poverty.py:45)."""
    rs = {}
    for flag, name in [(1, "urban"), (0, "rural")]:
        sel = urban_meta.reshape(-1) == flag
        if sel.sum() > 1:
            rs[f"r_{name}"] = pearson_r(preds[sel], targets[sel])
    rs["r_all"] = pearson_r(preds, targets)
    rs["r_worst"] = min(rs.get("r_urban", 1.0), rs.get("r_rural", 1.0))
    return rs


def evaluate_task(task: str, preds: np.ndarray, targets: np.ndarray, meta: np.ndarray) -> dict:
    """Dispatch to the task's official metric (reference
    ``dataset.eval``, camelyon.py:45)."""
    spec = TASKS[task]
    if spec.metric == "macro_f1":
        return {
            "accuracy": float((preds == targets).mean()),
            "macro_f1": macro_f1(preds, targets, spec.classes),
        }
    if spec.metric == "worst_group_acc":
        return worst_group_accuracy(preds, targets, meta)
    if spec.metric == "worst_region_acc":
        return worst_region_accuracy(preds, targets, meta)
    if spec.metric == "tenth_percentile_acc":
        return tenth_percentile_accuracy(preds, targets, meta)
    if spec.metric == "pearson":
        return worst_urban_rural_pearson(preds, targets, meta)
    return {"accuracy": float((preds == targets).mean())}
