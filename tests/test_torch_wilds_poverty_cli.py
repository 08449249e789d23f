"""PyTorch port, run.py and experiments/wilds_task.py on PovertyMap, on the
CPU at the tests' small size (the full ResNet-18 on 32x32 crops of the
synthetic 8-channel splits, a few steps): sweeps written from
``configs/poverty.yaml``'s own documents, driven through ``run.main
--device cpu``:

  * every row on fold A trains and writes its ``metrics.jsonl`` record
    (``avg_lml``, ``avg_ll``, ``mse``, ``qce``, ``sqce`` and the urban, rural,
    overall and worst Pearson r; finite, r in [-1, 1]) and its
    ``{model}_final``.

The folds, the checkpoint phases and the SNGP refusal are in
tests/test_torch_wilds_poverty_phases.py."""
import json
import math
from pathlib import Path

import yaml

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from beyond_deep_ensembles_tpu_torch import run

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# 10 test images: both urban and rural ones on every fold's synthetic split
CUT = {"tiny": True, "epochs": 1, "subsample": 8, "test_subsample": 10, "batch_size": 4, "eval_batch_size": 4,
       "eval_samples": 2, "svgd_particles": 2, "swag_start_epoch": 0, "swag_updates": 2}
KEYS = {"avg_lml", "avg_ll", "mse", "qce", "sqce", "r_urban", "r_rural", "r_all", "r_worst"}


def _docs():
    return [d for d in yaml.safe_load_all((CONFIGS / "poverty.yaml").read_text()) if d]


def _sweep(path, names=None, folds=("A",)):
    """configs/poverty.yaml cut to CUT on ``folds`` (MAP twice, the other
    rows once), written to ``path``; every row, or those in ``names``."""
    docs = _docs()
    default = {**docs[0], "repetitions": 1, "params": {**docs[0]["params"], **CUT}, "list": {"fold": list(folds)}}
    rows = [{**d, "repetitions": 2} if d["name"] == "MAP" else d for d in docs[1:] if names is None or d["name"] in names]
    path.write_text(yaml.safe_dump_all([default] + rows))
    return [d["name"] for d in rows]


def _last(path):
    record = json.loads(path.read_text().splitlines()[-1])
    return {k: v for k, v in record.items() if not k.startswith("_")}


def test_main_runs_every_row_on_a_fold(tmp_path):
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    names = _sweep(sweep)
    assert names == ["MAP", "MCD", "SWAG", "BBB", "Rank1", "SVGD", "iVON", "Laplace"]
    run.main(["poverty", str(sweep), "--out", str(out), "--device", "cpu"])
    params = {d["name"]: d["params"] for d in _docs()}
    for name in names:
        run_dir = out / f"{name}_0" / "rep_0"
        result = _last(run_dir / "metrics.jsonl")
        assert set(result) == KEYS and all(math.isfinite(v) for v in result.values()), (name, result)
        assert all(-1.0 <= result[k] <= 1.0 for k in ("r_urban", "r_rural", "r_all", "r_worst")), (name, result)
        assert 0.0 <= result["qce"] <= 0.5 and result["mse"] >= 0.0, (name, result)
        assert (run_dir / f"{params[name]['model']}_final").exists(), name
