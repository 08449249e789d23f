"""PyTorch port, run.py and experiments/wilds_task.py on the ResNet-50 image
tasks, on the CPU at the tiny width (stage sizes (1, 1), 32x32 crops):
sweeps written from ``configs/iwildcam.yaml`` and ``configs/rxrx1.yaml``'s own
documents, cut to a few steps (relu, as the yamls run), driven through
``run.main --device cpu``:

  * every row of each yaml trains and writes its ``metrics.jsonl`` record
    (finite, in range; ``macro_f1`` for iwildcam) and its ``{model}_final``
    (iwildcam's SWAG_LL_PODS with its multi-device flags, a no-op on one
    device; rxrx1 under ``cosine_warmup``);
  * the checkpoint phases on what iwildcam's train phase wrote: ``eval`` of
    MAP's ``map_final`` equals the MAP run's own eval; ``fit_laplace`` of it
    in the Laplace row's directory equals the Laplace row's eval;
    ``drop_rates`` at the row's p equals the MCD run's eval; ``multix`` over
    MAP's two repetitions equals ``eval_task`` of a deep ensemble of the two
    states.

Comparisons are for equality (the same CPU arithmetic)."""
import json
import math
import shutil
from pathlib import Path

import pytest
import yaml

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from beyond_deep_ensembles_tpu_torch import run
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble
from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CUT = {"tiny": True, "epochs": 1, "subsample": 8, "test_subsample": 6, "batch_size": 4, "eval_batch_size": 4,
       "eval_samples": 2, "svgd_particles": 2, "swag_start_epoch": 0, "swag_updates": 2}


def _docs(task):
    return [d for d in yaml.safe_load_all((CONFIGS / f"{task}.yaml").read_text()) if d]


def _sweep(task, path, names=None):
    """configs/<task>.yaml cut to CUT (MAP twice, the other rows once),
    written to ``path``; every row, or those in ``names``."""
    docs = _docs(task)
    default = {**docs[0], "repetitions": 1, "params": {**docs[0]["params"], **CUT}}
    rows = [{**d, "repetitions": 2} if d["name"] == "MAP" else d for d in docs[1:] if names is None or d["name"] in names]
    path.write_text(yaml.safe_dump_all([default] + rows))
    return [d["name"] for d in rows]


def _last(path):
    record = json.loads(path.read_text().splitlines()[-1])
    return {k: v for k, v in record.items() if not k.startswith("_")}


@pytest.mark.parametrize("task", ["iwildcam", "rxrx1"])
def test_main_runs_every_row(task, tmp_path):
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    names = _sweep(task, sweep)
    assert len(names) == {"iwildcam": 8, "rxrx1": 6}[task]
    run.main([task, str(sweep), "--out", str(out), "--device", "cpu"])
    params = {d["name"]: d["params"] for d in _docs(task)}
    for name in names:
        run_dir = out / f"{name}_0" / "rep_0"
        result = _last(run_dir / "metrics.jsonl")
        assert all(math.isfinite(v) for v in result.values()), (name, result)
        assert 0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0, (name, result)
        if task == "iwildcam":
            assert 0.0 <= result["macro_f1"] <= 1.0, (name, result)
        assert (run_dir / f"{params[name]['model']}_final").exists(), name


def test_phases_equal_the_runs_own_evals(tmp_path):
    task = "iwildcam"
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    _sweep(task, sweep, ("MAP", "MCD", "Laplace"))
    run.main([task, str(sweep), "--out", str(out), "--device", "cpu"])
    results = {name: _last(out / f"{name}_0" / "rep_0" / "metrics.jsonl") for name in ("MAP", "MCD", "Laplace")}

    run.main([task, str(sweep), "--name", "MAP", "--out", str(out), "--rep", "0", "--phase", "eval", "--device", "cpu"])
    assert _last(out / "MAP_0" / "rep_0" / "eval" / "metrics.jsonl") == results["MAP"]

    shutil.copy(out / "MAP_0" / "rep_0" / "map_final", out / "Laplace_0" / "rep_0" / "map_final")
    run.main([task, str(sweep), "--name", "Laplace", "--out", str(out), "--rep", "0", "--phase", "fit_laplace",
              "--device", "cpu"])
    assert _last(out / "Laplace_0" / "rep_0" / "fit_laplace" / "metrics.jsonl") == results["Laplace"]

    run.main([task, str(sweep), "--name", "MCD", "--out", str(out), "--rep", "0", "--phase", "drop_rates",
              "--device", "cpu"])
    rates = _last(out / "MCD_0" / "rep_0" / "drop_rates" / "metrics.jsonl")
    assert rates["p=0.1"] == results["MCD"]

    run.main([task, str(sweep), "--name", "MAP", "--out", str(out), "--phase", "multix", "--device", "cpu"])
    got = _last(out / "MAP_0" / "multix" / "metrics.jsonl")
    docs = {d["name"]: d for d in yaml.safe_load_all(sweep.read_text())}
    params = {**docs["DEFAULT"]["params"], **docs["MAP"]["params"]}
    config, built, _, test = wilds_task._rebuild(task, params, "cpu")
    states = [ckpt.restore_final(str(out / "MAP_0" / f"rep_{r}"), "map", wilds_task._build_for(task, config, "cpu").state)
              for r in range(2)]
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    assert got == json.loads(json.dumps(wilds_task.eval_task(built, task, config, *test)))
