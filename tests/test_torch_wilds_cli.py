"""PyTorch port, run.py on the WILDS text tasks, on the CPU: sweeps written
from ``configs/amazon.yaml`` and ``configs/civilcomments.yaml``'s own
documents, cut to TINY_CONFIG's width (``tiny: true``) and a few steps,
driven through ``run.main --device cpu``:

  * every row of each yaml trains, writes its ``metrics.jsonl`` record and
    its ``{model}_final``;
  * the checkpoint phases on what the train phase wrote: ``eval`` of MAP's
    ``map_final`` equals the MAP run's own eval; ``fit_laplace`` of it (in
    the Laplace row's run directory, so that the phase takes that row's
    ``ll_hessian``) equals the Laplace row's eval (the same MAP training,
    then the fit); ``drop_rates`` of MCD's ``mcd_final`` at p = 0.2 equals
    the MCD run's eval; ``multix`` over MAP's two repetitions equals
    ``eval_task`` of a deep ensemble of the two restored states.

This is the repair of the WILDS CLI: ``run.main`` sets ``checkpoint_dir`` for
every train phase, which the engine refused before, so no WILDS row ran
through the CLI. Comparisons are for equality (the same CPU arithmetic)."""
import json
import math
import shutil
from pathlib import Path

import pytest
import torch
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


def _sweep(task, path, names=None):
    """configs/<task>.yaml cut to CUT (MAP twice, every other row once),
    written to ``path``; returns the row names."""
    docs = [d for d in yaml.safe_load_all((CONFIGS / f"{task}.yaml").read_text()) if d]
    default = {**docs[0], "repetitions": 1, "params": {**docs[0]["params"], **CUT}}
    rows = [d for d in docs[1:] if names is None or d["name"] in names]
    rows = [{**d, "repetitions": 2} if d["name"] == "MAP" else d for d in rows]
    path.write_text(yaml.safe_dump_all([default] + rows))
    return [d["name"] for d in rows]


def _last(path):
    record = json.loads(path.read_text().splitlines()[-1])
    return {k: v for k, v in record.items() if not k.startswith("_")}


@pytest.mark.parametrize("task", ["amazon", "civilcomments"])
def test_main_runs_every_row(task, tmp_path):
    sweep = tmp_path / "sweep.yaml"
    names = _sweep(task, sweep)
    run.main([task, str(sweep), "--out", str(tmp_path / "out"), "--rep", "0", "--device", "cpu"])
    for name in names:
        run_dir = tmp_path / "out" / f"{name}_0" / "rep_0"
        result = _last(run_dir / "metrics.jsonl")
        assert all(math.isfinite(v) for v in result.values()), (name, result)
        assert 0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0, (name, result)
        metric = "10th_percentile_acc" if task == "amazon" else "worst_group_acc"
        assert 0.0 <= result[metric] <= 1.0, (name, result)
        model = yaml_model(task, name)
        assert (run_dir / f"{model}_final").exists(), (name, sorted(p.name for p in run_dir.iterdir()))


def yaml_model(task, name):
    docs = {d["name"]: d for d in yaml.safe_load_all((CONFIGS / f"{task}.yaml").read_text()) if d}
    return docs[name]["params"]["model"]


@pytest.mark.parametrize("task", ["amazon", "civilcomments"])
def test_phases_equal_the_runs_own_evals(task, tmp_path):
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    _sweep(task, sweep, names=("MAP", "MCD", "Laplace"))
    run.main([task, str(sweep), "--out", str(out), "--device", "cpu"])
    results = {name: _last(out / f"{name}_0" / "rep_0" / "metrics.jsonl") for name in ("MAP", "MCD", "Laplace")}
    assert (out / "MAP_0" / "rep_1" / "map_final").exists()

    run.main([task, str(sweep), "--name", "MAP", "--out", str(out), "--rep", "0", "--phase", "eval", "--device", "cpu"])
    assert _last(out / "MAP_0" / "rep_0" / "eval" / "metrics.jsonl") == results["MAP"]

    shutil.copy(out / "MAP_0" / "rep_0" / "map_final", out / "Laplace_0" / "rep_0" / "map_final")
    run.main([task, str(sweep), "--name", "Laplace", "--out", str(out), "--rep", "0", "--phase", "fit_laplace",
              "--device", "cpu"])
    assert _last(out / "Laplace_0" / "rep_0" / "fit_laplace" / "metrics.jsonl") == results["Laplace"]

    run.main([task, str(sweep), "--name", "MCD", "--out", str(out), "--rep", "0", "--phase", "drop_rates",
              "--device", "cpu"])
    rates = _last(out / "MCD_0" / "rep_0" / "drop_rates" / "metrics.jsonl")
    assert sorted(rates) == [f"p={r}" for r in (0.05, 0.1, 0.2, 0.3, 0.5)] and rates["p=0.2"] == results["MCD"]

    run.main([task, str(sweep), "--name", "MAP", "--out", str(out), "--phase", "multix", "--device", "cpu"])
    got = _last(out / "MAP_0" / "multix" / "metrics.jsonl")
    docs = {d["name"]: d for d in yaml.safe_load_all(sweep.read_text())}
    params = {**docs["DEFAULT"]["params"], **docs["MAP"]["params"]}
    config, built, _, test = wilds_task._rebuild(task, params, "cpu")
    states = [ckpt.restore_final(str(out / "MAP_0" / f"rep_{r}"), "map", wilds_task._build_for(task, config, "cpu").state)
              for r in range(2)]
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    assert got == json.loads(json.dumps(wilds_task.eval_task(built, task, config, *test)))
    assert not torch.equal(states[0].params.Dense_1.kernel, states[1].params.Dense_1.kernel)  # two seeds
