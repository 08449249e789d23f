"""PyTorch port, run.py and experiments/wilds_task.py with ``static_bn:
false`` (running-statistics BatchNorm in every DenseNet norm) on the CPU at
the tiny width: configs/camelyon.yaml's MAP, MultiSWAG (5 members), BBB,
SVGD and Laplace rows cut to a few steps through ``run.main --device cpu``,
each writing finite metrics and its ``{model}_final``; every member's and
particle's statistics stepped and saved in the final, and restored from it
(a MultiSWAG final restores each member's own statistics); the checkpoint
phases on what the rows wrote (``eval`` of ``map_final``, ``fit_laplace``,
``drop_rates``, ``multix``) equal the runs' own evals, and the eval runner
equals the host loop, all on the running statistics.

Comparisons are for equality (the same CPU arithmetic)."""
import json
import math
import shutil
from pathlib import Path

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
       "eval_samples": 2, "svgd_particles": 2, "swag_start_epoch": 0, "swag_updates": 2, "static_bn": False}
ROWS = ("MAP", "MultiSWAG", "BBB", "SVGD", "Laplace")
# the tiny DenseNet's norms: the stem's, two in each of its 4 dense layers, one
# transition's and the last
TINY_NORMS = 1 + 2 * 4 + 1 + 1


def _sweep(path, names=ROWS):
    """configs/camelyon.yaml's rows ``names`` cut to CUT (MAP twice when
    asked for by ``names`` beside MCD, for multix), written to ``path``."""
    docs = [d for d in yaml.safe_load_all((CONFIGS / "camelyon.yaml").read_text()) if d]
    default = {**docs[0], "repetitions": 1, "params": {**docs[0]["params"], **CUT}}
    twice = "MCD" in names
    rows = [{**d, "repetitions": 2} if twice and d["name"] == "MAP" else d for d in docs[1:] if d["name"] in names]
    path.write_text(yaml.safe_dump_all([default] + rows))
    return {d["name"]: {**default["params"], **d["params"]} for d in docs[1:] if d["name"] in names}


def _last(path):
    record = json.loads(path.read_text().splitlines()[-1])
    return {k: v for k, v in record.items() if not k.startswith("_")}


def _statistics(state_dict):
    return {k: v for k, v in state_dict.items() if k.endswith((".mean", ".var")) and "BatchNorm_0" in k}


def test_running_stats_rows_through_the_cli(tmp_path):
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    rows = _sweep(sweep)
    assert rows["MultiSWAG"]["members"] == 5
    for name in ROWS:
        run.main(["camelyon17", str(sweep), "--name", name, "--out", str(out), "--device", "cpu"])
        run_dir = out / f"{name}_0" / "rep_0"
        result = _last(run_dir / "metrics.jsonl")
        assert all(math.isfinite(v) for v in result.values() if isinstance(v, float)), (name, result)
        assert 0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0, (name, result)
        model = rows[name]["model"]
        config, built, _, _ = wilds_task._rebuild("camelyon17", rows[name], device="cpu")
        state = ckpt.restore_final(str(run_dir), model, wilds_task._build_for("camelyon17", config, built.device).state)
        stats = _statistics(state.state_dict())
        units = config["svgd_particles"] if model == "svgd" else config["members"]
        assert len(stats) == 2 * TINY_NORMS * units, (name, len(stats))
        assert all(not torch.equal(v, torch.zeros_like(v)) for k, v in stats.items() if k.endswith(".mean")), name
        if name == "MultiSWAG":  # each member its own statistics
            first = [v for k, v in stats.items() if k.startswith("members.0.") and k.endswith(".mean")]
            second = [v for k, v in stats.items() if k.startswith("members.1.") and k.endswith(".mean")]
            assert first and not all(torch.equal(a, b) for a, b in zip(first, second))
    run.main(["camelyon17", str(sweep), "--name", "MAP", "--out", str(out), "--rep", "0", "--phase", "eval",
              "--device", "cpu"])
    evaluated = _last(out / "MAP_0" / "rep_0" / "eval" / "metrics.jsonl")
    assert evaluated == _last(out / "MAP_0" / "rep_0" / "metrics.jsonl")


def test_running_stats_phases_equal_the_runs_own_evals(tmp_path):
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    rows = _sweep(sweep, ("MAP", "MCD", "Laplace"))
    run.main(["camelyon17", str(sweep), "--out", str(out), "--device", "cpu"])
    results = {name: _last(out / f"{name}_0" / "rep_0" / "metrics.jsonl") for name in rows}

    shutil.copy(out / "MAP_0" / "rep_0" / "map_final", out / "Laplace_0" / "rep_0" / "map_final")
    run.main(["camelyon17", str(sweep), "--name", "Laplace", "--out", str(out), "--rep", "0", "--phase",
              "fit_laplace", "--device", "cpu"])
    assert _last(out / "Laplace_0" / "rep_0" / "fit_laplace" / "metrics.jsonl") == results["Laplace"]

    run.main(["camelyon17", str(sweep), "--name", "MCD", "--out", str(out), "--rep", "0", "--phase", "drop_rates",
              "--device", "cpu"])
    assert _last(out / "MCD_0" / "rep_0" / "drop_rates" / "metrics.jsonl")["p=0.1"] == results["MCD"]

    run.main(["camelyon17", str(sweep), "--name", "MAP", "--out", str(out), "--phase", "multix", "--device", "cpu"])
    got = _last(out / "MAP_0" / "multix" / "metrics.jsonl")
    config, built, _, test = wilds_task._rebuild("camelyon17", rows["MAP"], "cpu")
    states = [ckpt.restore_final(str(out / "MAP_0" / f"rep_{r}"), "map",
                                 wilds_task._build_for("camelyon17", config, "cpu").state) for r in range(2)]
    assert not torch.equal(*(_statistics(st.state_dict())["params.DenseNet_0._BN_0.BatchNorm_0.var"] for st in states))
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    assert got == json.loads(json.dumps(wilds_task.eval_task(built, "camelyon17", config, *test)))


def test_running_stats_eval_runner_equals_host_loop():
    row = {"model": "mcd", "dropout_p": 0.1, **CUT, "subsample": 12,
           "test_subsample": 7, "eval_batch_size": 3}
    config, built, (x, y), test = wilds_task._rebuild("camelyon17", row, "cpu")
    built = wilds_task.train(built, config, x, y)
    host = wilds_task.eval_task(built, "camelyon17", {**config, "device_eval": False}, *test)
    runner = wilds_task.eval_task(built, "camelyon17", {**config, "device_eval": True}, *test)
    assert runner == host
