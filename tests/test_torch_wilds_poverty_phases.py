"""PyTorch port, run.py and experiments/wilds_task.py on PovertyMap, on the
CPU at the tests' small size (the full ResNet-18 on 32x32 crops of the
synthetic 8-channel splits, a few steps): sweeps written from
``configs/poverty.yaml``'s own documents, driven through ``run.main
--device cpu``:

  * the yaml's ``list: fold: [A..E]`` expands every row to five runs, each in
    its own directory on its own fold's splits;
  * the checkpoint phases on what fold A's train phase wrote: ``eval`` of
    MAP's ``map_final`` equals the MAP run's own eval; ``fit_laplace`` of it
    in the Laplace row's directory equals the Laplace row's eval (the
    regression Laplace); ``drop_rates`` at the row's p equals the MCD run's
    eval; ``multix`` over MAP's two repetitions equals ``eval_task`` of a
    deep ensemble of the two states;
  * ``model: sngp`` raises, citing the JAX package's own failure there.

Comparisons are for equality (the same CPU arithmetic)."""
import json
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
from beyond_deep_ensembles_tpu_torch.utils.config import load_sweep

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# 10 test images: both urban and rural ones on every fold's synthetic split
CUT = {"tiny": True, "epochs": 1, "subsample": 8, "test_subsample": 10, "batch_size": 4, "eval_batch_size": 4,
       "eval_samples": 2, "svgd_particles": 2, "swag_start_epoch": 0, "swag_updates": 2}


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


def test_folds_expand_to_five_runs_on_their_own_splits(tmp_path):
    specs = list(load_sweep(str(CONFIGS / "poverty.yaml")))
    assert len(specs) == 8 * 5
    assert [s["params"]["fold"] for s in specs if s["name"] == "Laplace"] == ["A", "B", "C", "D", "E"]
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    _sweep(sweep, ("MAP",), folds=("A", "B", "C", "D", "E"))
    run.main(["poverty", str(sweep), "--out", str(out), "--rep", "0", "--device", "cpu"])
    results = [_last(out / f"MAP_{v}" / "rep_0" / "metrics.jsonl") for v in range(5)]
    assert len({json.dumps(r, sort_keys=True) for r in results}) == 5  # five folds, five sets of splits
    firsts = []
    for fold in "ABCDE":
        x, _, _, yt, _ = wilds_task._load_task_data("poverty", {**_docs()[0]["params"], **CUT, "fold": fold})
        assert x.shape == (8, 8, 32, 32) and yt.shape == (10, 1)
        firsts.append(x[0].tobytes())
    assert len(set(firsts)) == 5


def test_phases_equal_the_runs_own_evals(tmp_path):
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    _sweep(sweep, ("MAP", "MCD", "Laplace"))
    run.main(["poverty", str(sweep), "--out", str(out), "--device", "cpu"])
    results = {name: _last(out / f"{name}_0" / "rep_0" / "metrics.jsonl") for name in ("MAP", "MCD", "Laplace")}

    run.main(["poverty", str(sweep), "--name", "MAP", "--out", str(out), "--rep", "0", "--phase", "eval",
              "--device", "cpu"])
    assert _last(out / "MAP_0" / "rep_0" / "eval" / "metrics.jsonl") == results["MAP"]

    shutil.copy(out / "MAP_0" / "rep_0" / "map_final", out / "Laplace_0" / "rep_0" / "map_final")
    run.main(["poverty", str(sweep), "--name", "Laplace", "--out", str(out), "--rep", "0", "--phase", "fit_laplace",
              "--device", "cpu"])
    assert _last(out / "Laplace_0" / "rep_0" / "fit_laplace" / "metrics.jsonl") == results["Laplace"]

    run.main(["poverty", str(sweep), "--name", "MCD", "--out", str(out), "--rep", "0", "--phase", "drop_rates",
              "--device", "cpu"])
    rates = _last(out / "MCD_0" / "rep_0" / "drop_rates" / "metrics.jsonl")
    assert rates["p=0.1"] == results["MCD"]

    run.main(["poverty", str(sweep), "--name", "MAP", "--out", str(out), "--phase", "multix", "--device", "cpu"])
    got = _last(out / "MAP_0" / "multix" / "metrics.jsonl")
    docs = {d["name"]: d for d in yaml.safe_load_all(sweep.read_text())}
    params = {**docs["DEFAULT"]["params"], **docs["MAP"]["params"], "fold": "A"}
    config, built, _, test = wilds_task._rebuild("poverty", params, "cpu")
    states = [ckpt.restore_final(str(out / "MAP_0" / f"rep_{r}"), "map",
                                 wilds_task._build_for("poverty", config, "cpu").state) for r in range(2)]
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    assert got == json.loads(json.dumps(wilds_task.eval_task(built, "poverty", config, *test)))


def test_sngp_raises_citing_the_jax_failure(tmp_path):
    sweep = tmp_path / "sweep.yaml"
    docs = _docs()
    default = {**docs[0], "repetitions": 1, "params": {**docs[0]["params"], **CUT}, "list": {"fold": ["A"]}}
    sweep.write_text(yaml.safe_dump_all([default, {"name": "SNGP", "params": {"model": "sngp"}}]))
    with pytest.raises(NotImplementedError, match="incompatible shapes"):
        run.main(["poverty", str(sweep), "--out", str(tmp_path / "out"), "--device", "cpu"])
