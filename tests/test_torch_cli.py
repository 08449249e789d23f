"""PyTorch port, the CLI (``run.py``, ``utils/config.py``,
``utils/logging.py``) held against the JAX package's on the CPU:

  * ``load_sweep`` / ``expand_config`` on ``configs/cifar.yaml``: the JAX
    package's dicts, equal;
  * on ``configs/uci.yaml`` (a ``list`` of 8 data sets zipped under a
    ``grid`` of 9 models) the JAX ``expand_config`` raises (it pops the
    list's length inside its loop, and the grid's second point finds the set
    empty), so the port's 72 runs are held against the JAX function applied
    to each grid point alone, in grid order;
  * ``run.main`` on a two-data-set ``map`` sweep with ``--device cpu``
    against the JAX ``run.main`` on the same file: the same
    ``<out>/<name>_<variant>/rep_<k>/metrics.jsonl`` files, records and keys
    (the values come from other initial weights); ``--rep`` and ``--name``;
  * the logger's records, the phases the port lacks, the missing card."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from _torch_parity import one_cpu_thread  # noqa: F401 (a fixture)
from beyond_deep_ensembles_tpu.utils import config as jax_config
from beyond_deep_ensembles_tpu_torch import run
from beyond_deep_ensembles_tpu_torch.utils import config
from beyond_deep_ensembles_tpu_torch.utils.logging import RunLogger, VoidLog

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

SWEEP = """\
---
name: "DEFAULT"
repetitions: 2
params:
  batch_size: 256
  epochs: 1
  eval_samples: 2
  learn_var: true
  model: "map"
---
name: "small"
list:
  dataset: ["yacht", "boston"]
params: {}
---
name: "other"
params:
  dataset: "energy"
"""


def test_cifar_sweep_equals_jax():
    mine = list(config.load_sweep(str(CONFIGS / "cifar.yaml")))
    assert mine == list(jax_config.load_sweep(str(CONFIGS / "cifar.yaml")))
    assert len(mine) > 10
    only = list(config.load_sweep(str(CONFIGS / "cifar.yaml"), name="MultiSWAG"))
    assert only == [s for s in mine if s["name"] == "MultiSWAG"] and len(only) == 1


def test_uci_sweep_equals_jax_per_grid_point():
    docs = [d for d in yaml.safe_load_all((CONFIGS / "uci.yaml").read_text()) if d]
    with pytest.raises(KeyError):
        list(jax_config.load_sweep(str(CONFIGS / "uci.yaml")))
    mine = list(config.load_sweep(str(CONFIGS / "uci.yaml")))
    assert mine == list(config.expand_sweep(docs))
    assert len(mine) == 72 and {s["name"] for s in mine} == {"yacht"}
    assert [s["variant"] for s in mine] == list(range(72))
    merged = jax_config._deep_merge(docs[0], docs[1])
    want = [p for model in merged["grid"]["model"]
            for p in jax_config.expand_config({**merged, "grid": {"model": [model]}})]
    assert [s["params"] for s in mine] == want
    assert all(s["repetitions"] == 5 for s in mine)
    assert mine[0]["params"] == {**docs[0]["params"], "model": "map", "dataset": "yacht"}
    assert mine[-1]["params"]["model"] == "ivon" and mine[-1]["params"]["dataset"] == "naval"
    # documents the JAX function takes: equal
    for doc in ({"params": {"a": 1, "n": {"x": 1}}, "grid": {"b": [1, 2], "c": [3, 4]}},
                {"params": {"a": 1}, "grid": {"b": [1]}, "list": {"d": [5, 7], "e": [6, 8]}},
                {"params": {"n": {"x": 1}}, "list": {"n": [{"y": 2}, {"x": 3}]}}):
        assert config.expand_config(doc) == jax_config.expand_config(doc)


def _tree(out: Path) -> dict:
    """{relative path of every metrics.jsonl: its records without the
    timing field}."""
    files = {}
    for path in sorted(out.rglob("metrics.jsonl")):
        records = [json.loads(line) for line in path.read_text().splitlines()]
        files[str(path.relative_to(out))] = [{k: v for k, v in r.items() if k != "_t"} for r in records]
    return files


def _keys(node):
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_keys(v) for v in node]
    return type(node).__name__


def test_main_layout_and_keys_equal_jax(tmp_path):
    from beyond_deep_ensembles_tpu import run as jax_run

    sweep = tmp_path / "sweep.yaml"
    sweep.write_text(SWEEP)
    jax_run.main(["uci", str(sweep), "--out", str(tmp_path / "jax")])
    run.main(["uci", str(sweep), "--out", str(tmp_path / "port"), "--device", "cpu"])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want) == [f"{v}/rep_{r}/metrics.jsonl" for v in ("other_0", "small_0", "small_1")
                                           for r in (0, 1)]
    for path in want:
        assert _keys(got[path]) == _keys(want[path]), path
        (g,), (w,) = got[path], want[path]
        assert g["_name"] == w["_name"] and sorted(g["plain"][0]) == ["avg_ll", "avg_lml", "mse", "qce", "sqce"]
        assert all(np.isfinite(v) for v in g["plain"][0].values())

    run.main(["uci", str(sweep), "--out", str(tmp_path / "one"), "--device", "cpu", "--rep", "1", "--name", "other"])
    assert sorted(_tree(tmp_path / "one")) == ["other_0/rep_1/metrics.jsonl"]


def test_logger_records(tmp_path, capsys):
    log = RunLogger(str(tmp_path / "a"), name="x/r0")
    log.info("hello")
    log.metrics({"m": np.float32(1.5)}, step=3)
    log.metrics({"m": 2.0})
    log.close()
    records = [json.loads(line) for line in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["_name"], r["m"], r.get("_step")) for r in records] == [("x/r0", 1.5, 3), ("x/r0", 2.0, None)]
    assert "[x/r0 " in capsys.readouterr().out
    VoidLog().info("dropped")
    VoidLog().metrics({"m": 1})
    RunLogger(None, use_wandb=False).metrics({"m": 1})  # no file: nothing written


def test_unported_phases_and_missing_card(tmp_path):
    log = VoidLog()
    for phase in ("fit_laplace", "drop_rates", "eval", "multix"):
        with pytest.raises(NotImplementedError, match="item 15"):
            run.run_phase("camelyon17", phase, {"model": "map"}, [str(tmp_path)], log)
    with pytest.raises(ValueError, match="not supported"):
        run.run_phase("uci", "multix", {}, [str(tmp_path)], log)
    with pytest.raises(ValueError, match="unknown task"):
        run.run_task("mnist", {}, log, device="cpu")
    if not torch.cuda.is_available():
        sweep = tmp_path / "sweep.yaml"
        sweep.write_text(SWEEP)
        with pytest.raises(RuntimeError, match="CUDA"):
            run.main(["uci", str(sweep), "--out", str(tmp_path / "out"), "--name", "other", "--rep", "0"])
