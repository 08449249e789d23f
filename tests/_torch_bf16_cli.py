"""Every yaml row at a bf16 compute dtype on the port alone, on the CPU at
the tiny width (tests/test_torch_bf16_cli*.py): each row of a WILDS yaml
with ``compute_dtype: bf16`` added (each of ``configs/cifar.yaml`` with
``bf16: true``) builds and takes one finite update (a training epoch of one
batch), or raises where the same row raises at fp32; and the layers that
take the compute dtype hold bf16 exactly where the JAX package gives it (no
SNGP model, no model of Rank-1 layers throughout). :func:`main_runs` drives
one row through ``run.main --device cpu`` with the key in the sweep's
DEFAULT: its ``metrics.jsonl`` record finite."""
import json
import math
from pathlib import Path

import pytest
import torch
import yaml

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from beyond_deep_ensembles_tpu_torch import run
from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# one update of batch 4 (CIFAR: 16) on the tiny width; eval cut for run.main
CUT = {"tiny": True, "epochs": 1, "subsample": 4, "test_subsample": 4, "batch_size": 4, "eval_batch_size": 4,
       "eval_samples": 2, "svgd_particles": 2, "swag_start_epoch": 0, "swag_updates": 2}
CIFAR_CUT = {"epochs": 1, "subsample": 16, "test_subsample": 10, "batch_size": 16, "eval_batch_size": 10,
             "eval_samples": 2, "swag_start_epoch": 0}


def rows(yaml_name):
    """(DEFAULT's params, {row name: params}) of configs/<yaml_name>.yaml."""
    docs = [d for d in yaml.safe_load_all((CONFIGS / f"{yaml_name}.yaml").read_text()) if d]
    return docs[0].get("params", {}), {d["name"]: d.get("params", {}) for d in docs[1:]}


def _bf16_layers(module):
    return [m for m in module.modules() if getattr(m, "dtype", None) == torch.bfloat16]


def _fp32_parameters(state_dict):
    """The parameters and optimizer buffers stay fp32 (a SWAG ring of
    ``ring_dtype: bf16`` is bf16 by its own key)."""
    return not any(t.dtype == torch.bfloat16 for k, t in state_dict.items() if "swag.deviations" not in k)


def _finite(state_dict):
    return all(bool(torch.isfinite(t).all()) for t in state_dict.values() if t.is_floating_point())


def one_update(task, yaml_name, name):
    """Row ``name`` of configs/<yaml_name>.yaml at bf16: the fp32 row's
    refusal, or one finite update with the compute dtype where JAX puts it."""
    default, table = rows(yaml_name)
    row = {**default, **table[name], **CUT}
    try:
        wilds_task._not_ported(task, {**wilds_task.DEFAULT_CONFIG, **row})
    except NotImplementedError as refused:
        with pytest.raises(type(refused)):
            wilds_task._rebuild(task, {**row, "compute_dtype": "bf16"}, "cpu")
        return
    config, built, (x, y), _ = wilds_task._rebuild(task, {**row, "compute_dtype": "bf16"}, "cpu")
    model = config["model"]
    module = built.model.module
    all_rank1 = model == "rank1" and (task in ("camelyon17", "poverty") or bool(config.get("all_layers_bbb")))
    assert bool(_bf16_layers(module)) == (model != "sngp" and not all_rank1), (name, model)
    built = wilds_task.train(built, config, x, y)
    state = built.state.state_dict()
    assert _finite(state), name
    assert _fp32_parameters(state), name


def one_cifar_update(name):
    default, table = rows("cifar")
    row = {**cifar.DEFAULT_CONFIG, **default, **table[name], **CIFAR_CUT}
    row["members"] = min(row.get("members", 1), 2)
    try:
        cifar._not_ported(row)
    except NotImplementedError as refused:
        with pytest.raises(type(refused)):
            cifar._not_ported({**row, "bf16": True})
        return
    config, (x, y), _ = cifar._load_data({**row, "bf16": True})
    built = cifar._build_for(config, "cpu")
    module = built.model.module
    assert bool(_bf16_layers(module)) == (config["model"] not in ("sngp", "rank1")), name
    built = cifar.train(built, config, x, y)
    state = built.state.state_dict()
    assert _finite(state), name
    assert _fp32_parameters(state), name


def main_runs(task, yaml_name, name, tmp_path):
    """Row ``name`` through ``run.main`` with ``compute_dtype: bf16`` (CIFAR:
    ``bf16: true``) in the sweep's DEFAULT; its record finite."""
    docs = [d for d in yaml.safe_load_all((CONFIGS / f"{yaml_name}.yaml").read_text()) if d]
    key = {"bf16": True} if task == "cifar" else {"compute_dtype": "bf16"}
    cut = CIFAR_CUT if task == "cifar" else CUT
    default = {**docs[0], "repetitions": 1, "params": {**docs[0].get("params", {}), **cut, **key}}
    default.pop("list", None)
    sweep, out = tmp_path / "sweep.yaml", tmp_path / "out"
    sweep.write_text(yaml.safe_dump_all([default] + [d for d in docs[1:] if d["name"] == name]))
    run.main([task, str(sweep), "--out", str(out), "--device", "cpu"])
    record = json.loads((out / f"{name}_0" / "rep_0" / "metrics.jsonl").read_text().splitlines()[-1])
    metrics = {k: v for k, v in record.items() if not k.startswith("_")}
    values = [x for v in metrics.values() for x in (v.values() if isinstance(v, dict) else [v])
              if isinstance(x, (int, float))]
    assert values and all(math.isfinite(v) for v in values), record
