"""PyTorch port, the UCI engine's mesh path and the CLI under a process group.

The UCI cases are JAX's own (``tests/test_engine_parallel.py``): MAP with
``data_parallel`` (64 rows, batches of 16, three epochs, seed 5) and SVGD's
two particles on the member axis (two epochs, seed 7). The JAX engine runs
them here on the 8-device CPU mesh the conftest forces, from a state the
port is given in its layout (``models/jax_convert.py::state_from_jax``); the
port runs them in gloo worlds of 2 (SVGD: member 2) and 4 (MAP: data 4;
SVGD: member 2 x data 2) and in this process without a group. Tolerance:
JAX's engine tolerance, 2e-4 relative and 1e-5 absolute
(``test_engine_parallel.py:57``, its SVGD case's :333).

The CLI: ``run.main`` on a UCI sweep whose row sets ``data_parallel``, in a
world of one rank, writes the records of the unflagged run without a group,
bit for bit (a sum over one rank divided by one is the value itself).
"""
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_mesh_ranks import cli, engines, run_world, uci_job
from beyond_deep_ensembles_tpu.experiments import uci as jax_uci
from beyond_deep_ensembles_tpu_torch import run
from beyond_deep_ensembles_tpu_torch.experiments import uci
from beyond_deep_ensembles_tpu_torch.models.jax_convert import state_from_jax

torch.set_num_threads(1)
ENGINE = dict(rtol=2e-4, atol=1e-5)


def _case(model, data_seed, key, seed, epochs, **extra):
    """JAX's mesh run of a case: the port job (from JAX's initial state) and
    JAX's trained state in the port's layout."""
    rng = np.random.RandomState(data_seed)
    x = rng.randn(64, 6).astype(np.float32)
    y = (x @ rng.randn(6, 1)).astype(np.float32)
    config = {**uci.DEFAULT_CONFIG, "model": model, "in_dim": 6, "batch_size": 16, "epochs": epochs,
              "data_parallel": True, **extra}
    jconfig = {**jax_uci.DEFAULT_CONFIG, **config}
    jbuilt = jax_uci.build(jconfig, 64, jax.random.key(key))
    port = uci.build(config, 64, torch.Generator().manual_seed(0), device="cpu")
    module = port.state.params

    def converted(state):
        return {k: v.numpy() for k, v in state_from_jax(module, state, lr=config["lr"], var_lr=config["var_lr"]).items()}

    job = {"kind": "uci", "config": config, "data": (x, y), "init": converted(jbuilt.state), "seed": seed}
    jbuilt = jax_uci.train(jbuilt, jconfig, x, y, seed=seed)
    return job, converted(jax.device_get(jbuilt.state))


@pytest.fixture(scope="module")
def cases():
    return {"map": _case("map", 0, 1, 5, 3), "svgd": _case("svgd", 1, 2, 7, 2, svgd_particles=2)}


@pytest.mark.parametrize("world", [2, 4])
def test_uci_data_and_particle_parallel_match_jax_mesh_and_one_process(cases, world, tmp_path):
    ranks = run_world(engines, world, tmp_path, {name: job for name, (job, _) in cases.items()})
    for name, (job, want) in cases.items():
        one = uci_job(job)["state"]
        for k, w in want.items():
            assert_close(one[k].numpy(), w, err_msg=f"{name} one process {k}", **ENGINE)
        for r, result in enumerate(ranks):
            got = result[name]["state"]
            assert got.keys() == one.keys()
            for k, w in want.items():
                assert_close(got[k].numpy(), w, err_msg=f"{name} rank {r} of {world} {k}", **ENGINE)
                assert_close(got[k].numpy(), one[k].numpy(), err_msg=f"{name} rank {r} vs one {k}",
                                           **ENGINE)
            assert all(torch.equal(got[k], v) for k, v in ranks[0][name]["state"].items()), name


SWEEP = """\
---
name: "DEFAULT"
repetitions: 1
params:
  batch_size: 32
  epochs: 2
  eval_samples: 2
  model: "map"
  dataset: "yacht"
---
name: "row"
params:
  data_parallel: {flag}
"""


def _records(out):
    lines = (out / "row_0" / "rep_0" / "metrics.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(line).items() if k != "_t"} for line in lines]


def test_flagged_cli_in_a_world_of_one_is_the_unflagged_run(tmp_path):
    for flag in ("true", "false"):
        (tmp_path / f"{flag}.yaml").write_text(SWEEP.format(flag=flag))
    run_world(cli, 1, tmp_path, ["uci", str(tmp_path / "true.yaml"), "--device", "cpu", "--out",
                                 str(tmp_path / "flagged")])
    run.main(["uci", str(tmp_path / "false.yaml"), "--device", "cpu", "--out", str(tmp_path / "plain")])
    flagged, plain = _records(tmp_path / "flagged"), _records(tmp_path / "plain")
    assert flagged == plain and "plain" in flagged[0]
