"""PyTorch port, the WILDS engine's mesh path on camelyon17 (tiny DenseNet,
static batch norm) against the JAX engine's 8-device mesh run.

JAX's ``tests/test_engine_parallel.py`` case: MAP on 64 synthetic images,
batches of 16, two epochs, seed 3, ``data_parallel`` on. The JAX side runs
here on the 8-device CPU mesh the conftest forces (its static batch norms
reduce over the whole batch, as the port's ``channel_stats`` does over the
data axis), from the initial state the port is given; the port runs the row
in gloo worlds of 2 and 4 (``tests/_torch_mesh_ranks.py``) and in this
process without a group. The eval before training goes through the port's
mesh eval (each eval batch's rows split over the data axis, the outputs
gathered) and is held against the one-process host loop and JAX's mesh eval;
after training the mesh eval's host loop and its runner against each other
and against the one-process eval.

Tolerances: states within JAX's engine tolerance, 2e-4 relative and 1e-5
absolute (``test_engine_parallel.py:57``; the parameters whose true gradient
is zero, ``_torch_wilds_parity.zero_gradient``, within 6 lr, as the one-device
row parity holds them); evals of one state within 1e-5 relative and 1e-6
absolute (JAX's ``test_mesh_eval_matches_host_eval``), of the trained states
within the states' tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_mesh_ranks import TASK, engines, run_world, split_data, wilds_job
from _torch_mesh_ranks import wilds_config as config
from _torch_wilds_parity import jax_state_dict, zero_gradient
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task

torch.set_num_threads(1)
STATE = dict(rtol=2e-4, atol=1e-5)
EVAL = dict(rtol=1e-5, atol=1e-6)


def hold_states(got: dict, want: dict, lr: float, what: str):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g, w = got[k].detach().float().numpy(), np.asarray(w, np.float32)
        if zero_gradient(k.rsplit("params.", 1)[-1]):
            assert_close(g, w, rtol=0, atol=6 * lr, err_msg=f"{what} {k}")
        else:
            assert_close(g, w, err_msg=f"{what} {k}", **STATE)


def hold_metrics(got: dict, want: dict, what: str, tol: dict):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        if isinstance(w, float):
            assert_close(got[k], w, err_msg=f"{what} {k}", **tol)
        else:
            assert got[k] == w, (what, k)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's mesh run of the row: the initial state in the port's layout, its
    mesh eval, the trained state in the port's layout."""
    x, y, xt, yt, mt = split_data()
    cfg = config()
    jconfig = {**jax_wilds.DEFAULT_CONFIG, **{k: v for k, v in cfg.items() if k != "steps_per_epoch"}}
    jbuilt = jax_wilds.build(TASK, jconfig, jax.random.key(0), 4)
    port = wilds_task.build(TASK, cfg, torch.Generator().manual_seed(0), 4, device="cpu")
    init = {k: np.asarray(v) for k, v in jax_state_dict(port, jbuilt, cfg).items()}
    eval_init = jax_wilds.eval_task(jbuilt, TASK, {**jconfig, "device_eval": True}, xt, yt, mt)
    jbuilt = jax_wilds.train(jbuilt, jconfig, x, y)
    trained = {k: np.asarray(v) for k, v in jax_state_dict(port, jbuilt, cfg).items()}
    return init, eval_init, trained


def _job(init):
    return {"kind": "wilds", "task": TASK, "config": config(), "data": split_data(), "init": init,
            "evals": ["host", "runner"], "eval_init": True}


@pytest.fixture(scope="module")
def one_process(jax_run):
    """The port's run of the row in this process, without a group."""
    return wilds_job({**_job(jax_run[0]), "evals": ["host"]})


@pytest.mark.parametrize("world", [2, 4])
def test_camelyon17_data_parallel_matches_jax_mesh_and_one_process(jax_run, one_process, world, tmp_path):
    init, jax_eval_init, jax_trained = jax_run
    ranks = run_world(engines, world, tmp_path, {"dp": _job(init)})
    one = one_process
    lr = config()["lr"]
    hold_states(one["state"], jax_trained, lr, "one process vs JAX's mesh")
    hold_metrics(one["eval_init"], jax_eval_init, "one process's eval vs JAX's mesh eval", EVAL)
    for r, result in enumerate(ranks):
        got = result["dp"]
        hold_states(got["state"], jax_trained, lr, f"rank {r} of {world} vs JAX's mesh")
        hold_states(got["state"], one["state"], lr, f"rank {r} of {world} vs one process")
        hold_metrics(got["eval_init"], one["eval_init"], f"rank {r}: mesh eval vs host eval", EVAL)
        hold_metrics(got["eval_init"], jax_eval_init, f"rank {r}: mesh eval vs JAX's mesh eval", EVAL)
        hold_metrics(got["metrics"]["runner"], got["metrics"]["host"], f"rank {r}: eval runner vs host loop", EVAL)
        hold_metrics(got["metrics"]["host"], one["metrics"]["host"], f"rank {r}: trained eval", STATE)
        # every rank holds the same trained state and metrics
        first = ranks[0]["dp"]
        assert all(torch.equal(got["state"][k], v) for k, v in first["state"].items())
        assert got["metrics"] == first["metrics"]
