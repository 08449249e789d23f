"""PyTorch port, the WILDS engine's mesh paths with running-statistics
BatchNorm (``static_bn: false``) on camelyon17's tiny DenseNet, in a gloo
world of 2 against the port's own one-process run of the same row:

  * data parallelism (MAP): each norm's batch statistics, and so the
    running statistics it steps, are the whole batch's (``channel_stats``'
    collective);
  * member parallelism: a deep ensemble of 2 MAP members, one a rank, each
    member's statistics its own, gathered after each epoch;
  * SVGD with one particle a rank: K2 on the gathered particles, each
    particle's statistics stepped by its owner and broadcast to the other
    rank after each step (``parallel/mesh.py::broadcast_member_buffers``).

Tolerances: the states, the statistics among them, within JAX's engine
tolerance, 2e-4 relative and 1e-5 absolute (``test_engine_parallel.py:57``),
as tests/test_torch_mesh_wilds_knobs.py holds the static rows; the two
ranks' states equal."""
import torch

from _torch_parity import assert_close
from _torch_mesh_ranks import TASK, engines, run_world, split_data, wilds_job
from _torch_mesh_ranks import wilds_config as config

torch.set_num_threads(1)
STATE = dict(rtol=2e-4, atol=1e-5)
JOBS = {
    "map": config(static_bn=False),
    "members": config(members=2, static_bn=False),
    "svgd": config(model="svgd", svgd_particles=2, static_bn=False, epochs=1),
}


def test_running_statistics_across_ranks(tmp_path):
    jobs = {name: {"kind": "wilds", "task": TASK, "config": cfg, "data": split_data(), "evals": ["host"]}
            for name, cfg in JOBS.items()}
    ranks = run_world(engines, 2, tmp_path, jobs)
    for name, job in jobs.items():
        one = wilds_job(job)
        stats = [k for k in one["state"] if k.endswith((".mean", ".var")) and "BatchNorm_0" in k]
        assert stats, name
        for r, result in enumerate(ranks):
            got = result[name]
            assert got["state"].keys() == one["state"].keys(), name
            for k, want in one["state"].items():
                assert_close(got["state"][k].float().numpy(), want.float().numpy(),
                             err_msg=f"{name} rank {r} {k}", **STATE)
        for k in stats:
            assert torch.equal(ranks[0][name]["state"][k], ranks[1][name]["state"][k]), (name, k)
