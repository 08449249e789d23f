"""PyTorch port, the WILDS engine's other mesh paths on camelyon17 (tiny
DenseNet, static batch norm), each in a gloo world of 2 against the port's
own one-process run of the same row (tests/test_torch_mesh_wilds.py holds
the data-parallel row against the JAX engine's mesh, and the one-process
rows stand against JAX's in the row-parity files):

  * member parallelism: a deep ensemble of 2 MAP members, one a rank
    (``members: 2``, JAX's ``test_wilds_engine_member_parallel_equals_
    single_device``), the members gathered after each epoch;
  * the epoch runner over every rank's copy of the data (``device_data``
    with ``data_parallel``, JAX's ``test_mesh_epoch_runner_matches_single_
    device``);
  * the ``ring_shard`` + ``ring_dtype: bf16`` SWAG row (JAX's
    ``test_ring_knobs_config_driven_through_engine``): each rank stores its
    ``[K, D/2]`` bf16 columns of the ring and its ``[D/2]`` moments; the
    ranks' columns joined are the one-process ring.

Tolerances: the states within JAX's engine tolerance, 2e-4 relative and 1e-5
absolute (``test_engine_parallel.py:57``); the ring and the moments, joined,
within JAX's own bound for them, 1e-2 relative and 1e-3 absolute (bf16
storage of deviations made from parameters that differ by the reduction
order).
"""
import torch

from _torch_parity import assert_close
from _torch_mesh_ranks import TASK, engines, run_world, split_data, wilds_job
from _torch_mesh_ranks import wilds_config as config

torch.set_num_threads(1)
STATE = dict(rtol=2e-4, atol=1e-5)
JOBS = {
    "members": config(members=2),
    "epoch_runner": config(device_data=True),
    "ring": config(model="swag", swag_start_epoch=0, ring_dtype="bf16", ring_shard=True),
}
RING = ("swag.deviations", "swag.mean", "swag.sq_mean")


def test_member_parallel_epoch_runner_and_sharded_ring(tmp_path):
    jobs = {name: {"kind": "wilds", "task": TASK, "config": cfg, "data": split_data(), "evals": ["host"]}
            for name, cfg in JOBS.items()}
    ranks = run_world(engines, 2, tmp_path, jobs)
    for name, job in jobs.items():
        one = wilds_job(job)
        for r, result in enumerate(ranks):
            got = result[name]
            assert got["state"].keys() == one["state"].keys(), name
            for k, want in one["state"].items():
                if k in RING:
                    continue
                assert_close(got["state"][k].float().numpy(), want.float().numpy(),
                                           err_msg=f"{name} rank {r} {k}", **STATE)
            for k, w in one["metrics"]["host"].items():
                # (the ring row's D, 3034, divides over the ranks: its draws
                # are the one-process row's, no padding)
                if isinstance(w, float):
                    assert_close(got["metrics"]["host"][k], w, err_msg=f"{name} rank {r} {k}",
                                               **STATE)
    # the members: each rank trained one, and both hold both after the gather;
    # every rank's eval is the whole split's
    for k, v in ranks[0]["members"]["state"].items():
        assert torch.equal(ranks[1]["members"]["state"][k], v), k
    for name in jobs:
        assert ranks[0][name]["metrics"] == ranks[1][name]["metrics"], name
    # the ring: bf16 columns a rank, joined the one-process ring
    one = wilds_job(jobs["ring"])["state"]
    d = one["swag.mean"].shape[0]
    for k in RING:
        parts = [result["ring"]["state"][k] for result in ranks]
        width = -(-d // 2)
        assert all(p.shape[-1] == width for p in parts), (k, [p.shape for p in parts])
        assert parts[0].dtype == (torch.bfloat16 if k == "swag.deviations" else torch.float32)
        joined = torch.cat(parts, dim=-1)[..., :d]
        assert_close(joined.float().numpy(), one[k].float().numpy(), rtol=1e-2, atol=1e-3,
                                   err_msg=f"ring {k}")
