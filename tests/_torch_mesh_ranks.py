"""Worlds of ranks for the port's multi-process tests (tests/test_torch_mesh*.py).

:func:`run_world` spawns ``world`` processes on the CPU, each joining a gloo
process group through a ``FileStore`` in the test's ``tmp_path`` (never a
fixed port: several xdist workers run at once) with a 60 s collective time
limit, capped at one intra-op thread, runs ``fn(rank, world, *args)`` and
returns the ranks' results in rank order. The parent joins the world within
its own time limit and kills every child when one fails or the time runs
out, so a stuck collective fails the test instead of hanging the suite.

This module and every rank function it runs import no JAX: the JAX side of a
comparison runs in the pytest process, and only numpy arrays and tensors
cross over.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 120


def _child(fn, rank: int, world: int, store: str, out: str, args) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        record = {"ok": True, "result": fn(rank, world, *args)}
    except BaseException:  # reported by the parent
        record = {"ok": False, "error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out}.tmp", "wb") as f:
        pickle.dump(record, f)
    os.replace(f"{out}.tmp", out)


def run_world(fn, world: int, tmp_path, *args, timeout: float = WORLD_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` on each rank of a gloo world of ``world``
    CPU processes; their results in rank order. Raises with a rank's
    traceback if one failed, and when the world outlives ``timeout``."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    tag = f"{fn.__name__}_{world}_{time.monotonic_ns()}"
    store = os.path.join(tmp, f"{tag}.store")
    outs = [os.path.join(tmp, f"{tag}.rank{r}") for r in range(world)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, outs[r], args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: a world of {world} outlived {timeout} s")
            failed = [r for r, p in enumerate(procs) if not p.is_alive() and p.exitcode != 0]
            if failed:
                raise RuntimeError(f"{fn.__name__}: rank {failed[0]} exited with {procs[failed[0]].exitcode}")
            if any(os.path.exists(o) and _failed(o) for o in outs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    results = []
    for r, o in enumerate(outs):
        if not os.path.exists(o):
            raise RuntimeError(f"{fn.__name__}: rank {r} left no result (exit code {procs[r].exitcode})")
        with open(o, "rb") as f:
            record = pickle.load(f)
        if not record["ok"]:
            raise AssertionError(f"{fn.__name__}: rank {r} of {world} failed:\n{record['error']}")
        results.append(record["result"])
    return results


def _failed(path: str) -> bool:
    with open(path, "rb") as f:
        return not pickle.load(f)["ok"]


# --- the collectives, placement and the grid --------------------------------

THETA = (0.3, -1.2, 2.0)


def collectives(rank: int, world: int) -> dict:
    """Every mesh primitive on one rank of a world of 2 (a data axis of 2) or
    4 (member 2 x data 2); the parent holds the results against a
    one-process computation."""
    from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
    from beyond_deep_ensembles_tpu_torch.parallel import mesh
    from beyond_deep_ensembles_tpu_torch.parallel.pipelines import ParallelTrainer

    out = {}
    m = mesh.make_mesh(member_parallel=2 if world == 4 else 1)
    out["shape"], out["coords"] = m.shape, (m.coordinate(mesh.MEMBER_AXIS), m.coordinate(mesh.DATA_AXIS))
    out["cached"] = mesh.make_mesh(member_parallel=m.member_size) is m
    try:
        mesh.make_mesh(member_parallel=3)
    except ValueError as e:
        out["indivisible"] = str(e)
    out["engine"] = mesh.engine_mesh({"data_parallel": True}, "data_parallel", n_members=2).shape
    out["engine_off"] = mesh.engine_mesh({"data_parallel": False}, "data_parallel") is None

    # the reductions' values and gradients: a loss per rank of the mean and
    # sum over the data axis, the parameter's gradient averaged over it
    theta = torch.tensor(THETA, requires_grad=True)
    with mesh.use_mesh(m):
        assert mesh.active() is m
        y = mesh.all_reduce_mean(theta * (rank + 1))
        z = mesh.all_reduce_sum(theta**2 * (rank + 1))
        loss = ((y * (rank + 2)) ** 2).sum() + (torch.sin(z) * (rank + 1)).sum()
        loss.backward()
    assert mesh.active() is None
    out["y"], out["z"] = y.detach(), z.detach()
    out["grad_data"] = mesh.mean_of([theta.grad], mesh.DATA_AXIS, m)[0]
    # the gather over the member axis and its gradient
    theta.grad = None
    w = mesh.all_gather((theta * (rank + 1))[None], mesh.MEMBER_AXIS, m)
    weight = torch.arange(w.numel(), dtype=torch.float32).reshape(w.shape) * (rank + 1)
    (w * weight).sum().backward()
    out["gathered"] = w.detach()
    out["grad_member"] = mesh.mean_of([theta.grad], mesh.MEMBER_AXIS, m)[0]
    # one collective for several tensors; a bool is AND-ed
    out["mean_of"] = mesh.mean_of([torch.tensor([float(rank), 1.0]), torch.tensor(rank != 1)], mesh.DATA_AXIS, m)

    # placement
    batch = (torch.arange(16.0).reshape(8, 2), torch.arange(8))
    shard = mesh.shard_batch(m, batch)
    out["shard"] = (shard.batch, shard.offset, shard.total)
    odd = mesh.shard_batch(m, (torch.arange(5.0),))
    out["odd"] = (odd.batch[0], odd.offset, odd.total)
    t, u = torch.full((3,), float(rank)), torch.full((2,), float(rank))
    mesh.replicate(m, [t])
    mesh.replicate(m, [u], axis=mesh.DATA_AXIS)
    out["replicated"], out["replicated_data"] = t, u

    class Member:
        step = 0

        def __init__(self, value):
            self.value = torch.full((2,), value)

        def state_dict(self):
            return {"value": self.value, "step": torch.tensor(self.step)}

        def load_state_dict(self, state):
            self.value.copy_(state["value"])
            self.step = int(state["step"])

    full = EnsembleState([Member(0.0), Member(0.0)])
    trainer = ParallelTrainer(None, m, n_members=2)
    own = trainer.place_state(full)
    out["own"] = (own.first, len(own.members))
    for member in own.members:
        member.value.fill_(10.0 * (own.first + 1) + m.coordinate(mesh.DATA_AXIS))
        member.step = 5
    whole = trainer.gather_state(own)
    out["gathered_members"] = [(mm.value.clone(), mm.step) for mm in whole.members]
    out["metrics"] = trainer.reduce_metrics({"loss": torch.tensor(float(rank)),
                                             "loss_per_member": torch.full((len(own.members),), float(rank))})
    return out


# --- the methods on the (member, data) grid -----------------------------------


def _w(params, name="w"):
    return params[name] if isinstance(params, dict) else getattr(params, name)


def _linear_loss(params, model_state, noise, batch):
    from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput

    x, y = batch
    return LossOutput(loss=torch.mean((x @ _w(params) - y) ** 2))


def _bbb_loss(params, model_state, noise, batch):
    from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput

    x, y = batch
    mean = _w(params, "w__gmean")
    eps = noise.normal(tuple(mean.shape), mean.device, True, False)
    w = mean + torch.nn.functional.softplus(_w(params, "w__grho")) * eps
    return LossOutput(loss=torch.mean((x @ w - y) ** 2))


def _module(arrays: dict):
    module = torch.nn.Module()
    for name, a in arrays.items():
        module.register_parameter(name, torch.nn.Parameter(torch.tensor(np.asarray(a))))
    return module


CASES = ("map", "bbb_ensemble", "svgd", "hmc", "sgmcmc", "mfvi")


def _case(name: str, inputs: dict):
    """(method, state, n_members) of a case, from the JAX test's inputs."""
    from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior
    from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
    from beyond_deep_ensembles_tpu_torch.methods.ensemble import deep_ensemble
    from beyond_deep_ensembles_tpu_torch.methods.hmc import hmc_method
    from beyond_deep_ensembles_tpu_torch.methods.map import map_method
    from beyond_deep_ensembles_tpu_torch.methods.sgmcmc import sgmcmc_method
    from beyond_deep_ensembles_tpu_torch.methods.svgd import svgd_method
    from beyond_deep_ensembles_tpu_torch.methods.vi import mfvi_method
    from beyond_deep_ensembles_tpu_torch.utils.optim import SGD, Adam

    n = inputs["n"]
    if name == "map":
        method = map_method(_linear_loss, lambda ps: (SGD(ps, 0.1), None))
        return method, method.init(_module(inputs["params"]), {}), 1
    if name == "bbb_ensemble":
        inner = bbb_method(_bbb_loss, lambda ps: (SGD(ps, 0.05), None), GaussianPrior(0.0, 1.0), dataset_size=n,
                           mc_samples=2)
        method = deep_ensemble(inner, 2)
        return method, method.init([_module(p) for p in inputs["params"]]), 2
    if name == "svgd":
        method = svgd_method(_linear_loss, lambda ps: (SGD(ps, 0.05), None), particle_count=2, dataset_size=n,
                             l2_reg=1e-3)
        return method, method.init(torch.nn.ModuleList(_module(p) for p in inputs["params"]), {}), 2
    if name == "hmc":
        method = hmc_method(_linear_loss, dataset_size=n, step_size=5e-3, n_leapfrog=8, prior_std=1.0,
                            target_accept_rate=0.9, step_size_adaptation_speed=0.1)
    elif name == "sgmcmc":
        method = sgmcmc_method(_linear_loss, dataset_size=n, step_size_fn=1e-3, momentum_decay=0.9,
                               preconditioner="rmsprop", sample_interval=3)
    else:
        method = mfvi_method(_linear_loss, lambda ps: (Adam(ps, 1e-2), None), dataset_size=n, mc_samples=2)
    return method, method.init(_module(inputs["params"]), {}), 1


def _noise(name: str, draws, step: int):
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

    if name == "bbb_ensemble":
        return NoiseSource(given={m: [torch.tensor(e) for e in d] for m, d in draws.items()})
    if name in ("map", "svgd"):
        return NoiseSource(key=keys.as_key(keys.fold_in(0, step), "cpu"))
    if name == "mfvi":
        return {"eps": [torch.tensor(e) for e in draws]}
    return {k: torch.tensor(v) for k, v in draws.items()}


def run_case(name: str, inputs: dict) -> dict:
    """A case's updates through ``ParallelTrainer`` under a process group (on
    the JAX rule's mesh), else through the method alone; the whole final
    state (members gathered) and the last metrics."""
    from beyond_deep_ensembles_tpu_torch.parallel import mesh
    from beyond_deep_ensembles_tpu_torch.parallel.pipelines import LocalTrainer, ParallelTrainer

    method, state, n_members = _case(name, inputs)
    if mesh.is_distributed():
        grid = mesh.make_mesh(member_parallel=mesh.member_axis_size(mesh.world_size(), n_members))
        trainer = ParallelTrainer(method, grid, n_members=n_members)
    else:
        trainer = LocalTrainer(method)
    state = trainer.place_state(state)
    metrics = None
    for i, batch in enumerate(inputs["batches"]):
        batch = tuple(torch.tensor(np.asarray(b)) for b in batch)
        state, metrics = trainer.update(state, _noise(name, inputs["draws"][i], i), batch)
    state = trainer.gather_state(state)
    return {"state": {k: v.detach().clone() for k, v in state.state_dict().items()},
            "metrics": {k: torch.as_tensor(v).detach().clone() for k, v in metrics.items()}}


def methods(rank: int, world: int, inputs: dict) -> dict:
    return {name: run_case(name, inputs[name]) for name in inputs}


# --- the engines ----------------------------------------------------------------

TASK = "camelyon17"


def wilds_config(**extra) -> dict:
    """JAX's ``test_engine_parallel.py`` camelyon17 row (tiny DenseNet, 64
    images, batches of 16, two epochs, seed 3), ``data_parallel`` on."""
    from beyond_deep_ensembles_tpu_torch.experiments import wilds_task

    return {**wilds_task.DEFAULT_CONFIG, "model": "map", "tiny": True, "batch_size": 16, "eval_batch_size": 16,
            "eval_samples": 2, "epochs": 2, "dataset_size": 64, "steps_per_epoch": 4, "pretrained": False, "seed": 3,
            "data_parallel": True, **extra}


def split_data(n: int = 64, n_test: int = 48):
    """JAX's ``_synth_camelyon`` train split and the synthetic test split,
    cut to 32x32 (NHWC)."""
    from beyond_deep_ensembles_tpu_torch.data import wilds as wilds_data

    rng = np.random.RandomState(0)
    x, y = rng.randn(n, 32, 32, 3).astype(np.float32), rng.randint(0, 2, size=n).astype(np.int64)
    xt, yt, mt = wilds_data.load_wilds(TASK, "test", subsample=n_test)
    return x, y, xt[:, :32, :32], yt, mt


def _tensors(state: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v for k, v in state.items()}


def wilds_job(job: dict) -> dict:
    """One WILDS engine run (``build`` -> ``train`` -> ``eval_task``) of
    ``job["config"]`` on the CPU, from ``job["init"]`` (a port state_dict)
    where given: the trained state, and the metrics of each of
    ``job["evals"]`` ("host": the host loop, "runner": the eval runner), and
    with ``eval_init`` the host-loop metrics of the initial state."""
    from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
    from beyond_deep_ensembles_tpu_torch.parallel.pipelines import trainer_for

    task, config = job["task"], job["config"]
    x, y, xt, yt, mt = job["data"]
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), config["steps_per_epoch"], device="cpu")
    if job.get("init") is not None:
        built.state.load_state_dict(_tensors(job["init"]))
    x, xt = wilds_task.task_images(task, config, x), wilds_task.task_images(task, config, xt)
    out = {}
    if job.get("eval_init"):
        built.trainer = trainer_for(config, built.method)
        out["eval_init"] = wilds_task.eval_task(built, task, {**config, "device_eval": False}, xt, yt, mt)
    built = wilds_task.train(built, config, x, y)
    out["state"] = {k: v.detach().clone() for k, v in built.state.state_dict().items()}
    out["metrics"] = {mode: wilds_task.eval_task(built, task, {**config, "device_eval": mode == "runner"}, xt, yt, mt)
                      for mode in job.get("evals", ())}
    return out


def uci_job(job: dict) -> dict:
    """One UCI engine run (``build`` -> ``train``) from ``job["init"]``: the
    trained state."""
    from beyond_deep_ensembles_tpu_torch.experiments import uci

    config = job["config"]
    x, y = job["data"]
    built = uci.build(config, x.shape[0], torch.Generator().manual_seed(0), device="cpu")
    if job.get("init") is not None:
        built.state.load_state_dict(_tensors(job["init"]))
    built = uci.train(built, config, x, y, seed=job.get("seed", 0))
    return {"state": {k: v.detach().clone() for k, v in built.state.state_dict().items()}}


def engines(rank: int, world: int, jobs: dict) -> dict:
    """Each job in turn (``kind``: wilds or uci)."""
    run = {"wilds": wilds_job, "uci": uci_job}
    return {name: run[job["kind"]](job) for name, job in jobs.items()}


def cli(rank: int, world: int, argv: list) -> None:
    """The CLI under a process group (``run.main`` finds the group made)."""
    from beyond_deep_ensembles_tpu_torch import run

    run.main(argv)
