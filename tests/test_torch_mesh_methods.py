"""PyTorch port, ``parallel/pipelines.py::ParallelTrainer`` and the methods
on the (member, data) grid, against the JAX package's mesh runs.

The cases are JAX's own ``tests/test_data_parallel_train.py``: MAP on a
data axis, a deep ensemble of BBB on member x data, SVGD's particles on
member x data, full-batch HMC, SGHMC and MFVI on a data axis, each a linear
model over 64 rows. The JAX side runs here, on the 8-device CPU mesh the
conftest forces, through its ``ParallelTrainer`` (or ``replicate`` and
``shard_batch``), and gives the port its draws (the ensemble's per member,
per MC sample; HMC's momenta and uniforms; SGHMC's and MFVI's normals). The
port runs every case in a gloo world of 2 and of 4 (``ParallelTrainer`` on
the JAX rule's grid: the two members or particles on the member axis where
they divide the ranks, the rest on the data axis), and in this process
without a group.

Tolerances, JAX's own: the steps' parameters within 1e-5 relative and 1e-6
absolute (``test_data_parallel_train.py:175``; HMC's 1e-4, its :331), the
metrics within 1e-5 relative; the port's worlds against its one-process run
likewise (the order of the reductions is all that differs).
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_mesh_ranks import methods, run_case, run_world

torch.set_num_threads(1)


def _jax_cases():
    """Each case's port inputs and JAX's mesh result: ``{case: (inputs,
    {"params": {name: array}, "metrics": {...}})}``."""
    import jax
    import jax.numpy as jnp
    import optax

    from beyond_deep_ensembles_tpu import tree as jtree
    from beyond_deep_ensembles_tpu.methods import GaussianPrior, LossOutput, bbb_method, deep_ensemble, map_method
    from beyond_deep_ensembles_tpu.methods import svgd_method
    from beyond_deep_ensembles_tpu.methods.hmc import hmc_method
    from beyond_deep_ensembles_tpu.methods.sgmcmc import sgmcmc_method
    from beyond_deep_ensembles_tpu.methods.vi import mfvi_method
    from beyond_deep_ensembles_tpu.parallel import ParallelTrainer, make_mesh, replicate, shard_batch
    from beyond_deep_ensembles_tpu.tree import tree_stack

    def linear(params, model_state, key, batch):
        x, y = batch
        return LossOutput(loss=jnp.mean((x @ params["w"] - y) ** 2))

    def bbb_loss(params, model_state, key, batch):
        x, y = batch
        eps = jax.random.normal(key, params["w__gmean"].shape)
        w = params["w__gmean"] + jax.nn.softplus(params["w__grho"]) * eps
        return LossOutput(loss=jnp.mean((x @ w - y) ** 2))

    def data(key, d, coef):
        x = jax.random.normal(jax.random.key(key), (64, d))
        return x, x @ jnp.asarray(coef)

    def minibatches(x, y):
        return [(np.asarray(x[i * 16 : (i + 1) * 16]), np.asarray(y[i * 16 : (i + 1) * 16])) for i in range(4)]

    def steps(trainer, state, keys, batches):
        metrics = None
        for k, b in zip(keys, batches):
            state, metrics = trainer.step(state, k, b)
        return jax.device_get(state), jax.device_get(metrics)

    def numpy_tree(t):
        return {k: np.asarray(v) for k, v in t.items()}

    out = {}
    coef3 = [[0.3], [-1.0], [2.0]]
    # MAP, data 8
    x, y = data(0, 4, [[1.0], [-2.0], [0.5], [2.0]])
    batches = minibatches(x, y)
    method = map_method(linear, optax.sgd(0.1))
    trainer = ParallelTrainer(method, mesh=make_mesh(8, member_parallel=1))
    params0 = {"w": jnp.zeros((4, 1))}
    state, metrics = steps(trainer, trainer.place_state(method.init(jax.random.key(1), params0, {})),
                           [jax.random.key(100 + i) for i in range(4)], batches)
    out["map"] = ({"n": 64, "params": numpy_tree(params0), "batches": batches, "draws": [None] * 4},
                  {"params": numpy_tree(state.params), "metrics": metrics})
    # deep ensemble of BBB, member 2 x data 4
    x, y = data(2, 3, coef3)
    batches = minibatches(x, y)
    members = [{"w__gmean": jax.random.normal(jax.random.key(10 + m), (3, 1)) * 0.1,
                "w__grho": jnp.full((3, 1), -2.0)} for m in range(2)]
    method = deep_ensemble(bbb_method(bbb_loss, optax.sgd(0.05), GaussianPrior(0.0, 1.0), dataset_size=64,
                                      mc_samples=2), 2)
    trainer = ParallelTrainer(method, mesh=make_mesh(8, member_parallel=2), n_members=2)
    keys = [jax.random.key(100 + i) for i in range(4)]
    draws = [{m: [np.asarray(jax.random.normal(k, (3, 1))) for k in jax.random.split(mk, 2)]
              for m, mk in enumerate(jax.random.split(key, 2))} for key in keys]
    state, metrics = steps(trainer, trainer.place_state(method.init(jax.random.key(3), tree_stack(members))), keys,
                           batches)
    out["bbb_ensemble"] = ({"n": 64, "params": [numpy_tree(p) for p in members], "batches": batches, "draws": draws},
                           {"params": numpy_tree(state.params), "metrics": metrics})
    # SVGD, particles 2 x data 4
    x, y = data(4, 3, coef3)
    batches = minibatches(x, y)
    particles = [{"w": jax.random.normal(jax.random.key(20 + p), (3, 1)) * 0.3} for p in range(2)]
    method = svgd_method(linear, optax.sgd(0.05), particle_count=2, dataset_size=64, l2_reg=1e-3)
    trainer = ParallelTrainer(method, mesh=make_mesh(8, member_parallel=2), n_members=2)
    state, metrics = steps(trainer, trainer.place_state(method.init(jax.random.key(5), tree_stack(particles), {})),
                           [jax.random.key(100 + i) for i in range(4)], batches)
    out["svgd"] = ({"n": 64, "params": [numpy_tree(p) for p in particles], "batches": batches, "draws": [None] * 4},
                   {"params": numpy_tree(state.params), "metrics": metrics})

    # the full-batch methods, data 8: each step's draws from its key
    def full_batch(name, seed, key_seed, init_seed, method, draw):
        x, y = data(seed, 3, coef3)
        mesh = make_mesh(8, member_parallel=1)
        params0 = {"w": jnp.zeros((3, 1))}
        state = replicate(mesh, method.init(jax.random.key(init_seed), params0, {}))
        batch = shard_batch(mesh, (x, y))
        update = jax.jit(method.update)
        draws, metrics = [], None
        for i in range(6):
            key = jax.random.fold_in(jax.random.key(key_seed), i)
            draws.append(draw(key, state))
            state, metrics = update(state, key, batch)
        state, metrics = jax.device_get(state), jax.device_get(metrics)
        inputs = {"n": 64, "params": numpy_tree(params0), "batches": [(np.asarray(x), np.asarray(y))] * 6,
                  "draws": draws}
        return inputs, {"params": numpy_tree(state.params), "metrics": metrics, "state": state}

    def flat(t):
        return np.asarray(t["w"]).reshape(-1)

    def hmc_draw(key, state):
        k_mom, k_accept, _ = jax.random.split(key, 3)
        return {"momentum": flat(jtree.normal_like(k_mom, state.params)),
                "uniform": np.asarray(jax.random.uniform(k_accept))}

    out["hmc"] = full_batch("hmc", 6, 7, 8, hmc_method(linear, dataset_size=64, step_size=5e-3, n_leapfrog=8,
                                                         prior_std=1.0, target_accept_rate=0.9,
                                                         step_size_adaptation_speed=0.1), hmc_draw)
    out["sgmcmc"] = full_batch(
        "sgmcmc", 9, 10, 11,
        sgmcmc_method(linear, dataset_size=64, step_size_fn=1e-3, momentum_decay=0.9, preconditioner="rmsprop",
                      sample_interval=3),
        lambda key, state: {"noise": flat(jtree.normal_like(jax.random.split(key)[1], state.params))})
    out["mfvi"] = full_batch(
        "mfvi", 12, 13, 14, mfvi_method(linear, optax.adam(1e-2), dataset_size=64, mc_samples=2),
        lambda key, state: [flat(jtree.normal_like(k, state.mean)) for k in jax.random.split(key, 2)])
    return out


@pytest.fixture(scope="module")
def cases():
    return _jax_cases()


def _port_params(name, state):
    """The port's final parameters in JAX's layout (members stacked)."""
    if name == "bbb_ensemble":
        return {k: np.stack([state[f"members.{m}.params.{k}"].numpy() for m in range(2)])
                for k in ("w__gmean", "w__grho")}
    if name == "svgd":
        return {"w": np.stack([state[f"params.{p}.w"].numpy() for p in range(2)])}
    return {"w": state["params.w"].numpy()}


def _hold(name, got, want, what):
    rtol = 1e-4 if name == "hmc" else 1e-5
    params = _port_params(name, got["state"])
    for k, w in want["params"].items():
        assert_close(params[k], w, rtol=rtol, atol=1e-6, err_msg=f"{what} {name} {k}")
    for k, w in want["metrics"].items():
        g = got["metrics"][k].numpy() if isinstance(got["metrics"][k], torch.Tensor) else got["metrics"][k]
        assert_close(g, np.asarray(w), rtol=1e-4 if name == "hmc" else 1e-5, atol=1e-6,
                                   err_msg=f"{what} {name} metric {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_methods_on_the_grid_match_jax_and_one_process(cases, world, tmp_path):
    inputs = {name: case[0] for name, case in cases.items()}
    ranks = run_world(methods, world, tmp_path, inputs)
    for name, (case_inputs, want) in cases.items():
        one = run_case(name, case_inputs)
        _hold(name, one, want, "one process vs JAX's mesh")
        for r, result in enumerate(ranks):
            _hold(name, result[name], want, f"rank {r} of {world} vs JAX's mesh")
            _hold(name, result[name], {"params": _port_params(name, one["state"]), "metrics": one["metrics"]},
                  f"rank {r} of {world} vs one process")
    # every rank ends with the same state, bit for bit
    for name in cases:
        first = ranks[0][name]["state"]
        for result in ranks[1:]:
            assert all(torch.equal(result[name]["state"][k], v) for k, v in first.items()), name
    hmc = cases["hmc"][1]
    assert float(ranks[0]["hmc"]["state"]["hmc.step_size"]) == pytest.approx(float(hmc["state"].step_size), rel=1e-5)
