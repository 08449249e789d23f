"""PyTorch port, experiments/wilds_task.py's regression eval (poverty)
against the JAX package's ``eval_task`` on a deterministic linear model of
``(mean, std)`` outputs over PovertyMap-shaped inputs: ``RegressionResults``
(``avg_lml``, ``avg_ll``, ``mse``, ``qce``, ``sqce``, from the S outputs
``[S, N, 1, 2]``, the quantile normals JAX draws from ``seed + 1`` given to
the port) and the worst urban/rural Pearson r of the sample means, the last
partial batch padded and trimmed; and, with noise in the model, the port's
eval runner (``device_eval``: on the CPU it runs its batches eagerly)
against its host loop, which must carry the same outputs.

Tolerances: against JAX 1e-5 (relative or absolute; fp32 sums of 10 points
in another order); runner against host loop exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods.api import MethodState
from beyond_deep_ensembles_tpu_torch.methods.map import map_method

N, SEED = 10, 42
CONFIG = {"eval_batch_size": 4, "eval_samples": 3, "ece_bins": 10, "model": "map"}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((N, 8, 4, 4)).astype(np.float32)
    y = rng.standard_normal((N, 1)).astype(np.float32)
    meta = np.array([[0], [1]] * (N // 2), np.int64)
    w = (0.3 * rng.standard_normal((8 * 16, 1))).astype(np.float32)
    return x, y, meta, w


def _port_built(w, apply_fn):
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w))
    method = map_method(None, lambda params: (None, None))
    return wilds_task.BuiltExperiment(model=None, method=method, state=MethodState(module, {}, None),
                                      apply_fn=apply_fn, device=torch.device("cpu"), task="poverty", regression=True)


def test_regression_eval_matches_jax():
    x, y, meta, w = _data()
    jmethod = jax_map_method(None, optax.sgd(0.1))

    def jax_apply(p, s, k, xb):
        mean = xb.reshape(xb.shape[0], -1) @ p["w"]
        return jnp.stack([mean, jnp.full_like(mean, 0.5)], axis=-1)

    jbuilt = jax_wilds.BuiltExperiment(model=None, method=jmethod, apply_fn=jax_apply, regression=True,
                                       state=jmethod.init(jax.random.key(0), {"w": jnp.asarray(w)}))
    want = jax_wilds.eval_task(jbuilt, "poverty", CONFIG, x, y, meta, seed=SEED)

    seen = []

    def apply_fn(params, model_state, noise, xb):
        seen.append(xb.shape[0])
        mean = xb.reshape(xb.shape[0], -1) @ params.w
        return torch.stack([mean, torch.full_like(mean, 0.5)], dim=-1)

    z = torch.from_numpy(np.asarray(jax.random.normal(jax.random.key(SEED + 1), (CONFIG["eval_samples"], N, 1))))
    got = wilds_task.eval_task(_port_built(w, apply_fn), "poverty", CONFIG, x, y, meta, seed=SEED, z=z)
    assert seen == [4] * 9  # 3 batches (the last padded from 2) x 3 samples
    assert set(got) == set(want) == {"avg_lml", "avg_ll", "mse", "qce", "sqce", "r_urban", "r_rural", "r_all",
                                     "r_worst"}
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"regression eval {k}")


def test_eval_runner_carries_the_regression_outputs():
    x, y, meta, w = _data(1)

    def apply_fn(params, model_state, noise, xb):
        mean = xb.reshape(xb.shape[0], -1) @ params.w + noise.normal((xb.shape[0], 1), xb.device, True, False)
        return torch.stack([mean, torch.full_like(mean, 0.7)], dim=-1)

    built = _port_built(w, apply_fn)
    runner = wilds_task.eval_task(built, "poverty", {**CONFIG, "device_eval": True}, x, y, meta)
    host = wilds_task.eval_task(built, "poverty", {**CONFIG, "device_eval": False}, x, y, meta)
    assert len(built.eval_runners) == 1 and runner == host
    assert runner != wilds_task.eval_task(built, "poverty", {**CONFIG, "device_eval": False}, x, y, meta, seed=7)
