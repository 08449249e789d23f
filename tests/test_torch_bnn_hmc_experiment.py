"""PyTorch port, the bnn-hmc experiment entries (``experiments/bnn_hmc.py``)
held against the JAX package's on a 2-layer MLP over blobs, from JAX's
initial weights (``init_params``), JAX's draws recomputed here from its
``fold_in(key(seed + 2), it)`` keys and given to the port through
``iteration_noise``; JAX's runs shard the batch over its 8 CPU devices:

* ``run_hmc``, 3 iterations, burn-in 1: every iteration's metrics (accept
  probability within rtol 1e-4, the others 1e-5), the final state
  (``bnn_state_from_jax``, rtol 1e-5 and 2e-5 of each vector's scale,
  flags and counts exactly), the eval dict and the averaged predictive
  within 1e-5 (each accept decision at least 1e-3 from the threshold);
* ``run_sgmcmc`` (SGHMC, RMS preconditioner, 2 epochs of 4 steps),
  ``run_vi`` (mc 2, 2 epochs) and ``run_sgd`` (cosine, 3 epochs): the
  final state within the same bounds;
* an HMC chain stopped in its third iteration and resumed (from
  ``checkpoint_1``), and an SGD run stopped in its third epoch and resumed,
  equal uninterrupted ones bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_bnn_parity import blobs, close
from _torch_parity import assert_close
from beyond_deep_ensembles_tpu import tree as jax_tree
from beyond_deep_ensembles_tpu.experiments import bnn_hmc as jax_bnn
from beyond_deep_ensembles_tpu.models.zoo import MLP as JaxMLP
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.experiments import bnn_hmc
from beyond_deep_ensembles_tpu_torch.models.jax_convert import (bnn_state_from_jax, model_params_from_jax,
                                                               sorted_flat_from_jax, state_from_jax)
from beyond_deep_ensembles_tpu_torch.models.zoo import MLP
from beyond_deep_ensembles_tpu_torch.nn.base import Model

SEED = 0


def models(x):
    jmodel = JaxModel(JaxMLP(layer_dims=(16,), out_dim=3))
    params, _ = jax.jit(jmodel.init)(jax.random.key(SEED), jnp.asarray(x[:2]))
    module = MLP(4, (16,), 3, generator=torch.Generator().manual_seed(7))
    return jmodel, params, Model(module), model_params_from_jax(module, params)


def step_key(it):
    return jax.random.fold_in(jax.random.key(SEED + 2), it)


def hold(got: dict, want: dict, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].detach().cpu()
        if w.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(g, w), (what, k, g, w)
        elif k == "hmc.accept_prob":
            assert_close(float(g), float(w), rtol=1e-4, err_msg=f"{what} {k}")
        else:
            close(g.numpy(), w.numpy(), f"{what} {k}")


def test_run_hmc_matches_jax(monkeypatch):
    train, test = blobs(seed=0), blobs(n=32, seed=1)
    jmodel, params, model, init = models(train[0])
    kw = dict(n_iterations=3, burn_in=1, step_size=0.02, n_leapfrog=5, step_size_adaptation_speed=0.5,
              seed=SEED)
    want = jax_bnn.run_hmc(jmodel, train, test, **kw)

    def draws(seed, it, device):
        k_mom, k_accept, _ = jax.random.split(step_key(it), 3)
        return {"momentum": sorted_flat_from_jax(model.module, jax_tree.normal_like(k_mom, params)),
                "uniform": torch.tensor(float(jax.random.uniform(k_accept)))}

    monkeypatch.setattr(bnn_hmc, "iteration_noise", draws)
    got = bnn_hmc.run_hmc(model, train, test, init_params=init, device="cpu", **kw)
    assert len(got["metrics"]) == len(want["metrics"]) == 3
    for it, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert g.keys() == w.keys()
        assert g["accepted"] == w["accepted"]
        assert abs(float(draws(SEED, it, None)["uniform"]) - w["accept_prob"]) > 1e-3
        for k in w:
            assert_close(g[k], w[k], rtol=1e-4 if k == "accept_prob" else 1e-5, err_msg=f"iteration {it} {k}")
    assert sum(m["accepted"] for m in want["metrics"][1:]) >= 1
    hold(got["state"].state_dict(), bnn_state_from_jax(model.module, want["state"]), "final state")
    for k, w in want["eval"].items():
        assert_close(got["eval"][k], w, rtol=1e-5, atol=1e-6, err_msg=f"eval {k}")
    assert_close(got["predictive"], want["predictive"], rtol=1e-5, atol=1e-6, err_msg="predictive")


def test_run_sgmcmc_matches_jax(monkeypatch):
    train = blobs(seed=2)
    jmodel, params, model, init = models(train[0])
    kw = dict(n_epochs=2, batch_size=16, step_size=1e-4, momentum_decay=0.9, preconditioner="rmsprop",
              sample_interval=3, seed=SEED)
    _, jstate = jax_bnn.run_sgmcmc(jmodel, train, **kw)

    def draws(seed, step, device):
        _, k_noise = jax.random.split(step_key(step))
        return {"noise": sorted_flat_from_jax(model.module, jax_tree.normal_like(k_noise, params))}

    monkeypatch.setattr(bnn_hmc, "iteration_noise", draws)
    _, state = bnn_hmc.run_sgmcmc(model, train, init_params=init, device="cpu", **kw)
    assert state.step == int(jstate.step) == 8 and int(state.n_samples) == 2
    hold(state.state_dict(), bnn_state_from_jax(model.module, jstate), "sgmcmc state")


def test_run_vi_matches_jax(monkeypatch):
    train = blobs(seed=3)
    jmodel, params, model, init = models(train[0])
    kw = dict(n_epochs=2, batch_size=16, lr=1e-2, mc_samples=2, sigma_init=0.05, seed=SEED)
    _, jstate = jax_bnn.run_vi(jmodel, train, **kw)

    def draws(seed, step, device):
        keys = jax.random.split(step_key(step), 2)
        return {"eps": [sorted_flat_from_jax(model.module, jax_tree.normal_like(k, params)) for k in keys]}

    monkeypatch.setattr(bnn_hmc, "iteration_noise", draws)
    _, state = bnn_hmc.run_vi(model, train, init_params=init, device="cpu", **kw)
    hold(state.state_dict(), bnn_state_from_jax(model.module, jstate, lr=1e-2), "mfvi state")


def test_run_sgd_matches_jax():
    train = blobs(seed=4)
    jmodel, params, model, init = models(train[0])
    kw = dict(n_epochs=3, batch_size=16, lr=0.05, seed=SEED)
    _, jstate = jax_bnn.run_sgd(jmodel, train, **kw)
    _, state = bnn_hmc.run_sgd(model, train, init_params=init, device="cpu", **kw)
    want = state_from_jax(model.module, jstate, lr=0.05)
    got = state.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w.dtype == torch.int64:
            assert torch.equal(got[k], w), k
        else:
            close(got[k].detach().numpy(), w.numpy(), f"sgd state {k}")


def _equal_states(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


class _Crash:
    """A log whose line starting with ``at`` raises: the run stops there,
    after that iteration's (epoch's) steps and before its checkpoint."""

    def __init__(self, at: str):
        self.at = at

    def info(self, msg):
        if msg.startswith(self.at):
            raise RuntimeError("stopped")


def test_resumed_hmc_and_sgd_equal_uninterrupted(tmp_path):
    train, test = blobs(seed=0), blobs(n=32, seed=1)
    model = Model(MLP(4, (16,), 3, generator=torch.Generator().manual_seed(3)))
    kw = dict(n_iterations=3, burn_in=1, step_size=0.02, n_leapfrog=4, seed=5, device="cpu")
    whole = bnn_hmc.run_hmc(model, train, test, run_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="stopped"):
        bnn_hmc.run_hmc(model, train, test, run_dir=str(tmp_path / "b"), log=_Crash("iter 2"), **kw)
    assert sorted(os.listdir(tmp_path / "b")) == ["checkpoint_0", "checkpoint_1"]
    resumed = bnn_hmc.run_hmc(model, train, test, run_dir=str(tmp_path / "b"), **kw)
    assert len(resumed["metrics"]) == 1 and resumed["metrics"][0] == whole["metrics"][2]
    _equal_states(resumed["state"].state_dict(), whole["state"].state_dict())

    kw = dict(n_epochs=4, batch_size=16, lr=0.05, seed=5, device="cpu")
    _, whole = bnn_hmc.run_sgd(model, train, run_dir=str(tmp_path / "c"), **kw)
    with pytest.raises(RuntimeError, match="stopped"):
        bnn_hmc.run_sgd(model, train, run_dir=str(tmp_path / "d"), log=_Crash("epoch 2"), **kw)
    _, resumed = bnn_hmc.run_sgd(model, train, run_dir=str(tmp_path / "d"), **kw)
    assert resumed.step == whole.step == 16
    _equal_states(resumed.state_dict(), whole.state_dict())


def test_one_device_only():
    train = blobs(seed=0)
    model = Model(MLP(4, (16,), 3, generator=torch.Generator().manual_seed(3)))
    # without a process group the entries run on one device; a mesh or a ring
    # sharding that is not the port's raises (the mesh paths:
    # tests/test_torch_mesh*.py)
    with pytest.raises(TypeError, match="mesh"):
        bnn_hmc.run_hmc(model, train, train, n_iterations=1, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="ring_sharding"):
        bnn_hmc.run_sgmcmc(model, train, n_epochs=1, ring_sharding="data", device="cpu")
