"""PyTorch port, SG-MCMC (``methods/sgmcmc.py``) and MFVI
(``methods/vi.py``), held against the JAX package's with JAX's draws given
(recomputed here from its keys):

* ``sgld`` x 5 on a tree of random gradients, for the identity and RMS
  preconditioners, momentum 0 and 0.9, temperature 1 and 0.3, a constant
  step and a ``cyclical_cosine`` schedule, JAX's noise given: the updates,
  the momentum and the preconditioner state within rtol 1e-5, atol 1e-7
  (elementwise fp32: only the square roots' last bits differ);
* ``sgmcmc_method`` on a 2-layer MLP over blobs, 8 minibatch updates at
  ``sample_interval`` 2 and ``burn_in_steps`` 3, SGHMC with the RMS
  preconditioner (JAX's jitted): the whole state (parameters, SGLD
  momentum, preconditioner, count, the ring and ``n_samples``) within rtol
  1e-5 and 2e-5 of each vector's largest magnitude, counts exactly, each
  update's loss and potential within rtol 1e-5; ``sample(index)`` likewise;
* ``mfvi_method.update`` x 3 at ``mc_samples`` 1 and 2 under Adam (JAX's
  optax ``adam``), JAX's eps given: means, rhos and Adam's moments and count
  (``bnn_state_from_jax``) within the same bounds, ``loss``,
  ``data_loss`` and ``kl`` within rtol 1e-5; ``_gauss_kl_iso`` within rtol
  1e-6 and ``sample`` with JAX's eps within rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_bnn_parity import N, blobs, close, setup
from _torch_parity import assert_close
from beyond_deep_ensembles_tpu import tree as jax_tree
from beyond_deep_ensembles_tpu.experiments.bnn_hmc import xent_loss_fn as jax_xent
from beyond_deep_ensembles_tpu.methods import sgmcmc as jax_sgmcmc
from beyond_deep_ensembles_tpu.methods import vi as jax_vi
from beyond_deep_ensembles_tpu.utils.schedules import cyclical_cosine as jax_cyclical
from beyond_deep_ensembles_tpu_torch import tree
from beyond_deep_ensembles_tpu_torch.experiments.bnn_hmc import xent_loss_fn
from beyond_deep_ensembles_tpu_torch.methods import sgmcmc, vi
from beyond_deep_ensembles_tpu_torch.models.jax_convert import bnn_state_from_jax, sorted_flat_from_jax
from beyond_deep_ensembles_tpu_torch.utils.optim import Adam
from beyond_deep_ensembles_tpu_torch.utils.schedules import cyclical_cosine

SHAPES = {"a": {"kernel": (5, 3), "bias": (3,)}, "b": {"w": (7,)}}


def _jax_tree(rng, scale=1.0):
    return {m: {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in SHAPES.items()}


def _dotted(nested) -> dict:
    return {f"{m}.{k}": torch.from_numpy(np.array(v)) for m, leaves in nested.items() for k, v in leaves.items()}


def _hold_tree(got, want, what):
    want = _dotted(jax.tree.map(np.asarray, want))
    for name, w in want.items():
        assert_close(got[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{what} {name}")


SGLD_CASES = [
    ("identity", 0.0, 1.0, False),
    ("identity", 0.9, 0.3, True),
    ("rmsprop", 0.0, 0.3, False),
    ("rmsprop", 0.9, 1.0, True),
]


@pytest.mark.parametrize("pc,momentum_decay,temperature,scheduled", SGLD_CASES)
def test_sgld_matches_jax(pc, momentum_decay, temperature, scheduled):
    lr = (jax_cyclical(1e-2, 3, 1), cyclical_cosine(1e-2, 3, 1)) if scheduled else (1e-2, 1e-2)
    jtx = jax_sgmcmc.sgld(lr[0], momentum_decay, temperature,
                          jax_sgmcmc.RMSPreconditioner() if pc == "rmsprop" else None)
    tx = sgmcmc.sgld(lr[1], momentum_decay, temperature, sgmcmc.RMSPreconditioner() if pc == "rmsprop" else None)
    rng = np.random.RandomState(0)
    params = _jax_tree(rng)
    jstate, state = jtx.init(params), tx.init(_dotted(params))
    for i in range(5):
        grads = _jax_tree(rng, scale=3.0)
        key = jax.random.key(10 + i)
        noise = _dotted(jax.tree.map(np.asarray, jax_tree.normal_like(key, grads)))
        jupdates, jstate = jtx.update(grads, jstate, key=key)
        updates, state = tx.update(_dotted(grads), state, noise=noise)
        _hold_tree(updates, jupdates, f"step {i} updates")
        _hold_tree(state.momentum, jstate.momentum, f"step {i} momentum")
        if pc == "rmsprop":
            _hold_tree(state.precond_state, jstate.precond_state, f"step {i} preconditioner")
        assert int(state.count) == int(jstate.count) == i + 1


def _minibatches(n_batches, batch=8, seed=3):
    x, y = blobs(seed=0)
    order = np.random.RandomState(seed).permutation(N)
    return [(x[order[i * batch:(i + 1) * batch]], y[order[i * batch:(i + 1) * batch]]) for i in range(n_batches)]


def _hold_state(state, jstate, module, what, lr=0.0):
    want = bnn_state_from_jax(module, jstate, lr)
    got = state.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].detach()
        if w.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(g, w), (what, k, g, w)
        else:
            close(g.numpy(), w.numpy(), f"{what} {k}")


def test_sgmcmc_ring_matches_jax():
    jmodel, params, _, module, model, _ = setup()
    kw = dict(dataset_size=N, step_size_fn=1e-4, momentum_decay=0.9, temperature=1.0, preconditioner="rmsprop",
              sample_interval=2, max_samples=3, burn_in_steps=3)
    jmethod = jax_sgmcmc.sgmcmc_method(jax_xent(jmodel), **kw)
    method = sgmcmc.sgmcmc_method(xent_loss_fn(model), **kw)
    jstate = jmethod.init(jax.random.key(1), params, {})
    state = method.init(module, {})
    update = jax.jit(jmethod.update)
    for i, (x, y) in enumerate(_minibatches(8)):
        key = jax.random.fold_in(jax.random.key(2), i + 1)
        _, k_noise = jax.random.split(key)
        noise = {"noise": sorted_flat_from_jax(module, jax_tree.normal_like(k_noise, jstate.params))}
        jstate, jmetrics = update(jstate, key, (jnp.asarray(x), jnp.asarray(y)))
        state, metrics = method.update(state, noise, (torch.from_numpy(x), torch.from_numpy(y)))
        for k, w in jmetrics.items():
            assert_close(float(metrics[k]), float(w), rtol=1e-5, err_msg=f"update {i} {k}")
        _hold_state(state, jstate, module, f"update {i}")
    # draws at steps 4, 6, 8 (past burn-in 3, every 2nd step)
    assert int(state.n_samples) == int(jstate.n_samples) == 3
    for index in range(4):
        want, _ = jmethod.sample(jstate, None, index)
        got, _ = method.sample(state, None, index)
        close(tree.ravel(got).numpy(), sorted_flat_from_jax(module, want).numpy(), f"sample {index}")


@pytest.mark.parametrize("mc_samples", [1, 2])
def test_mfvi_matches_jax(mc_samples):
    jmodel, params, _, module, model, _ = setup()
    lr = 1e-2
    kw = dict(dataset_size=N, prior_std=0.5, sigma_init=0.05, mc_samples=mc_samples, temperature=0.7)
    jmethod = jax_vi.mfvi_method(jax_xent(jmodel), optax.adam(lr), **kw)
    method = vi.mfvi_method(xent_loss_fn(model), lambda ps: (Adam(ps, lr), None), **kw)
    jstate = jmethod.init(jax.random.key(1), params, {})
    state = method.init(module, {})
    _hold_state(state, jstate, module, "init", lr)
    update = jax.jit(jmethod.update)
    for i, (x, y) in enumerate(_minibatches(3, seed=5)):
        key = jax.random.fold_in(jax.random.key(2), i + 1)
        eps = [sorted_flat_from_jax(module, jax_tree.normal_like(k, jstate.mean))
               for k in jax.random.split(key, mc_samples)]
        jstate, jmetrics = update(jstate, key, (jnp.asarray(x), jnp.asarray(y)))
        state, metrics = method.update(state, {"eps": eps}, (torch.from_numpy(x), torch.from_numpy(y)))
        for k, w in jmetrics.items():
            assert_close(float(metrics[k]), float(w), rtol=1e-5, err_msg=f"update {i} {k}")
        _hold_state(state, jstate, module, f"update {i}", lr)

    want = jax_vi._gauss_kl_iso(jstate.mean, jstate.rho, 0.5)
    assert_close(float(vi._gauss_kl_iso(state.mean, state.rho, 0.5).detach()), float(want), rtol=1e-6, err_msg="kl")
    key = jax.random.key(42)
    want, _ = jmethod.sample(jstate, key)
    got, _ = method.sample(state, {"eps": sorted_flat_from_jax(module, jax_tree.normal_like(key, jstate.mean))})
    assert_close(tree.ravel(got).numpy(), sorted_flat_from_jax(module, want).numpy(), rtol=1e-6, atol=1e-7,
                 err_msg="sample")
    # from a generator: the port's own draws, one per MC sample
    drawn, _ = method.sample(state, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in drawn.items()} == {k: v.shape for k, v in state.mean.items()}
