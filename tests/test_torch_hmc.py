"""PyTorch port, full-batch HMC (``methods/hmc.py``), held against the JAX
package's ``methods/hmc.py`` on a 2-layer MLP (the zoo's ``MLP``, 4 -> 16 ->
3) over 64 blobs, from JAX's initial weights, with JAX's momentum and accept
uniforms given (recomputed here from its keys: ``split(key, 3)``,
``normal_like`` and ``uniform``):

* ``leapfrog`` over 5 steps: parameters, momentum and gradient within rtol
  1e-5 and 2e-5 of each vector's largest magnitude (fp32 gradients of N x
  the loss; the trajectory amplifies a rounding step by step), the
  log-likelihood within rtol 1e-6;
* ``hmc_method.update`` (JAX's jitted, the step size adapting): the whole
  state as the port keeps it (``models/jax_convert.py::bnn_state_from_jax``
  of JAX's: parameters, gradient, step size, log-likelihood, accept
  probability, ``accepted``, the ring and ``n_samples``) after every
  update within the same bounds, the flags and counts exactly; each
  update's metrics within rtol 1e-5, but the accept probability within
  rtol 1e-4: it is exp of an energy difference of sums near 1e2, each known
  to fp32's 1e-5 there; ``sample(index)`` for indices 0-4 as the state.
  Each accept decision compared is at least 1e-3 away from the threshold
  (asserted), so the two frameworks' roundings cannot flip it;
* a NaN energy (NaN data) is rejected by both, ``do_mh_correction=False``
  takes every proposal, and a JAX state converted after 2 updates
  continues as JAX's does for a third.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_bnn_parity import N, PRIOR_STD, close, setup
from _torch_parity import assert_close
from beyond_deep_ensembles_tpu import tree as jax_tree
from beyond_deep_ensembles_tpu.experiments.bnn_hmc import xent_loss_fn as jax_xent
from beyond_deep_ensembles_tpu.methods.hmc import hmc_method as jax_hmc_method
from beyond_deep_ensembles_tpu.methods.hmc import leapfrog as jax_leapfrog
from beyond_deep_ensembles_tpu_torch import tree
from beyond_deep_ensembles_tpu_torch.experiments.bnn_hmc import xent_loss_fn
from beyond_deep_ensembles_tpu_torch.methods import hmc
from beyond_deep_ensembles_tpu_torch.models.jax_convert import bnn_state_from_jax, sorted_flat_from_jax
from beyond_deep_ensembles_tpu_torch.models.zoo import MLP
from beyond_deep_ensembles_tpu_torch.nn.base import Model

MARGIN = 1e-3


def jax_draws(key, params, module):
    """JAX's momentum and accept uniform for one update's key, in the
    port's flat order."""
    k_mom, k_accept, _ = jax.random.split(key, 3)
    momentum = jax_tree.normal_like(k_mom, params)
    uniform = jax.random.uniform(k_accept)
    return {"momentum": sorted_flat_from_jax(module, momentum), "uniform": torch.tensor(float(uniform))}


def update_key(i):
    return jax.random.fold_in(jax.random.key(2), i)


def hold_state(state, jstate, module, what, skip=()):
    want = bnn_state_from_jax(module, jstate)
    got = state.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].detach()
        if k in skip:
            continue
        if w.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(g, w), (what, k, g, w)
        elif k == "hmc.accept_prob":
            assert_close(float(g), float(w), rtol=1e-4, err_msg=f"{what} {k}")
        else:
            close(g.numpy(), w.numpy(), f"{what} {k}")


def test_leapfrog_matches_jax():
    jmodel, params, jbatch, module, model, batch = setup()
    jloss = jax_xent(jmodel)

    def neg_u(p):
        loglik = -N * jloss(p, {}, None, jbatch).loss
        return loglik - jax_tree.tree_sq_norm(p) / (2 * PRIOR_STD**2), (loglik, None)

    grad_fn = jax.jit(jax.value_and_grad(neg_u, has_aux=True))
    (_, (loglik0, _)), grad0 = grad_fn(params)
    momentum = jax_tree.normal_like(jax.random.key(5), params)
    step = jnp.float32(2e-3)
    want = jax_leapfrog(grad_fn, params, momentum, grad0, loglik0, step, 5)

    port_fn = hmc.make_grad_fn(xent_loss_fn(model), N, PRIOR_STD, module, {}, batch)
    flat0 = tree.ravel(tree.sorted_named(module))
    loglik, grad = port_fn(flat0)
    assert_close(float(loglik), float(loglik0), rtol=1e-6, err_msg="loglik at start")
    close(grad.numpy(), sorted_flat_from_jax(module, grad0).numpy(), "grad at start")
    got = hmc.leapfrog(port_fn, flat0, sorted_flat_from_jax(module, momentum), grad, loglik,
                       torch.tensor(2e-3, dtype=torch.float32), 5)
    for name, g, w in zip(("params", "momentum", "grad"), got[:3], want[:3]):
        close(g.numpy(), sorted_flat_from_jax(module, w).numpy(), f"leapfrog {name}")
    assert_close(float(got[3]), float(want[3]), rtol=1e-6, err_msg="leapfrog loglik")


def run_both(kw, updates=3, nan_data=False, seed=0):
    jmodel, params, jbatch, module, model, batch = setup(seed)
    if nan_data:
        jbatch = (jbatch[0].at[0, 0].set(jnp.nan), jbatch[1])
        batch = (batch[0].clone(), batch[1])
        batch[0][0, 0] = float("nan")
    jmethod = jax_hmc_method(jax_xent(jmodel), dataset_size=N, prior_std=PRIOR_STD, max_samples=4, **kw)
    method = hmc.hmc_method(xent_loss_fn(model), dataset_size=N, prior_std=PRIOR_STD, max_samples=4, **kw)
    jstate = jmethod.init(jax.random.key(1), params, {})
    state = method.init(module, {})
    update = jax.jit(jmethod.update)
    for i in range(updates):
        draws = jax_draws(update_key(i), jstate.params, module)
        jstate, jmetrics = update(jstate, update_key(i), jbatch)
        state, metrics = method.update(state, draws, batch)
        if not nan_data and kw.get("do_mh_correction", True):
            assert abs(float(draws["uniform"]) - float(jmetrics["accept_prob"])) > MARGIN, i
        for k, w in jmetrics.items():
            assert_close(float(metrics[k]), float(w), rtol=1e-4 if k == "accept_prob" else 1e-5,
                         err_msg=f"update {i} {k}")
        # at a NaN point the frameworks' gradients differ in where NaN reaches
        hold_state(state, jstate, module, f"update {i}", skip=("hmc.grad",) if nan_data else ())
    return jmethod, jstate, method, state, module, jbatch, batch


def test_hmc_updates_and_samples_match_jax():
    jmethod, jstate, method, state, module, _, _ = run_both(
        {"step_size": 0.02, "n_leapfrog": 5, "step_size_adaptation_speed": 0.5, "target_accept_rate": 0.8})
    accepted = [float(jstate.accepted)]
    assert int(state.n_samples) == int(jstate.n_samples) >= 1
    for index in range(5):
        want, _ = jmethod.sample(jstate, None, index)
        got, _ = method.sample(state, None, index)
        close(tree.ravel(got).numpy(), sorted_flat_from_jax(module, want).numpy(), f"sample {index}")
    assert accepted


def test_hmc_rejects_and_accepts_both_ways():
    """At a larger step the chain rejects its first proposal (accept
    probability 0.29 against a uniform of 0.86) and accepts the next three
    (held against JAX at every update)."""
    _, jstate, _, state, _, _, _ = run_both({"step_size": 0.04, "n_leapfrog": 5}, updates=4)
    assert int(state.n_samples) == int(jstate.n_samples) == 3 and state.step == 4


def test_nan_energy_is_rejected():
    _, jstate, _, state, _, _, _ = run_both({"step_size": 0.02, "n_leapfrog": 3}, updates=2, nan_data=True)
    assert not bool(state.accepted) and not bool(jstate.accepted)
    assert float(state.accept_prob) == 0.0 and int(state.n_samples) == 0


def test_no_mh_correction_takes_every_proposal():
    _, jstate, _, state, _, _, _ = run_both({"step_size": 0.09, "n_leapfrog": 3, "do_mh_correction": False})
    assert bool(state.accepted) and int(state.n_samples) == 3


def test_state_converted_mid_chain_continues_as_jax():
    kw = {"step_size": 0.02, "n_leapfrog": 5, "step_size_adaptation_speed": 0.3}
    jmethod, jstate, method, _, module, jbatch, batch = run_both(kw, updates=2)
    # a fresh port state, loaded from JAX's after two updates
    fresh = MLP(4, (16,), 3, generator=torch.Generator().manual_seed(9))
    state = hmc.hmc_method(xent_loss_fn(Model(fresh)), dataset_size=N, prior_std=PRIOR_STD, max_samples=4,
                           **kw).init(fresh, {})
    state.load_state_dict(bnn_state_from_jax(fresh, jstate))
    method = hmc.hmc_method(xent_loss_fn(Model(fresh)), dataset_size=N, prior_std=PRIOR_STD, max_samples=4, **kw)
    draws = jax_draws(update_key(2), jstate.params, fresh)
    jstate, _ = jax.jit(jmethod.update)(jstate, update_key(2), jbatch)
    state, _ = method.update(state, draws, batch)
    assert state.step == int(jstate.step) == 3
    hold_state(state, jstate, fresh, "converted, update 2")


def test_hmc_refuses_ring_sharding():
    # a sharding that is not a rings.RingSharding (the mesh path: tests/test_torch_mesh_methods.py)
    with pytest.raises(TypeError, match="ring_sharding"):
        hmc.hmc_method(lambda *a: None, dataset_size=N, ring_sharding="data")
