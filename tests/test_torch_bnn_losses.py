"""PyTorch port, the bnn-hmc potentials and utilities, held against the JAX
package on the same numpy inputs:

* ``evals/losses.py``: ``tempered_softmax_xent`` (T = 1 and 3),
  ``gaussian_log_prior``, ``gaussian_log_prior_diff`` and
  ``heteroscedastic_gaussian_ll``: rtol 1e-6 (fp32 sums of up to a few
  hundred terms);
* the ``tree.py`` helpers over a tree and over a flat tensor:
  ``tree_size`` exactly, ``tree_add`` / ``tree_sub`` / ``tree_scale`` /
  ``tree_zeros_like`` / ``tree_unstack`` exactly (elementwise), ``tree_dot`` /
  ``tree_sq_norm`` rtol 1e-6; ``sorted_named`` gives ``jax.tree.leaves``'
  order (``conv_10`` before ``conv_2``); ``normal_like`` the shapes and
  dtypes (its draws are the port's own);
* the schedules ``step_schedule``, ``epoch_schedule_to_step``,
  ``cyclical_cosine``, ``constant_with_cosine_burnin`` and optax's
  ``cosine_decay_schedule`` against the port's: within 2 ulp of the
  schedule's largest value (fp32 in JAX's order of operations; the cosine
  is each library's own, and ``1 + cos`` near its zero turns its last-bit
  difference into several ulp of a small rate), on a tensor of counts and
  on host integers;
* ``utils/profiling.py``: ``StepTimer`` and ``time_fn`` on a patched clock
  equal to JAX's; ``trace`` writes a Chrome trace.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu import tree as jax_tree
from beyond_deep_ensembles_tpu.evals import losses as jax_losses
from beyond_deep_ensembles_tpu.utils import profiling as jax_profiling
from beyond_deep_ensembles_tpu.utils import schedules as jax_schedules
from beyond_deep_ensembles_tpu_torch import tree
from beyond_deep_ensembles_tpu_torch.evals import losses
from beyond_deep_ensembles_tpu_torch.utils import profiling, schedules

RNG = np.random.RandomState(0)
SHAPES = {"conv_2": {"bias": (4,), "kernel": (3, 3, 2, 4)}, "conv_10": {"bias": (5,), "kernel": (7, 5)},
          "Dense_0": {"bias": (3,), "kernel": (5, 3)}}


def _trees(seed=0):
    """A nested JAX tree and the port's dotted mapping of the same arrays."""
    rng = np.random.RandomState(seed)
    nested = {m: {k: rng.standard_normal(s).astype(np.float32) for k, s in leaves.items()}
              for m, leaves in SHAPES.items()}
    dotted = {f"{m}.{k}": torch.from_numpy(v) for m, leaves in nested.items() for k, v in leaves.items()}
    return nested, dotted


def _leaves_in_jax_order(nested):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(nested)]


def test_losses_match_jax():
    logits = RNG.standard_normal((40, 7)).astype(np.float32) * 3
    labels = RNG.randint(0, 7, 40)
    for temperature in (1.0, 3.0):
        want = jax_losses.tempered_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), temperature)
        got = losses.tempered_softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), temperature)
        assert_close(float(got), float(want), rtol=1e-6, err_msg=f"tempered xent T={temperature}")

    nested, dotted = _trees(1)
    nested2, dotted2 = _trees(2)
    for prior_std in (1.0, 0.3):
        assert_close(float(losses.gaussian_log_prior(dotted, prior_std)),
                     float(jax_losses.gaussian_log_prior(nested, prior_std)), rtol=1e-6, err_msg="log prior")
        assert_close(float(losses.gaussian_log_prior_diff(dotted, dotted2, prior_std)),
                     float(jax_losses.gaussian_log_prior_diff(nested, nested2, prior_std)), rtol=1e-6,
                     err_msg="log prior diff")
    flat = torch.cat([v.reshape(-1) for v in dotted.values()])
    assert_close(float(losses.gaussian_log_prior(flat)), float(jax_losses.gaussian_log_prior(nested)), rtol=1e-6,
                 err_msg="log prior of a flat vector")

    outputs = RNG.standard_normal((30, 2)).astype(np.float32)
    targets = RNG.standard_normal(30).astype(np.float32)
    want = jax_losses.heteroscedastic_gaussian_ll(jnp.asarray(outputs), jnp.asarray(targets))
    got = losses.heteroscedastic_gaussian_ll(torch.from_numpy(outputs), torch.from_numpy(targets))
    assert_close(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6, err_msg="heteroscedastic ll")


def test_tree_helpers_match_jax():
    a_nested, a = _trees(3)
    b_nested, b = _trees(4)
    # sorted_named is jax.tree.leaves' order
    order = list(tree.sorted_named(a))
    assert order == ["Dense_0.bias", "Dense_0.kernel", "conv_10.bias", "conv_10.kernel", "conv_2.bias",
                     "conv_2.kernel"]
    for got, want in zip(tree.sorted_named(a).values(), _leaves_in_jax_order(a_nested)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert tree.tree_size(a) == jax_tree.tree_size(a_nested) == 4 + 72 + 5 + 35 + 3 + 15

    def same(port_tree, jax_nested, what):
        got = [v.numpy() for v in tree.sorted_named(port_tree).values()]
        for g, w in zip(got, _leaves_in_jax_order(jax_nested)):
            np.testing.assert_array_equal(g, w, err_msg=what)

    scale = np.float32(0.37)
    same(tree.tree_add(a, b, scale=float(scale)), jax_tree.tree_add(a_nested, b_nested, scale=scale), "tree_add")
    same(tree.tree_sub(a, b), jax_tree.tree_sub(a_nested, b_nested), "tree_sub")
    same(tree.tree_scale(a, float(scale)), jax_tree.tree_scale(a_nested, scale), "tree_scale")
    same(tree.tree_zeros_like(a), jax_tree.tree_zeros_like(a_nested), "tree_zeros_like")
    assert_close(float(tree.tree_dot(a, b)), float(jax_tree.tree_dot(a_nested, b_nested)), rtol=1e-6,
                 err_msg="tree_dot")
    assert_close(float(tree.tree_sq_norm(a)), float(jax_tree.tree_sq_norm(a_nested)), rtol=1e-6,
                 err_msg="tree_sq_norm")

    # a flat tensor is a tree of one leaf
    fa = tree.ravel(tree.sorted_named(a))
    fb = tree.ravel(tree.sorted_named(b))
    assert tree.tree_size(fa) == tree.tree_size(a)
    np.testing.assert_array_equal(tree.tree_add(fa, fb, 0.5).numpy(), (fa + 0.5 * fb).numpy())
    assert_close(float(tree.tree_sq_norm(fa)), float(jax_tree.tree_sq_norm(a_nested)), rtol=1e-6,
                 err_msg="tree_sq_norm, flat")

    stacked_nested = jax_tree.tree_stack([a_nested, b_nested])
    stacked = tree.tree_stack([a, b])
    for got, want in zip(tree.tree_unstack(stacked, 2), jax_tree.tree_unstack(stacked_nested, 2)):
        same(got, want, "tree_unstack")

    draw = tree.normal_like(torch.Generator().manual_seed(0), a)
    assert {k: (v.shape, v.dtype) for k, v in draw.items()} == {k: (v.shape, v.dtype) for k, v in a.items()}


def _ulp_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert_close(got, want, rtol=0, atol=float(2 * ulp.max()), err_msg=what)


SCHEDULES = [
    ("cyclical_cosine", lambda m: m.cyclical_cosine(0.1, 7, 3)),
    ("constant_with_cosine_burnin", lambda m: m.constant_with_cosine_burnin(0.3, 0.01, 11)),
    ("epoch_schedule_to_step", lambda m: m.epoch_schedule_to_step(m.wilson_schedule(6, 0.05, 0.0005), 4, 0.05)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_step_schedules_match_jax(name, make):
    steps = np.arange(0, 30)
    want = np.asarray(jax.jit(make(jax_schedules))(jnp.asarray(steps, jnp.int32)))
    port = make(schedules)
    got = port(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    _ulp_close(got.numpy(), want, name)
    _ulp_close([port(int(s)) for s in steps[:8]], want[:8], name + " (host ints)")


def test_step_schedule_and_cosine_decay_match_jax():
    factor = jax_schedules.step_schedule([3, 5, 9], 0.2)
    port = schedules.step_schedule([3, 5, 9], 0.2)
    want = [float(factor(jnp.int32(e))) for e in range(12)]
    _ulp_close(port(torch.arange(12)).numpy(), want, "step_schedule")
    _ulp_close([port(e) for e in range(12)], want, "step_schedule (host ints)")

    want = np.asarray([optax.cosine_decay_schedule(0.05, 17)(jnp.int32(c)) for c in range(20)])
    port = schedules.cosine_decay_schedule(0.05, 17)
    _ulp_close(port(torch.arange(20)).numpy(), want, "cosine_decay_schedule")
    _ulp_close([port(c) for c in range(20)], want, "cosine_decay_schedule (host ints)")
    with pytest.raises(ValueError, match="positive decay_steps"):
        schedules.cosine_decay_schedule(0.1, 0)


class _Clock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def test_profiling_matches_jax(monkeypatch, tmp_path):
    times = [0.0, 0.5, 0.7, 1.6, 1.65, 3.0]
    monkeypatch.setattr(jax_profiling.time, "perf_counter", _Clock(times))
    want_timer = jax_profiling.StepTimer(alpha=0.2)
    want = [want_timer.tick() for _ in times]
    monkeypatch.setattr(time, "perf_counter", _Clock(times))
    timer = profiling.StepTimer(alpha=0.2)
    got = [timer.tick() for _ in times]
    assert got[0] is None and want[0] is None
    assert_close(got[1:], want[1:], rtol=0, err_msg="StepTimer ema")

    monkeypatch.setattr(jax_profiling.time, "perf_counter", _Clock([1.0, 3.5]))
    want_res, want_dt = jax_profiling.time_fn(lambda v: jnp.asarray(v) * 2)(3.0)
    monkeypatch.setattr(time, "perf_counter", _Clock([1.0, 3.5]))
    got_res, got_dt = profiling.time_fn(lambda v: torch.tensor(v) * 2)(3.0)
    assert got_dt == want_dt == 2.5 and float(got_res) == float(want_res) == 6.0
    monkeypatch.undo()

    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
