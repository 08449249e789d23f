"""Rows at a bf16 compute dtype through the JAX package's and the port's
engines (tests/test_torch_bf16_rows*.py): ``build`` -> three updates ->
``eval_task`` (WILDS) or ``eval_model`` (CIFAR) with ``compute_dtype: bf16``
(``bf16: true``), from JAX's initial state and with JAX's draws given, as
tests/_torch_wilds_parity.py's ``run_both`` does at fp32.

bf16 rounds at other places in the two frameworks, so the states are not
held to each other but to an exact-enough update of the same start on the
same draws: the port's fp32 update (which tests/test_torch_wilds_*.py hold
to JAX's fp32 update within 2e-6), or, for poverty, whose fp32 update is
already ill-conditioned (GaussLayer's std 0.1, Adam at lr 1e-3), the
port's float64 update. :func:`hold_leaves`: the port's L2 gap to that
reference over all parameters within twice JAX's; and for each state leaf
(a tensor, or one parameter's segment of a flat vector) within twice JAX's
plus a floor: 2^-6 of the leaf's change over the three updates, and, for a
parameter, one element's step of 2 lr taken the other way at each update.
The floor is what a leaf's gap is made of where the per-leaf ratio is
chance: Adam steps an element by lr times the sign of a gradient that bf16
rounding can flip where the gradient is small, so a leaf of a few hundred
elements differs from the reference by a whole step on whichever elements
flip (seen: 6-10 x JAX's gap on single norm-scale leaves of the ResNet-50
and DistilBERT rows, where the whole state's gap was 0.7-1.0 x JAX's), and
poverty's scalar ``rho__mle`` gradient sums residuals squared over 0.01 in
each engine's own order (its first moment 4.6 x JAX's gap, 1.8 % of its
change). A leaf of a parameter whose gradient is zero in exact arithmetic
(``zero_gradient``) may instead lie within 6 lr of the reference, as at
fp32.

Evaluation then runs from JAX's trained bf16 state on both sides (the port
loads it), with JAX's eval draws: every float metric within 1e-2 relative
of JAX's (:data:`METRIC_TOL`; 1e-3 absolute for a metric near zero). On
poverty the metrics of six test images are themselves ill-conditioned in
bf16 (from one state, JAX's bf16 urban Pearson r lies 0.15 from the
float64 one, the port's 0.25): each is held instead against the port's
float64 evaluation of the same state, no farther from it than twice JAX's
bf16 metric is, plus 1e-2 of it."""
import math

import jax
import numpy as np
import torch

from _torch_parity import assert_close
from _torch_wilds_parity import (RECORDED, _PlainEpilogue, _flat_layouts, _leaf_gaps, _nchw, data, image_task,
                                 jax_config, jax_state_dict, jit_jax_init, load_jax_state, load_state, port_draws,
                                 record_draws, resnet_task, row_config, swish_resnets, zero_gradient)
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

METRIC_TOL = dict(rtol=1e-2, atol=1e-3)
JAX_FACTOR = 2.0
LEAF_FLOOR = 2.0**-6  # of the leaf's change over the updates


def hold_leaves(model, lr, updates, start, reference, port, jax_side, layouts):
    """The port's state no farther from ``reference`` than twice
    ``jax_side`` is: over all parameters together (L2), and leaf by leaf
    with a floor (the module docstring); the worst ratios printed."""
    leaves = _leaf_gaps(start, reference, (port, jax_side), layouts)
    params = [k for k in leaves if k.startswith("params.")]
    whole = [math.sqrt(sum(leaves[k][2][side] for k in params)) for side in (0, 1)]
    assert_close(whole[0], 0.0, atol=JAX_FACTOR * whole[1],
                 err_msg=f"{model} bf16 parameters (L2) against the reference")
    worst, worst_leaf = 0.0, ""
    for leaf, (change, _, gaps, far) in leaves.items():
        if zero_gradient(leaf.split("[")[-1].rstrip("]")) and far[0] <= 6 * lr * (1 + 1e-6):
            continue
        floor = LEAF_FLOOR * math.sqrt(change)
        if leaf.startswith("params."):
            floor += 2 * lr * updates  # one element's step taken the other way at every update
        ratio = math.sqrt(gaps[0]) / max(JAX_FACTOR * math.sqrt(gaps[1]) + floor, 1e-300)
        if ratio >= worst:
            worst, worst_leaf = ratio, leaf
    assert_close(worst, 0.0, atol=1.0,
                 err_msg=f"{model} bf16 state, the worst leaf's gap over its bound: {worst_leaf}")


def hold_metrics(got, want, model, exact=None):
    """Every float metric within :data:`METRIC_TOL` of JAX's; given
    ``exact`` (a regression row's float64 metrics of the same state), each
    no farther from it than twice JAX's metric is, plus 1e-2 of it."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        if not isinstance(w, float):
            assert got[k] == w, (k, got[k], w)
        elif exact is None:
            assert_close(got[k], w, err_msg=f"{model} bf16 {k}", **METRIC_TOL)
        else:
            e = exact[k]
            assert_close(got[k], e, rtol=0, atol=JAX_FACTOR * abs(w - e) + METRIC_TOL["rtol"] * abs(e),
                         err_msg=f"{model} bf16 {k} against float64 (JAX's bf16 {w:.6g})")


def _reference(task, config, state, float64):
    """The port's build of ``config`` without ``compute_dtype`` at fp32, or
    at float64 where ``float64``, holding ``state``."""
    config = {k: v for k, v in config.items() if k != "compute_dtype"}
    if float64:
        torch.set_default_dtype(torch.float64)
    try:
        exact = wilds_task.build(task, config, torch.Generator().manual_seed(0), config["steps_per_epoch"],
                                 device="cpu")
    finally:
        torch.set_default_dtype(torch.float32)
    wide = torch.float64 if float64 else torch.float32
    load_state(exact, {k: t.to(wide) if t.is_floating_point() else t for k, t in state.items()})
    return config, exact


def _reference_update(task, config, start, draws, x, y, monkeypatch, float64):
    """The port's update of ``start`` on ``draws`` at fp32, or at float64
    where ``float64`` (:func:`_reference`)."""
    config, exact = _reference(task, config, start, float64)
    source = (_PlainEpilogue if float64 else NoiseSource)(given=draws)
    with monkeypatch.context() as m:
        m.setattr(wilds_task, "NoiseSource", lambda **kw: source)
        exact = wilds_task.train(exact, config, x.astype(np.float64) if float64 else x, y)
    assert source.draws == len(draws)
    return exact.state.state_dict()


def _float64_metrics(task, config, state, draws, xt, yt, mt, z, monkeypatch):
    """``eval_task`` of ``state`` by the port at float64 on ``draws``."""
    config, exact = _reference(task, config, state, True)
    source = _PlainEpilogue(given=draws)
    with monkeypatch.context() as m:
        m.setattr(wilds_task, "NoiseSource", lambda **kw: source)
        out = wilds_task.eval_task(exact, task, {**config, "device_eval": False}, xt.astype(np.float64), yt, mt,
                                   z=None if z is None else z.double())
    assert source.draws == len(draws)
    return out


def check_wilds_row(task, row, monkeypatch):
    """A WILDS row at ``compute_dtype: bf16`` (the module docstring's holds)."""
    if resnet_task(task) or task == "poverty":
        swish_resnets(monkeypatch)
    if task == "poverty":
        jit_jax_init(monkeypatch)
    x, y, xt, yt, mt = data(task)
    config = row_config(task, {**row, "compute_dtype": "bf16"})
    config["dataset_size"] = x.shape[0]
    config["steps_per_epoch"] = steps = x.shape[0] // config["batch_size"]
    jconfig = jax_config(config)
    jbuilt = jax_wilds.build(task, jconfig, jax.random.key(config["seed"]), steps)
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), steps, device="cpu")
    load_jax_state(built, jbuilt, config)
    start = {k: t.detach().clone() for k, t in built.state.state_dict().items()}

    record_draws(monkeypatch)
    jbuilt = jax_wilds.train(jbuilt, jconfig, x, y)
    jax.effects_barrier()
    train_draws = list(RECORDED)
    trained = jax_state_dict(built, jbuilt, config)
    RECORDED.clear()
    want = jax_wilds.eval_task(jbuilt, task, jconfig, xt, yt, mt)
    jax.effects_barrier()
    eval_draws = list(RECORDED)
    z = None
    if jbuilt.regression:
        _, quantile = eval_draws.pop()
        z = torch.from_numpy(np.array(quantile))

    n_batches = -(-xt.shape[0] // config["eval_batch_size"])
    draws = port_draws(config, jbuilt, built, train_draws, eval_draws, steps, n_batches)
    draws = _nchw(draws) if image_task(task) else draws
    n_train = len(train_draws)  # MAP, MCD and BBB draw one tensor per record
    given = NoiseSource(given=draws)
    monkeypatch.setattr(wilds_task, "NoiseSource", lambda **kw: given)
    x, xt = wilds_task.task_images(task, config, x), wilds_task.task_images(task, config, xt)
    built = wilds_task.train(built, config, x, y)
    assert given.draws == n_train
    got_state = built.state.state_dict()
    assert any(t.dtype == torch.float32 for t in got_state.values())
    assert all(t.dtype != torch.bfloat16 for t in got_state.values())  # parameters and optimizer stay fp32
    reference = _reference_update(task, config, start, draws[:n_train], x, y, monkeypatch, jbuilt.regression)
    hold_leaves(config["model"], config["lr"], steps, start, reference, got_state, trained, _flat_layouts(built.state))

    load_state(built, trained)
    got = wilds_task.eval_task(built, task, {**config, "device_eval": False}, xt, yt, mt, z=z)
    assert given.draws == len(draws), (given.draws, len(draws))
    exact = None
    if jbuilt.regression:
        exact = _float64_metrics(task, config, trained, draws[n_train:], xt, yt, mt, z, monkeypatch)
    hold_metrics(got, want, config["model"], exact)


# the CIFAR comparison of build -> train -> eval_model at ``bf16: true``: 4
# steps of 16, 24 test images at eval batch 10 (the last batch padded), S = 4,
# no augmentation (tests/_torch_parity.py's PARITY)
CIFAR_BBB_SITES = 22 + 18 * 3  # per forward: 22 BBB layers, 18 variational FRNs of 3 draws


def check_cifar_bbb_row(monkeypatch):
    """configs/cifar.yaml's BBB row with ``bf16: true`` (the module
    docstring's holds; the reference update the port's at fp32). Most of
    its time is XLA's CPU compile of JAX's bf16 BBB ResNet-20 update (two MC
    samples unrolled): 70-80 s alone on an 8-core host."""
    from _torch_parity import PARITY, record_jax_normals

    from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
    from beyond_deep_ensembles_tpu.nn import gaussian as jax_gaussian
    from beyond_deep_ensembles_tpu_torch.experiments import cifar
    from beyond_deep_ensembles_tpu_torch.models.jax_convert import state_from_jax

    jit_jax_init(monkeypatch)
    recorded = record_jax_normals(monkeypatch, jax_gaussian)
    config = {**jax_cifar.DEFAULT_CONFIG, **PARITY, "model": "bbb", "bf16": True}
    config, (x, y), (xt, yt) = cifar._load_data(config)
    steps = x.shape[0] // config["batch_size"]
    jbuilt = jax_cifar.build(config, jax.random.key(config["seed"]), steps)
    built = cifar.build(config, torch.Generator().manual_seed(0), steps, device="cpu")
    load_state(built, state_from_jax(built.state.params, jbuilt.state, config["lr"]))
    start = {k: t.detach().clone() for k, t in built.state.state_dict().items()}

    recorded.clear()
    jbuilt = jax_cifar.train(jbuilt, config, x, y)
    jax.effects_barrier()
    train_draws = [torch.from_numpy(np.array(d)) for d in recorded]
    trained = state_from_jax(built.state.params, jbuilt.state, config["lr"])
    recorded.clear()
    want = jax_cifar.eval_model(jbuilt, config, xt, yt).as_dict()
    jax.effects_barrier()
    s = config["eval_samples"]
    eval_draws = []
    per_batch = CIFAR_BBB_SITES * s
    assert len(recorded) % per_batch == 0, (len(recorded), per_batch)
    for b in range(0, len(recorded), per_batch):  # JAX's vmap: the samples of a site together
        batch = recorded[b : b + per_batch]
        eval_draws += [torch.from_numpy(np.array(batch[site * s + i])) for i in range(s)
                       for site in range(CIFAR_BBB_SITES)]

    draws = [_nchw([d])[0] for d in train_draws + eval_draws]
    given = NoiseSource(given=draws)
    monkeypatch.setattr(cifar, "NoiseSource", lambda **kw: given)
    built = cifar.train(built, config, x, y)
    assert given.draws == len(train_draws)
    got_state = built.state.state_dict()
    assert all(t.dtype != torch.bfloat16 for t in got_state.values())

    fp32 = {k: v for k, v in config.items() if k != "bf16"}
    exact = cifar.build(fp32, torch.Generator().manual_seed(0), steps, device="cpu")
    load_state(exact, start)
    source = NoiseSource(given=draws[: len(train_draws)])
    with monkeypatch.context() as m:
        m.setattr(cifar, "NoiseSource", lambda **kw: source)
        exact = cifar.train(exact, fp32, x, y)
    hold_leaves("bbb", config["lr"], steps, start, exact.state.state_dict(), got_state, trained,
                _flat_layouts(built.state))

    load_state(built, trained)
    got = cifar.eval_model(built, {**config, "device_eval": False}, xt, yt).as_dict()
    assert given.draws == len(draws), (given.draws, len(draws))
    hold_metrics(got, want, "cifar bbb")
