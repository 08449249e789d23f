"""The WILDS text rows through the JAX package's and the port's engines
(``experiments/wilds_task.py``), from one state and with JAX's draws.

:func:`run_both` builds a row on both sides at TINY_CONFIG's width, carries
JAX's initial state across (``models/jax_convert.py``), runs JAX's
``train`` (three updates) and ``eval_task`` (host loop) while every
``jax.random.normal`` and ``jax.random.bernoulli`` the engine makes is
recorded at run time (an ordered ``jax.debug.callback``, in program order,
jit or not), turns the record into the port's given-mode draws, and runs the
port's ``train`` and ``eval_task`` on them.

Where the two programs draw in another order, :func:`port_draws` converts:

  * under ``vmap`` (JAX's members, SVGD particles, eval samples) the draws of
    one site come together, the port runs the mapped axis one after the
    other: each step's or eval batch's draws are reordered from site-major
    to unit-major;
  * a tree of per-leaf normals (iVON's ``normal_like``, in sorted-leaf
    order) is one flat vector in the port's parameter order, a SWAG draw's
    ``z2`` (JAX's flat order) too; a JAX leaf of zero size (a last-layer
    placeholder) has no counterpart.
"""
from pathlib import Path

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from _torch_parity import assert_close

from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.methods import laplace_method as jax_laplace_method
from beyond_deep_ensembles_tpu_torch.data import wilds as wilds_data
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
from beyond_deep_ensembles_tpu_torch.methods.last_layer import LastLayerState
from beyond_deep_ensembles_tpu_torch.models.jax_convert import (
    _port_flat, _unravel_sorted, last_layer_state_from_jax, params_from_jax, state_from_jax, strip_placeholders)
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# a yaml row cut in size only: three updates of batch 4 (one epoch of 12
# reviews), 6 test reviews at eval batch 4 (the last batch padded), S = 2
# (SNGP's row keeps its S = 1), SVGD's particles 3, SWAG collecting from the
# first step; TINY_CONFIG's width with the sequence cut to its first 64
# tokens (which carry the synthetic class signal) on both sides: the
# comparisons are of the engines, not of L
CUT = {"epochs": 1, "batch_size": 4, "eval_batch_size": 4, "eval_samples": 2, "svgd_particles": 3,
       "swag_start_epoch": 0, "swag_updates": 3}
N_TRAIN, N_TEST, SEQ = 12, 6, 64
BERT = {"vocab_size": 1024, "dim": 64, "n_layers": 2, "n_heads": 2, "hidden_dim": 128, "max_position_embeddings": SEQ}
# parameters and every other state tensor after the three updates (the yaml
# rows' lr 1e-5 Adam steps; fp32 gradients summed in other orders)
STATE_ATOL = 2e-6
# SVGD's Stein direction carries a repulsion term of rounding size on the
# parameters no example of a step reaches (most embedding rows), which Adam
# normalizes to steps near lr: held to 2 lr
STATE_ATOL_SVGD = 2e-5
METRIC_TOL = dict(rtol=1e-5, atol=1e-5)


def yaml_row(task: str, name: str) -> dict:
    """DEFAULT's params and row ``name``'s of ``configs/<task>.yaml``."""
    docs = {d["name"]: d.get("params", {}) for d in yaml.safe_load_all((CONFIGS / f"{task}.yaml").read_text()) if d}
    return {**docs["DEFAULT"], **docs[name]}


RECORDED = []


def _recorder(real, kind):
    def draw(*args, **kwargs):
        value = real(*args, **kwargs)
        jax.debug.callback(lambda v: RECORDED.append((kind, np.asarray(v))), value, ordered=True)
        return value

    return draw


def record_draws(monkeypatch) -> list:
    """Records every ``jax.random.normal`` and ``jax.random.bernoulli`` (as
    ``("normal" | "mask", array)``) in :data:`RECORDED`, emptied."""
    RECORDED.clear()
    monkeypatch.setattr(jax.random, "normal", _recorder(jax.random.normal, "normal"))
    monkeypatch.setattr(jax.random, "bernoulli", _recorder(jax.random.bernoulli, "mask"))
    return RECORDED


def data(task):
    x, y, _ = wilds_data.load_wilds(task, "train", subsample=N_TRAIN)
    xt, yt, mt = wilds_data.load_wilds(task, "test", subsample=N_TEST)
    return x[:, :SEQ], y, xt[:, :SEQ], yt, mt


def _units(draws, n_units):
    assert len(draws) % n_units == 0, (len(draws), n_units)
    per = len(draws) // n_units
    return [draws[i * per : (i + 1) * per] for i in range(n_units)]


def _unit_major(unit, mapped):
    """Site-major draws of a ``vmap`` of size ``mapped`` -> one unit after
    the other."""
    assert len(unit) % mapped == 0, (len(unit), mapped)
    sites = len(unit) // mapped
    return [unit[site * mapped + i] for i in range(mapped) for site in range(sites)]


def _flat(module, template, leaves):
    """Per-leaf normals (sorted-leaf order, placeholders included) -> the
    port's flat vector over ``module``."""
    vec = np.concatenate([np.asarray(a).reshape(-1) for a in leaves])
    return _port_flat(module, params_from_jax(_unravel_sorted(template, vec)))


def _runs(draws):
    """Maximal runs of consecutive draws of one kind: [(kind, [arrays])]."""
    out = []
    for kind, a in draws:
        if out and out[-1][0] == kind:
            out[-1][1].append(a)
        else:
            out.append((kind, [a]))
    return out


def _convert(draws, tree_leaves, template, module, swag):
    """One unit's draws in the port's order and layout: a run of
    ``tree_leaves`` normals is one tree (iVON), a SWAG draw's pair
    ``(z1, z2)`` takes ``z2`` to the port's order."""
    out = []
    for kind, arrays in _runs(draws):
        if kind == "normal" and tree_leaves:
            assert len(arrays) % tree_leaves == 0, (len(arrays), tree_leaves)
            for i in range(0, len(arrays), tree_leaves):
                out.append(_flat(module, template, arrays[i : i + tree_leaves]))
        elif kind == "normal" and swag:
            assert len(arrays) % 2 == 0
            for z1, z2 in zip(arrays[::2], arrays[1::2]):
                out += [torch.from_numpy(z1), _port_flat(module, params_from_jax(_unravel_sorted(template, z2)))]
        else:
            out += [torch.from_numpy(np.array(a)) for a in arrays]
    return out


def _head_module(built):
    state = built.state
    return state.inner.params if isinstance(state, LastLayerState) else state.params


def _jax_head_tree(jstate):
    inner = getattr(jstate, "inner", jstate)
    return strip_placeholders(jax.tree.map(np.asarray, inner.params))


def port_draws(config, jbuilt, built, train_draws, eval_draws, steps, eval_batches):
    """The JAX record as the port's given draws, in its call order."""
    model = config["model"]
    mapped = {"svgd": config["svgd_particles"], "ll_svgd": config["svgd_particles"]}.get(model, config["members"])
    inner = getattr(jbuilt.state, "inner", jbuilt.state)
    full_leaves = len(jax.tree.leaves(inner.params))
    template = _jax_head_tree(jbuilt.state)
    module = _head_module(built)
    ivon = model in ("ivon", "ll_ivon")
    swag = model in ("swag", "swag_ll")
    out = []
    for unit in _units(train_draws, steps):
        out += _convert(_unit_major(unit, mapped), full_leaves if ivon else 0, template, module, False)
    for unit in _units(eval_draws, eval_batches):
        out += _convert(_unit_major(unit, config["eval_samples"]), full_leaves if ivon else 0, template, module, swag)
    return out


def jax_state_dict(built, jbuilt, config) -> dict:
    """JAX's state as the port's state_dict (``models/jax_convert.py``)."""
    lr, state, jstate = config["lr"], built.state, jbuilt.state
    if isinstance(state, EnsembleState):
        return {f"members.{m}.{k}": v for m, member in enumerate(state.members)
                for k, v in state_from_jax(member.params, jax.tree.map(lambda l: l[m], jstate), lr).items()}
    if isinstance(state, LastLayerState):
        return last_layer_state_from_jax(state, jstate, lr)
    return state_from_jax(state.params, jstate, lr)


def load_jax_state(built, jbuilt, config):
    """Carries JAX's state into the port's, in place."""
    state = built.state
    state.load_state_dict(jax_state_dict(built, jbuilt, config))
    if hasattr(state, "mean") and hasattr(state, "flat"):  # iVON: the parameters hold the mean
        state.flat.copy_(state.mean)


def _flat_layouts(state, prefix=""):
    """``{key prefix: [(parameter name, size)]}``: the flat order of every
    flat vector a state holds (an optimizer's, SWAG's, iVON's)."""
    if isinstance(state, EnsembleState):
        out = {}
        for m, member in enumerate(state.members):
            out.update(_flat_layouts(member, f"{prefix}members.{m}."))
        return out
    if isinstance(state, LastLayerState):
        out = _flat_layouts(state.inner, prefix + "inner.")
        out[prefix + "backbone_"] = [(n, p.numel()) for n, p in state.backbone.items()]
        return out
    return {prefix: [(n, p.numel()) for n, p in state.params.named_parameters()]}


def _k_lin_elements(layouts, key):
    """A bool vector over the flat tensor ``key`` (or None): True on the
    ``k_lin`` biases' elements."""
    for prefix, layout in layouts.items():
        rest = key[len(prefix):]
        if key.startswith(prefix) and rest.split(".")[0] in ("opt", "swag", "ivon"):
            return torch.cat([torch.full((size,), name.endswith("k_lin.bias")) for name, size in layout])
    return None


def compare_states(built, want, config, atol=STATE_ATOL):
    """Every float tensor of the port's state within ``atol`` of ``want``
    (JAX's state as a state_dict), the counters equal. A ``k_lin`` bias has
    a zero gradient in exact arithmetic (the softmax is blind to a shift of
    a row of scores): Adam turns each side's rounding-level gradient into
    steps of up to lr either way, so those parameters, and their elements of
    every flat vector, are held to 6 lr of each other instead
    (tests/test_torch_bert.py). The same holds for any element whose
    gradient in one step happens to fall to rounding size (Adam's first step
    is lr times the gradient's sign): in each tensor at most one element in
    a thousand (at least one) may be beyond ``atol``, within 6 lr. An
    optimizer's flat parameter buffer is the parameters' own storage, held
    by name; Adam's moments are held to 1e-5 of their tensor's largest
    entry where that is above ``atol``."""
    got = built.state.state_dict()
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())[:8]
    layouts = _flat_layouts(built.state)
    loose = 6 * config["lr"] * (1 + 1e-6)
    worst, worst_key = 0.0, None
    for k, g in got.items():
        g, w = g.detach().cpu(), want[k]
        if not g.is_floating_point():
            assert torch.equal(g.to(torch.int64), w.to(torch.int64)), (k, g, w)
            continue
        if k.endswith("opt.flat"):
            continue
        diff = (g.double() - w.double()).abs()
        if k.endswith("k_lin.bias"):
            assert diff.max() <= loose, k
            continue
        mask = _k_lin_elements(layouts, k)
        if mask is not None and diff.dim() and diff.shape[-1] == mask.shape[0]:
            if mask.any():
                assert diff[..., mask].max() <= loose, k
            diff = diff[..., ~mask]
        tol = atol
        if k.endswith((".mu", ".nu")) and w.numel():  # Adam's moments: gradients agree to about 1e-6 relative
            tol = max(atol, 1e-5 * float(w.abs().max()))
        if diff.numel():
            beyond = diff > tol
            assert int(beyond.sum()) <= max(1, diff.numel() // 1000) and diff.max() <= loose, (k, int(beyond.sum()))
            diff = diff[~beyond] / tol * atol
        gap = float(diff.max()) if diff.numel() else 0.0
        if gap >= worst:
            worst, worst_key = gap, k
    assert_close(worst, 0.0, atol=atol, err_msg=f"{config['model']} state, worst tensor {worst_key}")


def _record_precision(method, read, into):
    """``method`` with a ``finalize_epoch`` that first records ``read(state)``
    (SNGP's precision before the epoch's reset) in ``into``."""
    def finalize_epoch(state):
        into.append(np.array(read(state), np.float64))
        return method.finalize_epoch(state)

    return dataclasses.replace(method, finalize_epoch=finalize_epoch)


def _hold_sngp_precision(built, want, precisions):
    """SNGP's covariance, ``inv(precision + 1e-7 I)`` of a precision ``ridge
    I + sum k k^T`` (ridge 1e-3, 12 examples, 512 features: condition near
    1e7), differs between two fp32 inversions by up to the condition number
    times the rounding: the precisions the two sides accumulated over the
    epoch are held instead (within 1e-5 of the largest entry: sums of 12
    products of features that agree to about 1e-6), and the port
    then takes JAX's covariance, so that eval compares the forward."""
    jax_p, port_p = precisions
    assert_close(port_p, jax_p, rtol=0, atol=1e-5 * np.abs(jax_p).max(), err_msg="SNGP precision")
    key = "params.SNGPHead_0.covariance"
    with torch.no_grad():
        built.state.state_dict()[key].copy_(want[key])


def run_both(task, row, monkeypatch, fit_laplace=False):
    """JAX's and the port's build -> train (3 updates) -> eval_task of
    ``row`` from JAX's initial state with JAX's draws, the states held
    after training (:func:`compare_states`). With ``fit_laplace`` both fit
    the last-layer Laplace after training; the port's fit is held to JAX's
    (the Kronecker factors, compared as the matrices they rebuild, since
    eigenvectors carry signs and a null space may rotate), and the port
    evaluates JAX's fitted state, whose draws it is given. Returns (JAX's
    metrics, the port's, JAX's built, the port's built)."""
    x, y, xt, yt, mt = data(task)
    config = {**jax_wilds.DEFAULT_CONFIG, **row, **CUT, "bert_config": BERT, "seed": 0}
    if row.get("model") == "sngp":
        config["eval_samples"] = row["eval_samples"]
    config["dataset_size"] = x.shape[0]
    config["steps_per_epoch"] = steps = x.shape[0] // config["batch_size"]
    jbuilt = jax_wilds.build(task, config, jax.random.key(config["seed"]), steps)
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), steps, device="cpu")
    load_jax_state(built, jbuilt, config)

    sngp = config["model"] == "sngp"
    jax_p, port_p = [], []
    if sngp:
        jbuilt.method = _record_precision(jbuilt.method, lambda s: s.model_state["sngp"]["SNGPHead_0"]["precision"], jax_p)
        built.method = _record_precision(built.method, lambda s: s.params.SNGPHead_0.precision, port_p)
    record_draws(monkeypatch)
    jbuilt = jax_wilds.train(jbuilt, config, x, y)
    jax.effects_barrier()
    train_draws = list(RECORDED)
    trained = jax_state_dict(built, jbuilt, config)
    RECORDED.clear()
    if fit_laplace:
        lap = jax_laplace_method(jbuilt.model, hessian=config["ll_hessian"], regression=False, inner=jbuilt.method)
        jbuilt.state = lap.fit(jbuilt.state, (jnp.asarray(x), jnp.asarray(y)))
        jbuilt.method = lap
    want = jax_wilds.eval_task(jbuilt, task, config, xt, yt, mt)
    jax.effects_barrier()
    eval_draws = list(RECORDED)

    n_batches = -(-xt.shape[0] // config["eval_batch_size"])
    given = NoiseSource(given=port_draws(config, jbuilt, built, train_draws, eval_draws, steps, n_batches))
    monkeypatch.setattr(wilds_task, "NoiseSource", lambda **kw: given)
    built = wilds_task.train(built, config, x, y)
    if sngp:
        _hold_sngp_precision(built, trained, (jax_p[0], port_p[0]))
    compare_states(built, trained, config, atol=STATE_ATOL_SVGD if "svgd" in config["model"] else STATE_ATOL)
    if fit_laplace:
        wilds_task._fit_laplace(built, config, x, y)
        fitted, jfit = built.state, jbuilt.state
        for s, u, name in (("kron_sa", "kron_ua", "A"), ("kron_sb", "kron_ub", "B")):
            ws, wu = np.asarray(getattr(jfit, s)), np.asarray(getattr(jfit, u))
            gs, gu = getattr(fitted, s).numpy(), getattr(fitted, u).numpy()
            assert_close(gs, ws, rtol=1e-5, atol=1e-6 * np.abs(ws).max(), err_msg=f"eigenvalues {name}")
            rebuilt, want_m = (gu * gs) @ gu.T, (wu * ws) @ wu.T
            assert_close(rebuilt, want_m, rtol=1e-5, atol=1e-6 * np.abs(want_m).max(), err_msg=f"factor {name}")
        fitted.load_state_dict(state_from_jax(fitted.params, jfit))
    got = wilds_task.eval_task(built, task, {**config, "device_eval": False}, xt, yt, mt)
    assert given.draws == len(given._given), (given.draws, len(given._given))
    return want, got, jbuilt, built


def check_row(task, row, monkeypatch):
    """A row held against JAX: the states after three updates
    (:func:`compare_states`) and every float metric of ``eval_task``."""
    want, got, _, _ = run_both(task, row, monkeypatch, fit_laplace=row["model"] == "laplace")
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, float):
            assert_close(got[k], w, err_msg=f"{row['model']} {k}", **METRIC_TOL)
        else:
            assert got[k] == w, (k, got[k], w)
