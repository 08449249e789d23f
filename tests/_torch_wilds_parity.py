"""The WILDS rows through the JAX package's and the port's engines
(``experiments/wilds_task.py``), from one state and with JAX's draws.

:func:`run_both` builds a row on both sides at TINY_CONFIG's width (the text
tasks) or the ``tiny`` DenseNet's on 32x32 crops (the image tasks), carries
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
    placeholder) has no counterpart;
  * an image task's activation draws (BBB conv noise, dropout masks) are
    NHWC, or HWC for a frozen row at eval: NCHW and CHW on the port;
  * a regression task's (poverty's) last eval draw is the quantile
    calibration's normals, which the port's ``eval_task`` takes as ``z``.
"""
from pathlib import Path

import dataclasses
import math
import re

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
from beyond_deep_ensembles_tpu_torch.ops import sampling

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
# the ResNet-50 rows (iwildcam, rxrx1) run both engines' ResNet-50 under
# swish (:func:`swish_resnets`); their features are 512 wide at the tiny cut
# (the tiny DenseNet's 20, TINY_CONFIG's 64), so the products over them that
# SNGP and Laplace accumulate carry a larger fp32 gap. SNGP's precision sums
# 12 outer products of cos(W f + b) over 512 random features, whose phases
# carry the features' gap (about 1e-6 relative at init on each side against
# float64) times |W f|: 3.8e-5 of the largest entry at lr 0; after three
# Adam steps, whose first step takes any rounding-size gradient to +-lr
# (compare_states' 6 lr), the features move with those steps, so the gap
# grows with lr: 1.7e-4 (relu) and 4.5e-4 (swish) at iwildcam's 3e-5, 9.9e-4
# at rxrx1's 1e-4: held within 3e-3 of the largest entry (JAX's covariance
# is then loaded, so eval compares the forward at 1e-5). Laplace's
# Kronecker factor A is the second moment of the
# 512 pooled features: 2.3e-5 of its largest entry after three updates, held
# within 1e-4 of it.
RESNET_PRECISION_TOL = 3e-3
RESNET_FACTOR_TOL = 1e-4
# the spectral ResNet-50 under the SNGP head: the same phases make its loss
# gradient ill-conditioned in fp32, within 2.1e-5 (the port) and 4.0e-5 (JAX)
# of the largest gradient of a float64 gradient at JAX's initial state, so
# Adam's moments (about 1e-6 relative elsewhere) are held within 1e-4 of
# their largest entry; and 3.6-6.7 % of that gradient's elements lie below
# the gap, where Adam's first step (lr times the sign) is a coin flip: 0.097 %
# of the parameters end beyond 2e-6, so up to one element in a hundred of a
# tensor (not one in a thousand) may lie beyond its bound, within 6 lr
RESNET_SNGP_MOMENT_TOL = 1e-4
RESNET_SNGP_BEYOND_IN = 100


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


def image_task(task) -> bool:
    return task in wilds_task.IMAGE_TASKS


def resnet_task(task) -> bool:
    return task in wilds_task.RESNET50_TASKS


def swish_resnets(monkeypatch):
    """Both packages' ResNets built with swish where they ask for relu.

    A ReLU input within rounding of zero takes the other side of the kink in
    each framework and moves every gradient that flows through it by that
    activation's whole share (tests/_torch_resnet50_parity.py: 1.3 % of the
    largest gradient, where the port's fp32 gradient is within 1e-6 of its
    float64 one); over a ResNet-50's 1.5e5 ReLU inputs a step or two of a
    row meets one, and Adam's moments then differ by more than their 1e-5
    (iwildcam LL_SVGD: 86,132 elements of ``backbone_opt.mu``). Swish has no
    kink, so the rows' engines are held under it; ``F.relu`` against flax's
    ``relu`` is held by the model tests' outputs, and the CLI tests run the
    yamls' relu."""
    import torch.nn.functional as F

    from beyond_deep_ensembles_tpu.models import resnet as jax_resnet
    from beyond_deep_ensembles_tpu_torch.models import resnet as port_resnet

    jax_act, port_act = jax_resnet._activation, port_resnet._activation
    monkeypatch.setattr(jax_resnet, "_activation", lambda name: jax.nn.swish if name == "relu" else jax_act(name))
    monkeypatch.setattr(port_resnet, "_activation", lambda name: F.silu if name == "relu" else port_act(name))


def data(task):
    """JAX's train and test splits, cut in size (the text to its first SEQ
    tokens, the images to 32x32, as the engines' ``tiny`` cuts them)."""
    x, y, _ = wilds_data.load_wilds(task, "train", subsample=N_TRAIN)
    xt, yt, mt = wilds_data.load_wilds(task, "test", subsample=N_TEST)
    if image_task(task):
        return x[:, :32, :32], y, xt[:, :32, :32], yt, mt
    return x[:, :SEQ], y, xt[:, :SEQ], yt, mt


def row_config(task, row) -> dict:
    """A yaml row cut in size only, at the tiny width (JAX's config; the
    port takes the same)."""
    width = {"tiny": True} if image_task(task) else {"bert_config": BERT}
    config = {**jax_wilds.DEFAULT_CONFIG, **row, **CUT, **width, "seed": 0}
    if row.get("model") == "sngp":
        config["eval_samples"] = row["eval_samples"]
    return config


def _nchw(draws):
    """An image task's activation draws, NHWC (HWC) -> NCHW (CHW)."""
    perm = {4: (0, 3, 1, 2), 3: (2, 0, 1)}
    return [d.permute(*perm[d.ndim]).contiguous() if d.ndim in perm else d for d in draws]


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
    if isinstance(state, EnsembleState):  # the members share their layout
        state = state.members[0]
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
    if config["members"] > 1:  # one member's tree (the draws are per member)
        template = jax.tree.map(lambda leaf: leaf[0], template)
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
    load_state(built, jax_state_dict(built, jbuilt, config))


def load_state(built, state_dict):
    """``state_dict`` (JAX's state as the port's, or a port state's, of any
    float dtype) into the port's state, in place."""
    state = built.state
    state.load_state_dict(state_dict)
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


# parameters whose gradient is zero in exact arithmetic: DistilBERT's k_lin
# biases (the softmax is blind to a shift of a row of scores), the DenseNet
# stem norm's scale (every consumer of the stem's channels is a static BN,
# blind to a per-channel scale, and the ReLU and the max pool before them are
# positively homogeneous) and the biases of a ResNet-50 bottleneck's three
# main-path convs (each followed by its dropout and a static BN, blind to a
# per-channel shift), or of a ResNet-18 basic block's two (each followed by
# its dropout and a static BN)
ZERO_GRADIENT = ("k_lin.bias", "DenseNet_0._BN_0.StaticBatchNorm_0.scale")
_BOTTLENECK_BIAS = re.compile(r"(Bottleneck_\d+\.\w*Conv_[012]|BasicBlock_\d+\.\w*Conv_[01])\.bias$")


def zero_gradient(name: str) -> bool:
    """Whether parameter ``name`` is one of the zero-gradient parameters
    above."""
    return name.endswith(ZERO_GRADIENT) or _BOTTLENECK_BIAS.search(name) is not None


def _k_lin_elements(layouts, key):
    """A bool vector over the flat tensor ``key`` (or None): True on the
    elements of the :data:`ZERO_GRADIENT` parameters."""
    for prefix, layout in layouts.items():
        rest = key[len(prefix):]
        if key.startswith(prefix) and rest.split(".")[0] in ("opt", "swag", "ivon"):
            return torch.cat([torch.full((size,), zero_gradient(name)) for name, size in layout])
    return None


def compare_states(built, want, config, atol=STATE_ATOL, moment_tol=None, beyond_in=1000):
    """Every float tensor of the port's state within ``atol`` of ``want``
    (JAX's state as a state_dict), the counters equal. A ``k_lin`` bias (or
    another of :data:`ZERO_GRADIENT`) has a zero gradient in exact
    arithmetic (the softmax is blind to a shift of a row of scores): Adam
    turns each side's rounding-level gradient into steps of up to lr either
    way, so those parameters, and their elements of
    every flat vector, are held to 6 lr of each other instead
    (tests/test_torch_bert.py). The same holds for any element whose
    gradient in one step happens to fall to rounding size (Adam's first step
    is lr times the gradient's sign): in each tensor at most one element in
    a thousand (one in ``beyond_in``; at least one) may be beyond ``atol``,
    within 6 lr. An
    optimizer's flat parameter buffer is the parameters' own storage, held
    by name; Adam's moments are held to 1e-5 of their tensor's largest
    entry where that is above ``atol``, or, given ``moment_tol``, to that
    share of it, the few elements beyond it then to ten times that (or 6
    lr, whichever is larger)."""
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
        if zero_gradient(k):
            assert diff.max() <= loose, k
            continue
        mask = _k_lin_elements(layouts, k)
        if mask is not None and diff.dim() and diff.shape[-1] == mask.shape[0]:
            if mask.any():
                assert diff[..., mask].max() <= loose, k
            diff = diff[..., ~mask]
        tol, far = atol, loose
        if k.endswith((".mu", ".nu")) and w.numel():  # Adam's moments: gradients agree to about 1e-6 relative
            tol = max(atol, (moment_tol or 1e-5) * float(w.abs().max()))
            if moment_tol is not None:  # the outliers in the gradient's units, not lr's
                far = max(loose, 10 * tol)
        if diff.numel():
            beyond = diff > tol
            assert int(beyond.sum()) <= max(1, diff.numel() // beyond_in) and diff.max() <= far, (
                k, int(beyond.sum()))
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


def _hold_sngp_precision(built, want, precisions, tol=1e-5):
    """SNGP's covariance, ``inv(precision + 1e-7 I)`` of a precision ``ridge
    I + sum k k^T`` (ridge 1e-3, 12 examples, 512 features: condition near
    1e7), differs between two fp32 inversions by up to the condition number
    times the rounding: the precisions the two sides accumulated over the
    epoch are held instead (within 1e-5 of the largest entry: sums of 12
    products of features that agree to about 1e-6), and the port
    then takes JAX's covariance, so that eval compares the forward."""
    jax_p, port_p = precisions
    assert_close(port_p, jax_p, rtol=0, atol=tol * np.abs(jax_p).max(), err_msg="SNGP precision")
    key = "params.SNGPHead_0.covariance"
    with torch.no_grad():
        built.state.state_dict()[key].copy_(want[key])


def jax_config(config) -> dict:
    """The config the JAX engine runs: without the multi-device flags (under
    tests/conftest.py JAX sees 8 virtual CPU devices, where they would
    shard; JAX's tests/test_engine_parallel.py holds the sharded runs equal
    to the plain ones) and without remat (exact in JAX, and its recompute
    would record each draw of a rematerialized layer again)."""
    out = {k: v for k, v in config.items() if k not in ("data_parallel", "ring_shard")}
    out["conv_remat"] = "none"
    return out


def _hold_full_laplace(fitted, jfit):
    """A full-Hessian fit: the MAP vector, the prior precision and the
    covariance ``L L^T`` (within 1e-3 of its largest entry). The prior
    precision is the argmax of a marginal likelihood that is flat near it
    (32 golden-section steps pin each side's argmax to 1e-7): the GGNs'
    fp32 rounding moves it by a few 1e-4 relative, held to 1e-3. The port
    then evaluates JAX's fit."""
    assert_close(fitted.ll_mean.numpy(), np.asarray(jfit.ll_mean), rtol=0, atol=STATE_ATOL, err_msg="ll_mean")
    assert_close(float(fitted.prior_prec), float(jfit.prior_prec), rtol=1e-3, atol=0, err_msg="prior_prec")
    got_l, want_l = fitted.scale_tril.double().numpy(), np.asarray(jfit.scale_tril, np.float64)
    want_cov = want_l @ want_l.T
    assert_close(got_l @ got_l.T, want_cov, rtol=0, atol=1e-3 * np.abs(want_cov).max(), err_msg="covariance")


# poverty's rows are ill-conditioned in fp32: GaussLayer's NLL at std 0.1
# divides squared residuals by 0.01 (gradients of 1e4 at init), and Adam at
# lr 1e-3 turns a gradient of rounding size into a step of lr with the
# rounding's sign: after three updates both engines' fp32 parameters lie
# about 1.8 % (relative L2 of the change) from the port's float64 update of
# the same start on the same draws (MAP), so they cannot be held element by
# element. Each engine's update is held against that float64 update instead
# (:func:`_hold_against_float64`): JAX's parameter change within 3 x the
# port's own fp32 error of it (measured: 0.03 % to 2.3 % on each side, JAX's
# 1.0-1.8 x the port's), and each engine's whole state (Adam's moments,
# SWAG's, iVON's) within REGRESSION_STATE_TOL of it (relative L2 of the
# change; measured up to 1.2e-3, JAX's MCD). A whole-state norm hides a
# fault confined to one small leaf, so each leaf (a parameter, or its
# segment of Adam's, SWAG's or iVON's flat vectors) is held as well
# (:func:`_hold_leaves`): the zero-gradient parameters' (a basic block's two
# conv biases before static BNs) within 6 lr (measured up to 5.4 lr, the
# Rank-1 biases), every other leaf within REGRESSION_LEAF_TOL of its change
# (measured up to 0.47 % on a leaf with an element beyond 3 lr, JAX's SVGD
# Adam second moment), or REGRESSION_FLIP_TOL where every element lies
# within 3 lr, so that the gap is a few Adam steps on rounding-size
# gradients (measured up to 15 %, JAX's SVGD: one element of a 64-wide BN
# bias 1.99 lr off; 7.6 %, JAX's BBB bias mean; the port's up to 3.6 %).
# Each update's metrics, the port's against JAX's: the first, from one
# state, within REGRESSION_FIRST_UPDATE_RTOL (measured up to 1.4e-5, BBB's
# KL, a sum over 22 M parameters), the later two, from each engine's own
# fp32 state, within REGRESSION_LATER_UPDATE_RTOL (measured up to 1.2e-3,
# MCD's second loss). Then the port takes JAX's trained state, so the
# Laplace fit and the eval compare from one state.
# The eval from that one state: the trained ResNet-18's outputs through
# static BNs over eval batches of 4 agree to about 1.5e-5 (the model tests
# hold outputs to 1e-4), which the metrics carry: the log-likelihoods sum
# log-densities of variance near 0.01, and the Pearson r's of 2-4 test
# points move with each prediction. Every metric of a regression row is
# held within REGRESSION_METRIC_TOL (measured up to 2.4e-5 relative,
# SWAG's avg_lml, and 2.6e-5 absolute, MAP's r_urban).
REGRESSION_STATE_TOL = 3e-3
REGRESSION_LEAF_TOL = 0.05
REGRESSION_FLIP_TOL = 0.3
REGRESSION_FIRST_UPDATE_RTOL = 3e-5
REGRESSION_LATER_UPDATE_RTOL = 3e-3
REGRESSION_METRIC_TOL = dict(rtol=1e-4, atol=1e-4)


class _PlainEpilogue(NoiseSource):
    """Given draws, the BBB epilogue by K1's plain version (which takes any
    dtype), for the float64 update."""

    def gaussian(self, act_mean, act_var, b_mean, b_var, train, freeze_on_eval):
        shape = act_mean.shape[1:] if not train and freeze_on_eval else act_mean.shape
        eps = self._take(shape).to(dtype=act_mean.dtype)
        return sampling.gaussian_sample_plain(act_mean, act_var, b_mean, b_var, eps)


def _recording_metrics(method, into, traced=False):
    """``method`` with an ``update`` that also appends each update's metrics
    (``{name: float}``) to ``into``; ``traced`` for JAX's, which ``train``
    runs under ``jit`` (an ordered ``jax.debug.callback``)."""
    def record(metrics):
        into.append({k: float(v) for k, v in metrics.items()})

    def update(state, noise, batch):
        state, metrics = method.update(state, noise, batch)
        if traced:
            jax.debug.callback(record, metrics, ordered=True)
        else:
            record(metrics)
        return state, metrics

    return dataclasses.replace(method, update=update)


def _columns(exact, others):
    """Per column of 2-D ``exact``: the float64 sum of squares of
    ``exact`` over its rows, and of each of ``others`` minus it, with the
    largest magnitude of each difference; a row at a time, rows zero in all
    of them skipped (a SWAG ring is 20 rows of the parameter vector, most
    of them empty after three updates)."""
    norm = torch.zeros(exact.shape[1], dtype=torch.float64)
    sq = [torch.zeros_like(norm) for _ in others]
    far = [torch.zeros_like(norm) for _ in others]
    for i in range(exact.shape[0]):
        if not any(bool(x[i].any()) for x in (exact, *others)):
            continue
        e = exact[i].double()
        norm += e * e
        for x, s, f in zip(others, sq, far):
            d = x[i].double() - e
            s += d * d
            torch.maximum(f, d.abs(), out=f)
    return norm, sq, far


def _leaf_gaps(start, exact, states, layouts):
    """Per leaf: ``{name: (squared L2 norm of exact's change, of exact,
    [squared L2 gap of each of states to exact], [max abs gap of each])}``
    in float64. A leaf is a float tensor of ``start``, or, in a flat vector
    over the parameters (an optimizer's, SWAG's, iVON's; its leading axes
    the ring's rows or the members), one parameter's segment
    (``"<key>[<parameter>]"``)."""
    out = {}
    for k, t in start.items():
        if not t.is_floating_point() or k.endswith("opt.flat") or not t.numel():
            continue
        layout = None
        for prefix, entries in layouts.items():
            if k.startswith(prefix) and k[len(prefix):].split(".")[0] in ("opt", "swag", "ivon"):
                layout = entries
        segments = [(k, 0, t.numel())]
        width = t.numel()
        if layout is not None and t.dim() and t.shape[-1] == sum(size for _, size in layout):
            offsets = np.cumsum([0] + [size for _, size in layout])
            segments = [(f"{k}[{name}]", int(a), int(b)) for (name, _), a, b in zip(layout, offsets, offsets[1:])]
            width = t.shape[-1]
        rows = [x.detach().reshape(-1, width) for x in (exact[k], t, *(state[k] for state in states))]
        norm, (change, *sq), (_, *far) = _columns(rows[0], rows[1:])
        for name, a, b in segments:
            out[name] = (float(change[a:b].sum()), float(norm[a:b].sum()),
                         [float(g[a:b].sum()) for g in sq], [float(f[a:b].max()) for f in far])
    return out


def _hold_leaves(config, leaves):
    """Each engine's state against the float64 update leaf by leaf
    (:func:`_leaf_gaps`): a zero-gradient parameter's leaves within 6 lr
    (:func:`zero_gradient`: each side's Adam steps of up to lr on a gradient
    of rounding size; under MCD's dropout masks the gradient is not zero,
    and such a leaf may pass by the relative rule instead), every leaf
    within REGRESSION_LEAF_TOL of its change (relative L2; a change below fp32's resolution of the leaf is
    counted as that resolution), or within REGRESSION_FLIP_TOL where no
    element of it lies more than 3 lr from float64."""
    lr = config["lr"]
    for side, name in ((0, "port"), (1, "JAX")):
        worst = (0.0, 0.0, "")
        for leaf, (change, norm, gaps, far) in leaves.items():
            if zero_gradient(leaf.split("[")[-1].rstrip("]")) and far[side] <= 6 * lr * (1 + 1e-6):
                continue
            rel = math.sqrt(gaps[side] / max(change, (np.finfo(np.float32).eps ** 2) * norm, 1e-300))
            tol = REGRESSION_FLIP_TOL if far[side] <= 3 * lr * (1 + 1e-6) else REGRESSION_LEAF_TOL
            if rel / tol >= worst[0] / max(worst[1], 1e-300):
                worst = (rel, tol, leaf)
        assert_close(worst[0], 0.0, atol=worst[1],
                     err_msg=f"{config['model']} {name}'s worst leaf against float64: {worst[2]}")


def _hold_update_metrics(config, port, jax_side, exact):
    """Each update's metrics (loss; BBB's and Rank-1's data_loss and kl;
    iVON's and SVGD's backbone_loss), the port's against JAX's: the first
    update's from one state within REGRESSION_FIRST_UPDATE_RTOL, the later
    ones' from the engines' own fp32 states within REGRESSION_LATER_UPDATE_RTOL."""
    assert len(port) == len(jax_side) == len(exact) == config["steps_per_epoch"], (len(port), len(jax_side))
    for i, (p, j) in enumerate(zip(port, jax_side)):
        assert p.keys() == j.keys() == exact[i].keys(), (p.keys(), j.keys())
        rtol = REGRESSION_FIRST_UPDATE_RTOL if i == 0 else REGRESSION_LATER_UPDATE_RTOL
        for k in p:
            assert_close(p[k], j[k], rtol=rtol, atol=0, err_msg=f"{config['model']} update {i + 1} {k}")


def _hold_against_float64(task, config, built, want, start, draws, x, y, monkeypatch, metrics=None):
    """The port's fp32 update (``built``) and JAX's (``want``, as a
    state_dict) against the port's float64 update of ``start`` on the same
    ``draws`` (see :data:`REGRESSION_STATE_TOL`). ``metrics``: (the port's,
    JAX's) per-update metrics, held against the float64 update's."""
    torch.set_default_dtype(torch.float64)
    try:
        exact = wilds_task.build(task, config, torch.Generator().manual_seed(0), config["steps_per_epoch"],
                                 device="cpu")
    finally:
        torch.set_default_dtype(torch.float32)
    load_state(exact, {k: t.double() if t.is_floating_point() else t for k, t in start.items()})
    source = _PlainEpilogue(given=draws)
    exact_metrics = []
    exact.method = _recording_metrics(exact.method, exact_metrics)
    with monkeypatch.context() as m:
        m.setattr(wilds_task, "NoiseSource", lambda **kw: source)
        exact = wilds_task.train(exact, config, x.astype(np.float64), y)
    assert source.draws == len(draws)
    exact = exact.state.state_dict()
    got = built.state.state_dict()
    leaves = _leaf_gaps(start, exact, (got, want), _flat_layouts(built.state))
    def rel(names, side):
        return math.sqrt(sum(leaves[k][2][side] for k in names) / sum(leaves[k][0] for k in names))

    params = [k for k in leaves if k.startswith("params.")]
    port_err, jax_err = rel(params, 0), rel(params, 1)
    assert_close(jax_err, 0.0, atol=3 * port_err,
                 err_msg=f"{config['model']} parameters, JAX's against float64 (the port's fp32: {port_err:.3g})")
    for side, name in ((0, "port"), (1, "JAX")):
        assert_close(rel(leaves, side), 0.0, atol=REGRESSION_STATE_TOL,
                     err_msg=f"{config['model']} state, {name}'s against float64")
    _hold_leaves(config, leaves)
    if metrics is not None:
        _hold_update_metrics(config, *metrics, exact_metrics)
    for k, t in start.items():
        if not t.is_floating_point():
            assert torch.equal(got[k].to(torch.int64), exact[k].to(torch.int64)), k
            assert torch.equal(want[k].to(torch.int64), exact[k].to(torch.int64)), k


def jit_jax_init(monkeypatch):
    """JAX's ``Model.init`` under ``jax.jit`` (one compile per model): the
    full ResNet-18's eager init runs an op at a time, 14-25 s on an 8-core CPU,
    jitted about 4 s. The port starts from whatever state JAX's ``build``
    made, so nothing compared depends on it."""
    from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel

    eager, compiled = JaxModel.init, {}

    def init(self, key, *example_inputs, train=True):
        if id(self) not in compiled:
            compiled[id(self)] = (self, jax.jit(lambda k, *xs: eager(self, k, *xs, train=train)))
        return compiled[id(self)][1](key, *example_inputs)

    monkeypatch.setattr(JaxModel, "init", init)


def run_both(task, row, monkeypatch, fit_laplace=False):
    """JAX's and the port's build -> train (3 updates) -> eval_task of
    ``row`` from JAX's initial state with JAX's draws, the states held
    after training (:func:`compare_states`; a regression row's against
    float64 by :func:`_hold_against_float64`, the port then taking JAX's
    trained state). With ``fit_laplace`` both fit
    the last-layer Laplace after training; the port's fit is held to JAX's
    (the Kronecker factors, compared as the matrices they rebuild, since
    eigenvectors carry signs and a null space may rotate), and the port
    evaluates JAX's fitted state, whose draws it is given. Returns (JAX's
    metrics, the port's, JAX's built, the port's built)."""
    if resnet_task(task) or task == "poverty":
        swish_resnets(monkeypatch)
    if task == "poverty":
        jit_jax_init(monkeypatch)
    x, y, xt, yt, mt = data(task)
    config = row_config(task, row)
    config["dataset_size"] = x.shape[0]
    config["steps_per_epoch"] = steps = x.shape[0] // config["batch_size"]
    jconfig = jax_config(config)
    jbuilt = jax_wilds.build(task, jconfig, jax.random.key(config["seed"]), steps)
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), steps, device="cpu")
    load_jax_state(built, jbuilt, config)
    start = {k: t.detach().clone() for k, t in built.state.state_dict().items()}

    sngp = config["model"] == "sngp"
    jax_p, port_p = [], []
    port_metrics, jax_metrics = [], []
    if jbuilt.regression:
        jbuilt.method = _recording_metrics(jbuilt.method, jax_metrics, traced=True)
        built.method = _recording_metrics(built.method, port_metrics)
    if sngp:
        jbuilt.method = _record_precision(jbuilt.method, lambda s: s.model_state["sngp"]["SNGPHead_0"]["precision"], jax_p)
        built.method = _record_precision(built.method, lambda s: s.params.SNGPHead_0.precision, port_p)
    record_draws(monkeypatch)
    jbuilt = jax_wilds.train(jbuilt, jconfig, x, y)
    jax.effects_barrier()
    train_draws = list(RECORDED)
    trained = jax_state_dict(built, jbuilt, config)
    RECORDED.clear()
    if fit_laplace:
        lap = jax_laplace_method(jbuilt.model, hessian=config["ll_hessian"], regression=jbuilt.regression,
                                 inner=jbuilt.method)
        jbuilt.state = lap.fit(jbuilt.state, (jnp.asarray(x), jnp.asarray(y)))
        jbuilt.method = lap
    want = jax_wilds.eval_task(jbuilt, task, jconfig, xt, yt, mt)
    jax.effects_barrier()
    eval_draws = list(RECORDED)
    z = None
    if jbuilt.regression:
        kind, quantile = eval_draws.pop()
        assert kind == "normal" and quantile.shape == (config["eval_samples"], xt.shape[0], 1), quantile.shape
        z = torch.from_numpy(np.array(quantile))

    n_batches = -(-xt.shape[0] // config["eval_batch_size"])
    draws = port_draws(config, jbuilt, built, train_draws, eval_draws, steps, n_batches)
    given = NoiseSource(given=_nchw(draws) if image_task(task) else draws)
    monkeypatch.setattr(wilds_task, "NoiseSource", lambda **kw: given)
    x, xt = wilds_task.task_images(task, config, x), wilds_task.task_images(task, config, xt)
    built = wilds_task.train(built, config, x, y)
    if sngp:
        _hold_sngp_precision(built, trained, (jax_p[0], port_p[0]),
                             RESNET_PRECISION_TOL if resnet_task(task) else 1e-5)
    if jbuilt.regression:
        _hold_against_float64(task, config, built, trained, start, given._given[:given.draws], x, y, monkeypatch,
                              (port_metrics, jax_metrics))
        load_state(built, trained)
    else:
        compare_states(built, trained, config, atol=STATE_ATOL_SVGD if "svgd" in config["model"] else STATE_ATOL,
                       **(dict(moment_tol=RESNET_SNGP_MOMENT_TOL, beyond_in=RESNET_SNGP_BEYOND_IN)
                          if sngp and resnet_task(task) else {}))
    if fit_laplace:
        wilds_task._fit_laplace(built, config, x, y)
        fitted, jfit = built.state, jbuilt.state
        if config["ll_hessian"] == "full":
            _hold_full_laplace(fitted, jfit)
        for s, u, name in (("kron_sa", "kron_ua", "A"), ("kron_sb", "kron_ub", "B"))[:2 * (config["ll_hessian"] == "kron")]:
            ws, wu = np.asarray(getattr(jfit, s)), np.asarray(getattr(jfit, u))
            gs, gu = getattr(fitted, s).numpy(), getattr(fitted, u).numpy()
            assert_close(gs, ws, rtol=1e-5, atol=1e-6 * np.abs(ws).max(), err_msg=f"eigenvalues {name}")
            rebuilt, want_m = (gu * gs) @ gu.T, (wu * ws) @ wu.T
            tol = dict(rtol=0, atol=RESNET_FACTOR_TOL * np.abs(want_m).max()) if resnet_task(task) else dict(
                rtol=1e-5, atol=1e-6 * np.abs(want_m).max())
            assert_close(rebuilt, want_m, err_msg=f"factor {name}", **tol)
        fitted.load_state_dict(state_from_jax(fitted.params, jfit))
    got = wilds_task.eval_task(built, task, {**config, "device_eval": False}, xt, yt, mt, z=z)
    assert given.draws == len(given._given), (given.draws, len(given._given))
    return want, got, jbuilt, built


def check_row(task, row, monkeypatch):
    """A row held against JAX: the states after three updates
    (:func:`compare_states`) and every float metric of ``eval_task``."""
    want, got, jbuilt, _ = run_both(task, row, monkeypatch, fit_laplace=row["model"] == "laplace")
    assert got.keys() == want.keys()
    tol = REGRESSION_METRIC_TOL if jbuilt.regression else METRIC_TOL
    for k, w in want.items():
        if isinstance(w, float):
            assert_close(got[k], w, err_msg=f"{row['model']} {k}", **tol)
        else:
            assert got[k] == w, (k, got[k], w)
