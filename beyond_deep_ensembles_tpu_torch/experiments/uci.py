"""UCI regression: the 1x50 Gaussian-output MLP under every method of
``configs/uci.yaml``.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/uci.py`` (reference
experiments/uci/{uci.py,models.py}): ``map``, ``laplace`` (trained as
``map``, then a last-layer Laplace fit), ``mcd``, ``swag``, ``bbb``,
``bbb_fixed_kl``, ``rank1``, ``svgd`` and ``ivon``, each with ``members`` > 1
as a ``deep_ensemble`` (``svgd``'s ensemble is its particles), the NLL loss
with the variance clamp, ``RegressionResults`` over ``eval_samples``
posterior draws, plain and gap splits, and the grid search on the
validation split.

The optimizer is the JAX package's ``_base_tx``: Adam (after coupled weight
decay where ``weight_decay`` is set) on every parameter but the GaussLayer's
``rho__mle``, which takes plain SGD at ``var_lr`` (``utils/optim.py::
mle_split``, which finds the ``__mle`` parameters by name on the built
models and tells them apart by identity when the method hands them over).

Entry points run on CUDA unless ``device="cpu"`` is passed. The splits move
to the device once; each epoch's batch rows (``data/uci.py::batch_indices``
from ``RandomState(seed)``, shared across epochs, the last batch padded by
wrapping) move in one copy. Step s (counted over the run from 1) draws its
noise in key mode from ``fold_in(seed, s)``; with ``scan_steps`` > 1 every
``scan_steps`` batches go through the multi-step runner (a CUDA graph on a
card) under the key of the last, the rest of an epoch through single
updates. ``evaluate`` draws its S predictions from the key ``seed`` and the
quantile calibration's normals from ``seed + 1``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import keys
from ..data.uci import UCIDataset, batch_indices
from ..evals.regression import RegressionResults, nll_loss
from ..methods.api import GaussianPrior, LossOutput, PosteriorMethod, non_mle_mask
from ..methods.bbb import bbb_method
from ..methods.ensemble import deep_ensemble, predict
from ..methods.ivon import ivon_method
from ..methods.laplace import laplace_method
from ..methods.map import map_method
from ..methods.svgd import svgd_method
from ..methods.swag import swag_method
from ..models.mlp import RegressionMLP
from ..nn.base import Model
from ..nn.gaussian import NoiseSource
from ..parallel.multistep import make_multi_step, stack_batches
from ..utils.device import resolve_device
from ..utils.optim import SGD, Adam, mle_split

DEFAULT_CONFIG = {
    "dataset": "yacht",
    "batch_size": 32,
    "epochs": 40,
    "eval_samples": 100,
    "members": 1,
    "std_init": 1.0,
    "learn_var": False,
    "normalize": True,
    "val_percentage": 1.0,
    "dropout_p": 0.1,
    "prior_std": 1.0,
    "lr": 0.01,
    "weight_decay": 0.0,
    "var_lr": 0.01,
    "seed": 0,
    # algorithm-specific
    "mc_samples": 2,
    "kl_rescaling": 1.0,
    "components": 1,
    "l2_scale": 0.0,
    "swag_start": 0.75,
    "swag_deviation_samples": 30,
    "svgd_particles": 10,
    "svgd_l2": 1e-4,
    "ivon_lr": 0.01,
    "ivon_prior_prec": 100.0,
    "ivon_mc_samples": 5,
    "ll_hessian": "full",
    "laplace_samples": 100,
}

MODELS = ("map", "laplace", "mcd", "swag", "bbb", "bbb_fixed_kl", "rank1", "svgd", "ivon")


@dataclasses.dataclass
class BuiltExperiment:
    model: Model
    method: PosteriorMethod
    state: object
    apply_fn: Callable  # (params, model_state, noise, x, **kwargs) -> [B, 1, 2]
    device: torch.device


def _make_module(config, generator: torch.Generator, dense_kind: str = "plain", dropout_p: float = 0.0):
    return RegressionMLP(config["in_dim"], hidden=50, out_dim=1, dense_kind=dense_kind, dropout_p=dropout_p,
                         components=config.get("components", 1), std_init=config["std_init"],
                         learn_var=config["learn_var"], generator=generator)


def _loss_fn_for(model: Model):
    def loss_fn(params, model_state, noise, batch, component=None):
        x, y = batch
        kwargs = {} if component is None else {"component": component}
        out, kl, new_state = model.apply(params, model_state, noise, x, train=True, **kwargs)
        return LossOutput(loss=nll_loss(out, y), kl=kl, model_state=new_state)

    return loss_fn


def _apply_fn_for(model: Model):
    def apply_fn(params, model_state, noise, x, **kwargs):
        out, _, _ = model.apply(params, model_state, noise, x, train=False, **kwargs)
        return out

    return apply_fn


def _base_tx(config, modules):
    """optax ``multi_transform`` of ``adam(lr)`` (after
    ``add_decayed_weights(weight_decay)``, coupled L2, where it is set) on
    every parameter but the ``__mle`` ones and ``sgd(var_lr)`` on those
    (reference uci/models.py:17-21, 53)."""
    mle = []
    for module in modules:
        free = non_mle_mask(module)
        mle += [p for name, p in module.named_parameters() if not free[name]]
    return mle_split(
        mle,
        lambda params: Adam(params, config["lr"], weight_decay=config.get("weight_decay", 0.0)),
        lambda params: SGD(params, config.get("var_lr", 0.01)),
    )


def build(config: dict, train_set_size: int, generator: torch.Generator, device=None) -> BuiltExperiment:
    """The model(s), initialized from ``generator`` in turn, and the method
    state for ``config['model']`` (JAX ``build``; reference
    experiments/uci/models.py get_model). ``svgd``'s ``svgd_particles``
    particles are its ensemble (``members`` > 1 raises, as in JAX); any
    other model with ``members`` > 1 is a ``deep_ensemble``."""
    device = resolve_device(device)
    name, members = config["model"], config.get("members", 1)
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
    if name == "svgd" and members > 1:
        raise NotImplementedError("svgd ensembles use particles, not members")
    kind = {"bbb": "bbb", "bbb_fixed_kl": "bbb", "rank1": "rank1"}.get(name, "plain")
    dropout_p = config["dropout_p"] if name == "mcd" else 0.0
    count = config["svgd_particles"] if name == "svgd" else members
    modules = nn.ModuleList(_make_module(config, generator, kind, dropout_p) for _ in range(count)).to(device)
    model = Model(modules[0])
    loss_fn, tx = _loss_fn_for(model), _base_tx(config, modules)

    if name in ("map", "laplace", "mcd"):
        inner = map_method(loss_fn, tx)
    elif name == "swag":
        steps_per_epoch = max(1, train_set_size // config["batch_size"])
        start_epoch = int(config["swag_start"] * config["epochs"])
        swag_epochs = max(1, config["epochs"] - start_epoch)
        # an explicit interval wins (the reference yaml's update_interval),
        # else the HPO formula's
        update_interval = config.get("swag_update_interval") or max(1, int(steps_per_epoch * swag_epochs / 30))
        inner = swag_method(loss_fn, tx, update_interval=update_interval, start_epoch=start_epoch,
                            deviation_samples=config["swag_deviation_samples"])
    elif name in ("bbb", "bbb_fixed_kl"):
        inner = bbb_method(loss_fn, tx, GaussianPrior(0.0, config["prior_std"]), dataset_size=train_set_size,
                           mc_samples=config["mc_samples"],
                           kl_rescaling=config["kl_rescaling"] if name == "bbb" else 1.0)
    elif name == "rank1":
        inner = bbb_method(loss_fn, tx, GaussianPrior(0.0, config["prior_std"]), dataset_size=train_set_size,
                           mc_samples=config["mc_samples"], components=config.get("components", 1),
                           l2_scale=config.get("l2_scale", 0.0))
    elif name == "svgd":
        inner = svgd_method(loss_fn, tx, particle_count=config["svgd_particles"], dataset_size=train_set_size,
                            l2_reg=config["svgd_l2"])
    else:
        inner = ivon_method(loss_fn, lr=config["ivon_lr"], prior_prec=config["ivon_prior_prec"],
                            dataset_size=train_set_size, mc_samples=config["ivon_mc_samples"])

    if name == "svgd":
        method, state = inner, inner.init(modules, {})
    elif members > 1:
        method = deep_ensemble(inner, members)
        state = method.init(modules)
    else:
        method, state = inner, inner.init(modules[0], {})
    return BuiltExperiment(model, method, state, _apply_fn_for(model), device)


def _to_device(built: BuiltExperiment, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(built.device) for a in arrays)


def train(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray, seed: int = 0,
          log: Optional[Callable[[str], None]] = None) -> BuiltExperiment:
    """Epoch loop, one update per minibatch (reference uci.py:82-125; JAX
    ``train``): the batch order from ``RandomState(seed)``, step s under
    ``fold_in(seed, s)``, ``scan_steps`` > 1 through the multi-step runner,
    ``finalize_epoch`` after every epoch. The losses are read on the host
    only for the log line of every tenth epoch."""
    if config.get("data_parallel"):
        raise NotImplementedError("data_parallel: not ported yet (ROADMAP item 18, multi-device)")
    method, state = built.method, built.state
    xd, yd = _to_device(built, x, y)
    bs, n = config["batch_size"], xd.shape[0]
    scan_steps = config.get("scan_steps", 1)
    multi = make_multi_step(method.update, scan_steps) if scan_steps > 1 else None

    def single(state, step, batch):
        return method.update(state, NoiseSource(key=keys.as_key(keys.fold_in(seed, step), built.device)), batch)

    rng = np.random.RandomState(seed)
    step = 0
    for epoch in range(config["epochs"]):
        rows = torch.from_numpy(np.stack(list(batch_indices(n, bs, rng)))).to(built.device)
        losses, pending = [], []
        for idx in rows:
            batch = (xd[idx], yd[idx])
            step += 1
            if multi is not None:
                pending.append(batch)
                if len(pending) == scan_steps:
                    state, metrics = multi(state, keys.fold_in(seed, step), stack_batches(pending))
                    pending = []
                    losses += [metrics["loss"]] * scan_steps
                continue
            state, metrics = single(state, step, batch)
            losses.append(metrics["loss"])
        for batch in pending:  # fewer than scan_steps left: single updates
            step += 1
            state, metrics = single(state, step, batch)
            losses.append(metrics["loss"])
        state = method.finalize_epoch(state)
        if log and epoch % 10 == 0:
            log(f"epoch {epoch}: train loss {float(torch.mean(torch.stack(losses))):.5f}")
    built.state = state
    return built


def evaluate(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray, dataset: UCIDataset,
             seed: int = 42, z: Optional[torch.Tensor] = None) -> RegressionResults:
    """Posterior-predictive evaluation (reference uci.py:26-47): S =
    ``eval_samples`` draws over the whole split from the key ``seed`` (a
    Rank-1 mixture's sample i on component ``i % components``), then
    ``RegressionResults`` denormalized by the data set's target statistics,
    its quantile draw ``z`` given or drawn from ``seed + 1``."""
    xd, yd = _to_device(built, x, y)
    components = config.get("components", 1) if config.get("model") == "rank1" else 1
    with torch.no_grad():
        outputs = predict(built.method, built.state, built.apply_fn, xd, n_samples=config["eval_samples"],
                          noise=NoiseSource(key=keys.as_key(seed, built.device)), components=components)
        return RegressionResults.create(
            outputs, yd, key=seed + 1, z=z,
            target_mean=float(np.asarray(dataset.y_mean).reshape(-1)[0]),
            target_std=float(np.asarray(dataset.y_std).reshape(-1)[0]),
        )


def run_single(config: dict, split: str = "train", gap: Optional[int] = None, log=None,
               device=None) -> RegressionResults:
    """Train and evaluate one configuration on the standard split (or the
    validation split, ``split="val"``), or on gap split ``gap``: the
    training arrays come from the data set's first gap shuffle, the test
    arrays from its second (JAX ``run_single``)."""
    config = {**DEFAULT_CONFIG, **config}
    device = resolve_device(device)
    ds = UCIDataset(config["dataset"], normalize=config["normalize"], val_percentage=config["val_percentage"])
    config["in_dim"] = ds.in_dim
    x_train, y_train = ds.get_arrays("train" if split == "train" else "val_train", gap)
    x_test, y_test = ds.get_arrays("test" if split == "train" else "val_test", gap)

    built = build(config, x_train.shape[0], torch.Generator().manual_seed(config["seed"]), device=device)
    built = train(built, config, x_train, y_train, seed=config["seed"], log=log)
    if config["model"] == "laplace":
        built = fit_laplace(built, config, x_train, y_train)
    return evaluate(built, config, x_test, y_test, ds)


def fit_laplace(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray) -> BuiltExperiment:
    """Post-hoc last-layer Laplace (``ll_hessian``) on the trained MAP state,
    fitted on ``(x, y)`` (reference uci.py:127-136). With ``members`` > 1
    each member is fitted and the method is a ``deep_ensemble`` over the
    fitted members (as CIFAR's ``_fit_laplace``)."""
    method = laplace_method(built.model, hessian=config.get("ll_hessian", "full"), regression=True,
                            inner=built.method)
    built.state = method.fit(built.state, _to_device(built, x, y))
    members = config.get("members", 1)
    built.method = deep_ensemble(method, members) if members > 1 else method
    return built


def grid_search(config: dict, ranges: dict, gap: Optional[int] = None, log=None, device=None) -> dict:
    """Reference tune_hyperparams (uci.py:151-166): the full cross product on
    the validation split, the best by average log-likelihood."""
    best_ll, best = -float("inf"), None
    names = list(ranges.keys())
    for combo in itertools.product(*[ranges[k] for k in names]):
        trial = {**config, **dict(zip(names, combo))}
        ll = float(run_single(trial, split="val", gap=gap, device=device).average_log_likelihood)
        if log:
            log(f"trial {dict(zip(names, combo))}: ll {ll:.4f}")
        if ll > best_ll:
            best_ll, best = ll, dict(zip(names, combo))
    return {**config, **(best or {})}


# per-method HPO grids (reference uci.py:168-291, its knobs under the flat
# config keys)
HPO_GRIDS = {
    "map": {"epochs": [40, 100], "lr": [0.01, 0.001], "weight_decay": [1e-4, 1e-5]},
    "laplace": {"epochs": [40, 100], "lr": [0.01, 0.001], "weight_decay": [1e-4, 1e-5]},
    "mcd": {"epochs": [40, 100], "lr": [0.01, 0.001], "weight_decay": [1e-4, 1e-5], "dropout_p": [0.2, 0.1, 0.05]},
    "swag": {"epochs": [60, 100, 150], "lr": [0.01, 0.001], "weight_decay": [1e-4, 1e-5],
             "swag_start": [0.5, 0.75, 0.9]},
    "bbb": {"epochs": [200], "lr": [0.01, 0.001], "prior_std": [0.1, 1.0, 10.0], "kl_rescaling": [0.2, 0.5]},
    "bbb_fixed_kl": {"epochs": [200], "lr": [0.01, 0.001], "prior_std": [0.1, 1.0, 10.0]},
    "rank1": {"epochs": [100, 200], "lr": [0.01, 0.001], "l2_scale": [1e-4, 1e-5]},
    "svgd": {"epochs": [40, 100], "lr": [0.01, 0.001], "svgd_l2": [1e-4, 1e-5]},
    "ivon": {"epochs": [40, 100, 200], "ivon_lr": [0.01], "ivon_prior_prec": [10.0, 100.0, 200.0]},
}


def result_dict(res: RegressionResults) -> dict:
    return {
        "avg_ll": float(res.average_log_likelihood),
        "avg_lml": float(res.average_lml),
        "mse": float(res.mse_of_means),
        "qce": float(res.qce),
        "sqce": float(res.sqce),
    }


def run(config: dict, log=None, device=None) -> dict:
    """The UCI flow (reference uci.py:49-80): with ``hpo`` a grid search on
    the validation split first; the standard split over
    ``standard_split_reps`` seeds (``plain``, default on), and with ``gap``
    one repetition per input dimension, seeded by the dimension."""
    config = {**DEFAULT_CONFIG, **config}
    device = resolve_device(device)
    all_results = {}

    def tuned(gap):
        if config.get("hpo"):
            return grid_search(config, HPO_GRIDS[config["model"]], gap=gap, log=log, device=device)
        return config

    if config.get("plain", True):
        cfg = tuned(None)
        all_results["plain"] = [result_dict(run_single({**cfg, "seed": rep}, log=log, device=device))
                                for rep in range(config.get("standard_split_reps", 1))]

    if config.get("gap", False):
        gap_results = []
        for gap_split in range(UCIDataset(config["dataset"]).in_dim):
            cfg = tuned(gap_split)
            res = run_single({**cfg, "seed": gap_split}, gap=gap_split, log=log, device=device)
            gap_results.append({"gap_split": gap_split, "result": result_dict(res)})
        all_results["gap_results"] = gap_results
    return all_results
