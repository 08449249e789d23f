"""CIFAR-10 (+CIFAR-10-C) experiment: ResNet-20-FRN-swish under every method
of ``configs/cifar.yaml``, and their Multi-X ensembles.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/cifar.py`` (reference
experiments/cifar/{cifar.py,models.py,cifar.yaml}): SGD (momentum 0.9,
nesterov) under the Wilson schedule stepped per epoch (``utils/optim.py``,
state and lr on the device), crop + flip augmentation, 50 posterior samples
at eval, the clean test split and the corrupted splits of every intensity in
``corrupted_intensities``. Ported: the ``map``, ``mcd`` (``p``), ``swag``
(``swag_*``), ``bbb``, ``svgd``, ``rank1`` (``rank1_*``), ``ivon``
(``ivon_*``), ``sngp`` (``sngp``, ``spectral_norm_bound``) and ``laplace``
(``ll_hessian``) variants, each with ``members`` > 1 as a ``deep_ensemble``
(``svgd`` with one member: its particles are its ensemble), periodic
checkpoints with auto-resume and the ``{model}_final`` artifact
(``checkpoint_dir``, ``checkpoint_interval``), ``fit_laplace_phase`` and
``multix_phase``. The ``bf16`` key, the HMC baseline and data parallelism
raise.

Entry points run on CUDA unless ``device="cpu"`` is passed. The data sets
move to the device once, as NCHW float32. ``train`` runs, as in JAX, the
device-resident epoch runner under ``device_data`` (one bulk augmentation
pass per epoch), K steps per call under ``scan_steps`` > 1, or one update
per host call; ``eval_model`` runs the whole test set through the eval
runner under ``device_eval`` (the default on a card), or a host loop. The
runners replay CUDA graphs on a card (``parallel/multistep.py``). Every
path draws its noise in key mode from ``keys.fold_in`` of the seed: per
step (``fold_in(seed, step)``), per epoch, per eval batch; an ensemble's
members fold the step key with their index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import keys
from ..data import cifar as cifar_data
from ..data.native_loader import shuffled_indices
from ..evals.classification import EvalResult, analyze_output, bayesian_model_average
from ..methods.api import GaussianPrior, LossOutput, PosteriorMethod
from ..methods.bbb import bbb_method
from ..methods.ensemble import EnsembleState, deep_ensemble, predict
from ..methods.ivon import ivon_method
from ..methods.laplace import laplace_method
from ..methods.map import map_method
from ..methods.sngp import sngp_method
from ..methods.svgd import svgd_method
from ..methods.swag import swag_method
from ..models.resnet import ResNet20, SNGPResNet20
from ..nn.base import Model
from ..nn.gaussian import NoiseSource
from ..parallel.multistep import make_epoch_runner, make_eval_runner, make_multi_step, stack_batches
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.optim import SGD
from ..utils.schedules import wilson_schedule
from . import phases

DEFAULT_CONFIG = {
    "batch_size": 128,
    "eval_batch_size": 500,
    "epochs": 300,
    "eval_samples": 50,
    "ece_bins": 10,
    "members": 1,
    "lr": 0.05,
    "weight_decay": 0.0003,
    "momentum": 0.9,
    "nesterov": True,
    "lr_schedule": True,
    "subsample": None,
    "test_subsample": None,
    "seed": 0,
    # the variants' knobs (cifar.yaml defaults)
    "p": 0.1,  # MCD dropout
    "prior_std": 1.0,
    "bbb_mc_samples": 2,
    "kl_rescaling": 0.2,
    "swag_deviation_samples": 30,
    "swag_start_epoch": 250,
    "swag_lr": 0.0005,  # also the Wilson schedule's final lr
    "svgd_particles": 5,
    "svgd_reg_scale": 0.0003,
    "ivon_lr": 1e-4,
    "ivon_prior_prec": 50,
    "ivon_damping": 0.001,
    "ivon_augmentation": 10,
    "ivon_mc_samples": 2,
    "rank1_components": 4,
    "rank1_l2_scale": 0.0003,
    "rank1_kl_rescaling": 1.0,
    "sngp": {
        "num_random_features": 1024,
        "num_gp_features": -1,
        "normalize_gp_features": False,
        "ridge_penalty": 1.0,
        "mean_field_factor": 20.0,
        "feature_scale": 1.0,
        "rff_init_std": 0.05,
    },
    "spectral_norm_bound": 6.0,
    "ll_hessian": "full",
    "checkpoint_interval": 20,  # epochs between periodic saves (reference cifar.py:175-176)
    "dataset_size": 50_000,
}


def _xent_loss_fn(model: Model, augment: bool = True):
    def loss_fn(params, model_state, noise, batch, component=None):
        x, y = batch
        if augment:
            offsets, flips = noise.crops(x.shape[0], x.device)
            x = cifar_data.augment(x, offsets=offsets, flips=flips)
        kwargs = {} if component is None else {"component": component}
        out, kl, new_state = model.apply(params, model_state, noise, x, train=True, **kwargs)
        logp = F.log_softmax(out, dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
        acc = torch.mean((torch.argmax(out, dim=-1) == y).float())
        return LossOutput(loss=loss, kl=kl, model_state=new_state, metrics={"acc": acc})

    return loss_fn


def _predict_fn(model: Model):
    """``apply_fn(params, model_state, noise, x, **kwargs)``: log-probs of one
    forward at eval, ``kwargs`` a Rank-1 model's joint ``component`` or an
    SNGP model's ``n_samples``."""

    def apply_fn(params, model_state, noise, x, **kwargs):
        out, _, _ = model.apply(params, model_state, noise, x, train=False, **kwargs)
        return F.log_softmax(out, dim=-1)

    return apply_fn


def _base_tx(config, steps_per_epoch: int):
    """optax ``add_decayed_weights`` then ``sgd`` as the port's ``SGD``, with
    lr ``lr * factor(count // steps_per_epoch)`` on the device (constant
    without ``lr_schedule``). Returns ``tx(params) -> (SGD, None)``."""
    lr = config["lr"]

    def tx(params):
        schedule = None
        if config.get("lr_schedule", True):
            schedule = wilson_schedule(config["epochs"], lr, config.get("swag_lr"))
        optimizer = SGD(
            params, lr, momentum=config["momentum"], nesterov=config["nesterov"],
            weight_decay=config.get("weight_decay", 0.0), schedule=schedule, steps_per_epoch=steps_per_epoch,
        )
        return optimizer, None

    return tx


@dataclasses.dataclass
class BuiltExperiment:
    model: Model
    method: PosteriorMethod
    state: object
    apply_fn: Callable
    device: torch.device
    # eval runners by (test points, eval batch, samples), so that the clean
    # and corrupted splits capture their graph once (JAX cifar.py:509-516)
    eval_runners: dict = dataclasses.field(default_factory=dict)


def _resnet(config, generator: torch.Generator, conv_kind: str, dropout_p=None, components: int = 1) -> ResNet20:
    return ResNet20(classes=10, activation="swish", norm="frn", conv_kind=conv_kind, dropout_p=dropout_p,
                    components=components, generator=generator)


def _sngp_resnet(config, generator: torch.Generator) -> SNGPResNet20:
    """The SNGP model with the CIFAR build's frozen head (JAX :282-307): the
    reference hands the base SGD only the featurizer's parameters
    (cifar/models.py:98), so ``beta`` keeps its init, without step, momentum
    or weight decay; ``sngp_train_beta: True`` opts out."""
    model = SNGPResNet20(10, config["spectral_norm_bound"], config["sngp"], generator=generator)
    if not config.get("sngp_train_beta", False):
        model.SNGPHead_0.requires_grad_(False)
    return model


_PORTED = ("map", "mcd", "swag", "bbb", "svgd", "rank1", "ivon", "sngp", "laplace")


def _not_ported(config: dict) -> None:
    if config["model"] not in _PORTED:
        raise ValueError(f"unknown model {config['model']!r}")
    if config["model"] == "svgd" and config.get("members", 1) != 1:
        # the JAX build ignores members for svgd; the port refuses
        raise NotImplementedError("members > 1 with svgd (an ensemble of particle sets): not ported yet")
    for key in ("bf16", "use_hmc_baseline", "data_parallel"):
        if config.get(key):
            raise NotImplementedError(f"{key}: not ported yet")


def _uses_epoch_runner(config: dict) -> bool:
    """True when ``train`` takes the device-resident epoch runner, which
    augments the whole epoch in one bulk pass: the loss must not augment
    again (JAX ``_uses_epoch_runner``; the data-parallel path that could
    claim the run first there is not ported)."""
    return bool(config.get("device_data"))


def build(
    config: dict,
    generator: torch.Generator,
    steps_per_epoch: int = 390,
    device=None,
) -> BuiltExperiment:
    """The model(s), initialized from ``generator``, and the method state
    (JAX ``build``, :202-333): ``map`` (and ``laplace``, which trains as
    ``map``) a plain ResNet-20 under ``map_method``, ``mcd`` the same with
    ``dropout_p = p``, ``swag`` under ``swag_method`` (a collection every
    ``max(1, steps_per_epoch * max(1, epochs - swag_start_epoch) // 50)``
    steps), ``bbb`` the BBB ResNet-20, ``rank1`` the Rank-1 ResNet-20 of
    ``rank1_components`` under ``bbb_method`` with ``components``, ``ivon``
    a plain ResNet-20 under ``ivon_method``, ``sngp`` the
    ``SNGPResNet20`` under ``sngp_method`` (its head frozen), ``svgd`` its
    ``svgd_particles`` plain particles. With ``members`` > 1, M models are
    initialized from ``generator`` in turn and trained as a
    ``deep_ensemble``."""
    device = resolve_device(device)
    _not_ported(config)
    name, members = config["model"], config.get("members", 1)
    augment = config.get("augment", True) and not _uses_epoch_runner(config)
    tx = _base_tx(config, steps_per_epoch)
    if name == "svgd":
        particles = nn.ModuleList(
            _resnet(config, generator, "plain") for _ in range(config["svgd_particles"])
        ).to(device)
        model = Model(particles[0])
        method = svgd_method(
            _xent_loss_fn(model, augment=augment),
            tx,
            particle_count=config["svgd_particles"],
            dataset_size=config["dataset_size"],
            l2_reg=config["svgd_reg_scale"],
        )
        state = method.init(particles, {})
        return BuiltExperiment(model, method, state, _predict_fn(model), device)

    conv_kind = name if name in ("bbb", "rank1") else "plain"
    dropout_p = config["p"] if name == "mcd" else None
    components = config["rank1_components"] if name == "rank1" else 1
    if name == "sngp":
        modules = [_sngp_resnet(config, generator).to(device) for _ in range(members)]
    else:
        modules = [_resnet(config, generator, conv_kind, dropout_p, components).to(device) for _ in range(members)]
    model = Model(modules[0])
    loss_fn = _xent_loss_fn(model, augment=augment)
    if name in ("map", "mcd", "laplace"):
        method = map_method(loss_fn, tx)
    elif name == "sngp":
        method = sngp_method(loss_fn, tx, ridge_penalty=config["sngp"]["ridge_penalty"])
    elif name == "ivon":
        method = ivon_method(
            loss_fn,
            lr=config["ivon_lr"],
            prior_prec=config["ivon_prior_prec"],
            dataset_size=config["dataset_size"],
            damping=config["ivon_damping"],
            augmentation=config["ivon_augmentation"],
            mc_samples=config["ivon_mc_samples"],
        )
    elif name == "rank1":
        method = bbb_method(
            loss_fn,
            tx,
            GaussianPrior(0.0, config["prior_std"]),
            dataset_size=config["dataset_size"],
            mc_samples=config["bbb_mc_samples"],
            components=components,
            kl_rescaling=config["rank1_kl_rescaling"],
            l2_scale=config["rank1_l2_scale"],
        )
    elif name == "swag":
        # mean_samples = 50 collected over the SWA epochs (cifar.yaml)
        swag_epochs = max(1, config["epochs"] - config["swag_start_epoch"])
        method = swag_method(
            loss_fn,
            tx,
            update_interval=max(1, steps_per_epoch * swag_epochs // 50),
            start_epoch=config["swag_start_epoch"],
            deviation_samples=config["swag_deviation_samples"],
        )
    else:
        method = bbb_method(
            loss_fn,
            tx,
            GaussianPrior(0.0, config["prior_std"]),
            dataset_size=config["dataset_size"],
            mc_samples=config["bbb_mc_samples"],
            kl_rescaling=config["kl_rescaling"],
        )
    if members > 1:
        method = deep_ensemble(method, members)
        state = method.init(modules)
    else:
        state = method.init(modules[0], {})
    return BuiltExperiment(model, method, state, _predict_fn(model), device)


def _to_device(built: BuiltExperiment, x: np.ndarray, y: np.ndarray):
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(built.device).permute(0, 3, 1, 2).contiguous()
    return xd, torch.from_numpy(np.asarray(y, np.int64)).to(built.device)


def _bulk_augment(key: int, data):
    """The epoch runner's transform: one crop + flip pass over the whole
    shuffled epoch, its draws from ``key`` on the device."""
    x, y = data
    offsets, flips = NoiseSource(key=keys.as_key(key, x.device)).crops(x.shape[0], x.device)
    return cifar_data.augment(x, offsets=offsets, flips=flips), y


def _end_epoch(state, method, epoch: int, epoch_loss: float, log):
    if not math.isfinite(epoch_loss):
        raise RuntimeError("Diverged")  # reference poverty.py:137-141
    state = method.finalize_epoch(state)
    if log:
        log(f"epoch {epoch}: loss {epoch_loss:.4f}")
    return state


def train(
    built: BuiltExperiment,
    config: dict,
    x: np.ndarray,
    y: np.ndarray,
    log: Optional[Callable[[str], None]] = None,
) -> BuiltExperiment:
    """Epoch loop (reference cifar.py:131-186), as JAX ``train`` runs it:

      * ``device_data``: the epoch runner, epoch e under ``fold_in(seed, e)``
        (its own device permutation, one bulk augmentation pass, the
        remainder dropped);
      * otherwise each epoch walks ``shuffled_indices(n, seed * 1_000_003 +
        epoch)`` (the JAX loader's SplitMix64 shuffle, ``data/native_loader.py``)
        and drops the last partial batch, step s (counted over the
        run from 1) under ``fold_in(seed, s)``: with ``scan_steps`` > 1, every
        ``scan_steps`` batches go through the multi-step runner (under the key
        of the last) and the rest of an epoch through single updates.

    With ``checkpoint_dir``, both paths resume from the latest
    ``checkpoint_<epoch>`` there (the host loop's step count at ``start *
    (n // batch_size)``, so the step keys go on as in JAX :421) and save one
    every ``checkpoint_interval`` epochs, the file written behind the next
    epoch and waited for when the loop ends, however it ends. One host read
    per epoch, the divergence check."""
    method, state = built.method, built.state
    xd, yd = _to_device(built, x, y)
    seed, bs, n = config["seed"], config["batch_size"], xd.shape[0]
    ckpt_dir = config.get("checkpoint_dir")
    start = 0
    if ckpt_dir:
        state, resumed = ckpt.restore_checkpoint(ckpt_dir, state)
        if resumed is not None:
            start = resumed + 1
            if log:
                log(f"resumed from epoch {resumed}")

    if _uses_epoch_runner(config):
        transform = _bulk_augment if config.get("augment", True) else None
        runner = make_epoch_runner(method.update, n, bs, epoch_transform=transform)

        def run_epoch(epoch, state):
            state, metrics = runner(state, keys.fold_in(seed, epoch), (xd, yd))
            return state, metrics["loss"]
    else:
        scan_steps = config.get("scan_steps", 1)
        multi = make_multi_step(method.update, scan_steps) if scan_steps > 1 else None

        def single(state, step, batch):
            noise = NoiseSource(key=keys.as_key(keys.fold_in(seed, step), built.device))
            return method.update(state, noise, batch)

        def run_epoch(epoch, state):
            order = torch.from_numpy(shuffled_indices(n, seed * 1_000_003 + epoch)).to(built.device)
            step, losses, pending = epoch * (n // bs), [], []
            for s in range(n // bs):
                idx = order[s * bs : (s + 1) * bs]
                batch = (xd[idx], yd[idx])
                step += 1
                if multi is not None:
                    pending.append(batch)
                    if len(pending) == scan_steps:
                        state, metrics = multi(state, keys.fold_in(seed, step), stack_batches(pending))
                        pending = []
                        losses.append(metrics["loss"])
                    continue
                state, metrics = single(state, step, batch)
                losses.append(metrics["loss"])
            for batch in pending:  # fewer than scan_steps left: single updates
                step += 1
                state, metrics = single(state, step, batch)
                losses.append(metrics["loss"])
            return state, torch.mean(torch.stack(losses))

    try:
        for epoch in range(start, config["epochs"]):
            state, loss = run_epoch(epoch, state)
            state = _end_epoch(state, method, epoch, float(loss), log)
            if ckpt_dir and (epoch + 1) % config.get("checkpoint_interval", 20) == 0:
                ckpt.save_checkpoint(ckpt_dir, epoch, state, async_save=True)
    finally:
        if ckpt_dir:
            ckpt.wait_for_async_saves(ckpt_dir)
    built.state = state
    return built


def eval_model(
    built: BuiltExperiment,
    config: dict,
    x: np.ndarray,
    y: np.ndarray,
    seed: int = 42,
) -> EvalResult:
    """Posterior-predictive eval over the test set (reference
    cifar.py:26-69): S samples -> log-space BMA -> EvalResult, batch i under
    ``fold_in(seed, i)``. With ``device_eval`` (the default on a card, or
    under ``device_data``) the whole set goes through the eval runner,
    cached on ``built`` per (points, eval batch, S); else a host loop over
    the same batches and keys. Either way the last partial batch is padded
    with copies of its last image and trimmed, so every point counts once."""
    method, state = built.method, built.state
    bs, n_samples = config["eval_batch_size"], config["eval_samples"]
    # rank-1 mixtures: sample i evaluates the joint component i % components
    components = config.get("rank1_components", 1) if config.get("model") == "rank1" else 1
    xd, yd = _to_device(built, x, y)
    n = xd.shape[0]

    def predict_batch(state, key, xb):
        log_probs = predict(method, state, built.apply_fn, xb, n_samples=n_samples, noise=NoiseSource(key=key),
                            components=components)
        return bayesian_model_average(log_probs)

    device_eval = config.get("device_eval", bool(config.get("device_data")) or built.device.type == "cuda")
    with torch.no_grad():
        if device_eval:
            # the runner closes over the method: one swapped in since (a
            # Laplace fit after evals during training) needs a new one
            cached, runner = built.eval_runners.get((n, bs, n_samples), (None, None))
            if cached is not method:
                runner = make_eval_runner(predict_batch, n, bs)
                built.eval_runners[(n, bs, n_samples)] = (method, runner)
            log_marginal = runner(state, seed, xd)
        else:
            outs = []
            for i, start in enumerate(range(0, n, bs)):
                xb = xd[start : start + bs]
                valid = xb.shape[0]
                if valid < bs:
                    xb = torch.cat([xb, xb[-1:].expand(bs - valid, *xb.shape[1:])])
                key = keys.as_key(keys.fold_in(seed, i), built.device)
                outs.append(predict_batch(state, key, xb)[:valid])
            log_marginal = torch.cat(outs)
    correct, conf, ll, _, _ = analyze_output(log_marginal, yd)
    return EvalResult.create(correct, conf, ll, bin_count=config["ece_bins"])


def _load_data(config: dict):
    """The run's splits and its config with ``dataset_size`` set."""
    x_train, y_train = cifar_data.load_cifar10(True, subsample=config["subsample"])
    x_test, y_test = cifar_data.load_cifar10(False, subsample=config["test_subsample"])
    return {**config, "dataset_size": x_train.shape[0]}, (x_train, y_train), (x_test, y_test)


def _build_for(config: dict, device) -> BuiltExperiment:
    """``build`` as ``run_single`` calls it: the seed's generator, the
    steps an epoch of ``dataset_size`` images takes."""
    steps_per_epoch = max(1, config["dataset_size"] // config["batch_size"])
    return build(config, torch.Generator().manual_seed(config["seed"]), steps_per_epoch, device=device)


def run_single(config: dict, log=None, device=None) -> dict:
    """Train + eval on the clean test split and on the corrupted split of
    every intensity in ``corrupted_intensities``; returns the metric dicts
    by split (``test``, ``corrupted{i}``). With ``checkpoint_dir`` the
    trained state is saved there as ``{model}_final`` (reference
    cifar.py:98). ``laplace`` fits its posterior on the training set after
    the save (JAX :601-609)."""
    config = {**DEFAULT_CONFIG, **config}
    _not_ported(config)
    device = resolve_device(device)
    config, (x_train, y_train), (x_test, y_test) = _load_data(config)
    built = train(_build_for(config, device), config, x_train, y_train, log=log)
    if config.get("checkpoint_dir"):
        ckpt.save_final(config["checkpoint_dir"], config["model"], built.state)
    if config["model"] == "laplace":
        _fit_laplace(built, config, x_train, y_train)
    results = {"test": eval_model(built, config, x_test, y_test).as_dict()}
    for intensity in config.get("corrupted_intensities") or []:
        xc, yc = cifar_data.load_cifar10_corrupted(intensity, subsample=config["test_subsample"])
        results[f"corrupted{intensity}"] = eval_model(built, config, xc, yc).as_dict()
    return results


def _rebuild(config: dict, device=None):
    """A run's experiment built afresh, untrained, with its splits (JAX
    ``_rebuild``, :643-650)."""
    config = {**DEFAULT_CONFIG, **config}
    _not_ported(config)
    device = resolve_device(device)
    config, train_split, test_split = _load_data(config)
    return config, _build_for(config, device), train_split, test_split


def _fit_laplace(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray) -> None:
    """``built``'s trained MAP state (or MAP ensemble) replaced by its
    last-layer Laplace posterior, fitted on ``(x, y)`` with ``ll_hessian``.
    With ``members`` > 1 the method is a ``deep_ensemble`` over the fitted
    members: the JAX ``run_single`` sets the bare Laplace method there, whose
    ``sample`` cannot read a stacked state."""
    lap = laplace_method(built.model, hessian=config["ll_hessian"], regression=False, inner=built.method)
    built.state = lap.fit(built.state, _to_device(built, x, y))
    members = config.get("members", 1)
    built.method = deep_ensemble(lap, members) if members > 1 else lap


def fit_laplace_phase(config: dict, run_dir: str, log=None, device=None) -> dict:
    """Post-hoc Laplace on a saved ``{from_model}_final`` (``from_model``
    defaults to ``map``; JAX :653-669, the reference's fit-laplace protocol,
    cifar.py:188-210): the state restored into a fresh build, the posterior
    fitted on the training split, the test split's metrics."""
    config = {**config, "model": config.get("from_model", "map")}
    config, built, (x_train, y_train), (x_test, y_test) = _rebuild(config, device)
    built.state = ckpt.restore_final(run_dir, config["model"], built.state)
    _fit_laplace(built, config, x_train, y_train)
    if log:
        first = built.state.members[0] if isinstance(built.state, EnsembleState) else built.state
        log(f"fit_laplace: prior_prec={float(first.prior_prec):.4g}")
    return {"test": eval_model(built, config, x_test, y_test).as_dict()}


def multix_phase(config: dict, run_dirs, leave_out: Optional[int] = None, log=None, device=None) -> dict:
    """Multi-X from independently trained ``{model}_final`` states, one per
    run directory, ``leave_out`` (an index into ``run_dirs``) left out
    (reference eval_ensembles' leave-one-out; JAX :672-685): the test
    split's metrics."""
    config, built, _, (x_test, y_test) = _rebuild(dict(config), device)
    states = phases.load_members(run_dirs, config["model"], lambda: _build_for(config, built.device).state)
    built.method, built.state = phases.multix_from_checkpoints(built.method, states, leave_out=leave_out)
    if log:
        log(f"multix: {len(run_dirs)} members, leave_out={leave_out}")
    return {"test": eval_model(built, config, x_test, y_test).as_dict()}
