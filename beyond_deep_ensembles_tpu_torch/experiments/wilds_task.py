"""WILDS experiment runner: the DistilBERT text tasks, Amazon and
CivilComments, under every method of ``configs/amazon.yaml`` and
``configs/civilcomments.yaml``.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/wilds_task.py``
(reference experiments/{amazon,civilcomments}/{*.py,models.py,*.yaml}), for
``task`` ``amazon`` (L = 512, 5 classes, the 10th-percentile user accuracy)
and ``civilcomments`` (L = 300, 2 classes, the worst-group accuracy).
Ported: ``build`` -> ``train`` -> ``eval_task`` / ``run_single`` with
``model`` ``map``, ``mcd`` (``dropout_p``; ``last_layer_mcd`` keeps the
encoder's dropouts off at eval), ``swag``, ``bbb``, ``rank1``, ``svgd``,
``ivon``, ``sngp``, ``laplace`` (``ll_hessian``) and the last-layer
``swag_ll``, ``ll_bbb``, ``ll_ivon`` and ``ll_svgd`` (``methods/
last_layer.py``, the head both dense layers), each with ``members`` > 1 as
a ``deep_ensemble`` (``svgd`` with one: its particles are its ensemble);
``ring_dtype``; periodic checkpoints with auto-resume and the
``{model}_final`` artifact (``checkpoint_dir``, ``checkpoint_interval``);
the device-resident epoch (``device_data``), K steps per call
(``scan_steps``) and the device-resident eval (``device_eval``), whose
runners replay CUDA graphs on a card (``parallel/multistep.py``);
``eval_while_train``; and the phases ``fit_laplace_phase``,
``eval_only_phase``, ``sweep_drop_rates_phase`` and ``multix_phase``. The
optimizer is the JAX package's ``_tx``: weight decay added to the gradient,
then Adam or SGD with momentum (the port's ``utils/optim.py``, whose state
lives on the device, so a CUDA graph can capture a step), at a constant
rate. Every path draws its noise in key mode from ``keys.fold_in`` of the
seed: per step, per epoch, per eval batch.

Not ported yet, each raising ``NotImplementedError``: the image tasks
(ROADMAP item 15), pretrained DistilBERT weights (``load_hf_weights`` waits
until the files are in the repository), the ``exponential`` and
``cosine_warmup`` schedules, bf16 compute, remat, ``ring_shard`` and data
parallelism (item 18).

Entry points run on CUDA unless ``device="cpu"`` is passed. The data sets
move to the device once; each step gathers its batch there, in the order of
the JAX package's native loader (``data/native_loader.py``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import keys
from ..data import wilds as wilds_data
from ..data.native_loader import shuffled_indices
from ..data.uci import data_dir
from ..evals.classification import EvalResult, analyze_output, bayesian_model_average
from ..methods.api import GaussianPrior, LossOutput, PosteriorMethod
from ..methods.bbb import bbb_method
from ..methods.ensemble import EnsembleState, deep_ensemble, predict
from ..methods.ivon import ivon_method
from ..methods.laplace import laplace_method
from ..methods.last_layer import last_layer_method
from ..methods.map import map_method
from ..methods.sngp import sngp_method
from ..methods.svgd import svgd_method
from ..methods.swag import swag_method
from ..models.bert import TINY_CONFIG, BertClassifier, BertSNGP, DistilBertConfig
from ..nn.base import Model
from ..nn.gaussian import NoiseSource
from ..parallel.multistep import make_epoch_runner, make_eval_runner, make_multi_step, stack_batches
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.optim import SGD, Adam
from . import phases

DEFAULT_CONFIG = {
    "batch_size": 32,
    "eval_batch_size": 64,
    "epochs": 5,
    "eval_samples": 10,
    "ece_bins": 10,
    "members": 1,
    "lr": 1e-3,
    "weight_decay": 0.0,
    "momentum": 0.9,
    "subsample": None,
    "test_subsample": None,
    "seed": 0,
    "dropout_p": 0.1,
    "prior_std": 1.0,
    "bbb_mc_samples": 1,
    "kl_rescaling": 1.0,
    "swag_deviation_samples": 30,
    "swag_start_epoch": 2,
    "swag_updates": 50,
    "svgd_particles": 3,
    "svgd_reg_scale": 1e-4,
    "ivon_lr": 1e-4,
    "ivon_prior_prec": 50,
    "ivon_mc_samples": 2,
    "rank1_components": 2,
    "rank1_l2_scale": 1e-4,
    "sngp": {"num_random_features": 512, "ridge_penalty": 0.001,
             "mean_field_factor": 0.25, "feature_scale": 2.0},
    "spectral_norm_bound": 6.0,
    "ll_hessian": "full",
    "tiny": False,  # TINY_CONFIG's DistilBERT, for tests
    "static_bn": True,  # the image backbones' key, kept with the JAX defaults
}

TEXT_TASKS = ("amazon", "civilcomments")
MODELS = ("map", "mcd", "swag", "bbb", "rank1", "svgd", "ivon", "sngp", "laplace",
          "swag_ll", "ll_bbb", "ll_ivon", "ll_svgd")


def _bert_config(config: dict) -> DistilBertConfig:
    """distilbert-base by default, TINY_CONFIG under ``tiny``, or an explicit
    ``bert_config`` dict."""
    override = config.get("bert_config")
    if override:
        return DistilBertConfig(**override)
    if config.get("tiny"):
        return TINY_CONFIG
    return DistilBertConfig(remat=bool(config.get("bert_remat", False)))


def _not_ported(task: str, config: dict) -> None:
    if task not in wilds_data.TASKS:
        raise ValueError(f"unknown task {task!r}")
    if task not in TEXT_TASKS:
        raise NotImplementedError(f"task {task!r}: not ported yet (the image tasks, ROADMAP item 15)")
    if config["model"] not in MODELS:
        raise ValueError(f"unknown model {config['model']!r}")
    if config["model"] == "svgd" and config.get("members", 1) != 1:
        # the JAX build ignores members for svgd; the port refuses
        raise NotImplementedError("members > 1 with svgd (an ensemble of particle sets): not ported yet")
    if config.get("compute_dtype", "fp32") not in ("fp32", "float32"):
        raise NotImplementedError("bf16 compute: not ported yet (ROADMAP item 13)")
    if config.get("lr_schedule_kind", "none") != "none":
        raise NotImplementedError(f"lr schedule {config['lr_schedule_kind']!r}: not ported yet")
    for key in ("data_parallel", "ring_shard"):
        if config.get(key):
            raise NotImplementedError(f"{key}: not ported yet (ROADMAP item 18)")
    pretrained = config.get("pretrained_path") or (
        config.get("pretrained", True)
        and os.path.exists(os.path.join(data_dir(), "distilbert-base-uncased", "pytorch_model.bin"))
    )
    if pretrained:
        raise NotImplementedError("pretrained DistilBERT weights (load_hf_weights): not ported yet")


def _make_backbone(task: str, config: dict, generator: torch.Generator, head_kind: str = "map",
                   dropout_p=None) -> nn.Module:
    """The DistilBERT classifier: its head ``map`` for plain layers, ``bbb``
    or ``rank1`` (``rank1_components``), or with ``dropout_p`` the
    MC-Dropout ``drop`` head, whose encoder dropouts sample at eval too
    unless ``last_layer_mcd`` (reference amazon/models.py:67-73)."""
    head = "drop" if dropout_p is not None else head_kind
    return BertClassifier(
        classes=wilds_data.TASKS[task].classes,
        head_kind=head,
        drop_p=dropout_p or 0.2,
        components=config.get("rank1_components", 1),
        config=_bert_config(config),
        mc_encoder_dropout=head == "drop" and not config.get("last_layer_mcd", False),
        generator=generator,
    )


def _loss_fn_for(model: Model):
    def loss_fn(params, model_state, noise, batch, component=None):
        x, y = batch
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


def _tx(config: dict):
    """optax ``add_decayed_weights`` then ``adam`` (or ``sgd`` with momentum)
    as the port's ``Adam`` and ``SGD`` (``utils/optim.py``): weight decay
    added to the gradient before the moments, so torch ``Adam``, not
    ``AdamW``; Adam's defaults (betas 0.9, 0.999, eps 1e-8) are optax's.
    ``train_all_layers: false`` freezes the encoder in ``build`` (no
    gradient, so no step and no decay, as optax's ``set_to_zero`` leaves
    it). Returns ``tx(params) -> (optimizer, None)``."""
    lr, wd = config["lr"], config.get("weight_decay", 0.0)

    def tx(params):
        if config.get("optimizer_kind", "sgd") == "adam":
            return Adam(params, lr, weight_decay=wd), None
        return SGD(params, lr, momentum=config.get("momentum", 0.9), weight_decay=wd), None

    return tx


def _ring_kwargs(config: dict) -> dict:
    """``ring_dtype: bf16`` stores SWAG's deviation ring in bfloat16 (JAX
    ``_ring_kwargs``); ``ring_shard`` raises in ``_not_ported``."""
    rd = config.get("ring_dtype")
    if rd in ("bf16", "bfloat16"):
        return {"ring_dtype": torch.bfloat16}
    if rd not in (None, "fp32", "float32"):
        raise ValueError(f"ring_dtype {rd!r} (want fp32 or bf16)")
    return {}


def bert_head_mask(params: nn.Module) -> dict:
    """The text tasks' last layer (JAX ``bert_head_mask``): every parameter
    outside the encoder, both head layers (the reference hands
    ``classifier.parameters()`` to the last-layer optimizer,
    civilcomments/models.py)."""
    return {name: not name.startswith("bert.") for name, _ in params.named_parameters()}


@dataclasses.dataclass
class BuiltExperiment:
    model: Model
    method: PosteriorMethod
    state: object
    apply_fn: Callable
    device: torch.device
    # eval runners by (test points, eval batch, samples): captured once for
    # every eval_while_train epoch of one split (JAX :923-932)
    eval_runners: dict = dataclasses.field(default_factory=dict)


def build(task: str, config: dict, generator: torch.Generator, steps_per_epoch: Optional[int] = None,
          device=None) -> BuiltExperiment:
    """The model(s), initialized from ``generator``, and the method state
    (JAX ``build``, :376-559). ``dataset_size`` (the variational methods')
    and, for SWAG's interval, ``steps_per_epoch`` come from the config
    ``_load_task_data`` filled when not given."""
    device = resolve_device(device)
    config = {**DEFAULT_CONFIG, **config}
    _not_ported(task, config)
    name, members = config["model"], config.get("members", 1)
    steps_per_epoch = steps_per_epoch or config.get("steps_per_epoch", 1)
    tx = _tx(config)
    prior = GaussianPrior(0.0, config["prior_std"])

    def swag_interval():
        swag_epochs = max(1, config["epochs"] - config["swag_start_epoch"])
        return max(1, steps_per_epoch * swag_epochs // config["swag_updates"])

    def inner_factory_for(inner_name):
        """``loss_fn -> PosteriorMethod``, full-model and last-layer alike."""
        if inner_name == "swag":
            return lambda lf: swag_method(lf, tx, update_interval=swag_interval(),
                                          start_epoch=config["swag_start_epoch"],
                                          deviation_samples=config["swag_deviation_samples"], **_ring_kwargs(config))
        if inner_name == "bbb":
            return lambda lf: bbb_method(lf, tx, prior, dataset_size=config["dataset_size"],
                                         mc_samples=config["bbb_mc_samples"], kl_rescaling=config["kl_rescaling"])
        if inner_name == "ivon":
            return lambda lf: ivon_method(lf, lr=config["ivon_lr"], prior_prec=config["ivon_prior_prec"],
                                          dataset_size=config["dataset_size"], mc_samples=config["ivon_mc_samples"],
                                          damping=config.get("ivon_damping", 0.0))
        if inner_name == "svgd":
            return lambda lf: svgd_method(lf, tx, particle_count=config["svgd_particles"],
                                          dataset_size=config["dataset_size"], l2_reg=config["svgd_reg_scale"])
        raise ValueError(inner_name)

    def modules(make):
        return [make().to(device) for _ in range(members)]

    if name == "svgd":
        particles = nn.ModuleList(_make_backbone(task, config, generator)
                                  for _ in range(config["svgd_particles"])).to(device)
        model = Model(particles[0])
        method = inner_factory_for("svgd")(_loss_fn_for(model))
        state = method.init(particles, {})
        return BuiltExperiment(model, method, state, _predict_fn(model), device)

    if name == "sngp":
        made = modules(lambda: BertSNGP(wilds_data.TASKS[task].classes, _bert_config(config), config["sngp"],
                                        generator=generator))
    elif name in ("bbb", "rank1"):
        made = modules(lambda: _make_backbone(task, config, generator, head_kind=name))
    elif name == "mcd":
        made = modules(lambda: _make_backbone(task, config, generator, dropout_p=config["dropout_p"]))
    elif name == "ll_bbb":
        made = modules(lambda: _make_backbone(task, config, generator, head_kind="bbb"))
    else:
        made = modules(lambda: _make_backbone(task, config, generator))
    if not config.get("train_all_layers", True):
        for module in made:  # reference civilcomments/models.py:165-176
            module.bert.requires_grad_(False)
    model = Model(made[0])
    loss_fn = _loss_fn_for(model)
    if name in ("map", "mcd", "laplace"):
        method = map_method(loss_fn, tx)
    elif name in ("swag", "bbb", "ivon"):
        method = inner_factory_for(name)(loss_fn)
    elif name == "rank1":
        method = bbb_method(loss_fn, tx, prior, dataset_size=config["dataset_size"],
                            mc_samples=config["bbb_mc_samples"], components=config["rank1_components"],
                            l2_scale=config["rank1_l2_scale"])
    elif name == "sngp":
        method = sngp_method(loss_fn, tx, ridge_penalty=config["sngp"]["ridge_penalty"])
    else:  # swag_ll, ll_bbb, ll_ivon, ll_svgd (reference iwildcam/models.py:87-154)
        inner_name = name.replace("_ll", "").replace("ll_", "")
        method = last_layer_method(
            loss_fn, inner_factory_for(inner_name), backbone_tx=tx, mask_fn=bert_head_mask,
            head_particles=config["svgd_particles"] if inner_name == "svgd" else 0, generator=generator,
        )
    if members > 1:
        method = deep_ensemble(method, members)
        state = method.init(made)
    else:
        state = method.init(made[0], {})
    return BuiltExperiment(model, method, state, _predict_fn(model), device)


def _to_device(built: BuiltExperiment, x: np.ndarray, y: np.ndarray):
    return (torch.from_numpy(np.ascontiguousarray(x)).to(built.device),
            torch.from_numpy(np.asarray(y, np.int64)).to(built.device))


def _end_epoch(state, method, epoch: int, epoch_loss: float, log):
    if not math.isfinite(epoch_loss):
        raise RuntimeError("Diverged")  # reference civil.py:156-160
    state = method.finalize_epoch(state)
    if log:
        log(f"epoch {epoch}: loss {epoch_loss:.4f}")
    return state


def train(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray,
          log: Optional[Callable[[str], None]] = None, epoch_callback=None) -> BuiltExperiment:
    """Epoch loop (JAX ``train``, :662-850):

      * ``device_data``: the epoch runner, epoch e under ``fold_in(seed, e)``
        (its own device permutation, the remainder dropped);
      * otherwise each epoch walks ``shuffled_indices(n, seed * 1_000_003 +
        epoch)`` (the JAX ``PrefetchLoader`` order) and drops the last
        partial batch, step s (counted over the run from 1) under
        ``fold_in(seed, s)``: with ``scan_steps`` > 1, every ``scan_steps``
        batches go through the multi-step runner (under the key of the
        last) and the rest of an epoch through single updates.

    With ``checkpoint_dir``, both paths resume from the latest
    ``checkpoint_<epoch>`` there (the host loop's step count at ``start *
    (n // batch_size)``) and save one every ``checkpoint_interval`` epochs
    (default 20), written behind the next epoch and waited for when the loop
    ends, however it ends. ``epoch_callback(epoch, built)`` runs after each
    epoch's ``finalize_epoch`` (eval_while_train, early stopping). One host
    read per epoch, the divergence check."""
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

    if config.get("device_data"):
        runner = make_epoch_runner(method.update, n, bs)

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
            built.state = state
            if ckpt_dir and (epoch + 1) % config.get("checkpoint_interval", 20) == 0:
                ckpt.save_checkpoint(ckpt_dir, epoch, state, async_save=True)
            if epoch_callback is not None:
                epoch_callback(epoch, built)
    finally:
        if ckpt_dir:
            ckpt.wait_for_async_saves(ckpt_dir)
    built.state = state
    return built


def eval_metrics(log_marginal: torch.Tensor, targets: torch.Tensor, bin_count: int) -> EvalResult:
    """The log-marginals' calibration metrics in one function (JAX
    ``_metrics_program``: ``analyze_output`` then ``EvalResult.create``)."""
    correct, conf, ll, _, _ = analyze_output(log_marginal, targets)
    return EvalResult.create(correct, conf, ll, bin_count=bin_count)


def eval_task(built: BuiltExperiment, task: str, config: dict, x: np.ndarray, y: np.ndarray,
              meta: np.ndarray, seed: int = 42) -> dict:
    """Posterior-predictive eval and the task's official WILDS metrics (JAX
    ``eval_task``, :868-1021): batch i under ``fold_in(seed, i)``, S samples
    each (a Rank-1 model's sample i on the joint component ``i %
    rank1_components``), the log-space model average per example, then
    :func:`eval_metrics` and ``evaluate_task``. With ``device_eval`` (the
    default on a card, or under ``device_data``, for a test set of at most
    2 GiB) the whole set goes through the eval runner, cached on ``built``
    per (points, eval batch, S) and method; else a host loop over the same batches and
    keys. Either way the last partial batch is padded with copies of its
    last example and trimmed, so every example counts once."""
    if wilds_data.TASKS[task].classes == 1:
        raise NotImplementedError("the regression eval (poverty): not ported yet (ROADMAP item 15)")
    method, state = built.method, built.state
    bs, n_samples = config["eval_batch_size"], config["eval_samples"]
    components = config.get("rank1_components", 1) if config.get("model") == "rank1" else 1
    xd, yd = _to_device(built, x, y)
    n = xd.shape[0]

    def predict_batch(state, key, xb):
        log_probs = predict(method, state, built.apply_fn, xb, n_samples=n_samples, noise=NoiseSource(key=key),
                            components=components)
        return bayesian_model_average(log_probs)

    device_eval = config.get(
        "device_eval", (bool(config.get("device_data")) or built.device.type == "cuda") and x.nbytes <= 2 << 30)
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
        result = eval_metrics(log_marginal, yd, config["ece_bins"])
    preds = log_marginal.argmax(dim=1).cpu().numpy()
    official = wilds_data.evaluate_task(task, preds, np.asarray(y), meta[: len(preds)])
    return {**result.as_dict(), **official}


def _load_task_data(task: str, config: dict):
    """The train and test splits; sets ``dataset_size`` and
    ``steps_per_epoch`` in ``config`` (JAX :1068-1075)."""
    x, y, _ = wilds_data.load_wilds(task, "train", subsample=config["subsample"], fold=config.get("fold"))
    xt, yt, mt = wilds_data.load_wilds(task, "test", subsample=config["test_subsample"], fold=config.get("fold"))
    config["dataset_size"] = x.shape[0]
    config["steps_per_epoch"] = max(1, x.shape[0] // config["batch_size"])
    return x, y, xt, yt, mt


def _build_for(task: str, config: dict, device) -> BuiltExperiment:
    return build(task, config, torch.Generator().manual_seed(config["seed"]), config["steps_per_epoch"],
                 device=device)


def _fit_laplace(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray) -> None:
    """``built``'s trained MAP state (or MAP ensemble) replaced by its
    last-layer Laplace posterior (``Dense_1``), fitted on ``(x, y)`` with
    ``ll_hessian`` (JAX :1055-1063); with ``members`` > 1 a
    ``deep_ensemble`` over the fitted members."""
    lap = laplace_method(built.model, hessian=config["ll_hessian"], regression=False, inner=built.method)
    built.state = lap.fit(built.state, _to_device(built, x, y))
    members = config.get("members", 1)
    built.method = deep_ensemble(lap, members) if members > 1 else lap


def _rebuild(task: str, config: dict, device=None):
    """A run's experiment built afresh, untrained, with its splits."""
    config = {**DEFAULT_CONFIG, **config}
    _not_ported(task, config)
    device = resolve_device(device)
    x, y, xt, yt, mt = _load_task_data(task, config)
    return config, _build_for(task, config, device), (x, y), (xt, yt, mt)


def run_single(task: str, config: dict, log=None, device=None) -> dict:
    """Train, then evaluate on the test split; returns the metric dict. With
    ``checkpoint_dir`` the trained state is saved there as
    ``{model}_final``; ``laplace`` fits its posterior on the training split
    after the save; ``eval_while_train`` evaluates the val split every
    ``eval_interval`` epochs."""
    config, built, (x, y), (xt, yt, mt) = _rebuild(task, config, device)
    epoch_callback = None
    if config.get("eval_while_train"):
        xv, yv, mv = wilds_data.load_wilds(task, "val", subsample=config["test_subsample"], fold=config.get("fold"))
        interval = config.get("eval_interval", 1)

        def epoch_callback(epoch, b):
            if epoch % interval == 0:
                val = eval_task(b, task, config, xv, yv, mv)
                if log:
                    log(f"  val@{epoch}: " + ", ".join(f"{k}={v:.4f}" for k, v in val.items() if isinstance(v, float)))

    built = train(built, config, x, y, log=log, epoch_callback=epoch_callback)
    if config.get("checkpoint_dir"):
        ckpt.save_final(config["checkpoint_dir"], config["model"], built.state)
    if config["model"] == "laplace":
        _fit_laplace(built, config, x, y)
    return eval_task(built, task, config, xt, yt, mt)


def fit_laplace_phase(task: str, config: dict, run_dir: str, log=None, device=None) -> dict:
    """Post-hoc Laplace on a saved ``{from_model}_final`` (``from_model``
    defaults to ``map``; JAX :1078-1100, the reference's per-task
    ``fit_laplace.py``): restored into a fresh build, fitted on the training
    split, evaluated on the test split."""
    config = {**config, "model": config.get("from_model", "map")}
    config, built, (x, y), test = _rebuild(task, config, device)
    built.state = ckpt.restore_final(run_dir, config["model"], built.state)
    _fit_laplace(built, config, x, y)
    if log:
        first = built.state.members[0] if isinstance(built.state, EnsembleState) else built.state
        log(f"fit_laplace: prior_prec={float(first.prior_prec):.4g}")
    return eval_task(built, task, config, *test)


def eval_only_phase(task: str, config: dict, run_dir: str, log=None, device=None) -> dict:
    """Re-evaluate a saved ``{model}_final`` without training (JAX
    :1103-1115, reference camelyon/eval_only.py and the ``eval_only`` flag,
    amazon.py:86). A ``laplace`` run's final state is its MAP state, saved
    before the fit, so it is evaluated as MAP."""
    config, built, _, test = _rebuild(task, config, device)
    built.state = ckpt.restore_final(run_dir, config["model"], built.state)
    if log:
        log(f"eval_only: restored {config['model']}_final from {run_dir}")
    return eval_task(built, task, config, *test)


def sweep_drop_rates_phase(task: str, config: dict, run_dir: str, rates=(0.05, 0.1, 0.2, 0.3, 0.5), log=None,
                           device=None) -> dict:
    """A saved MC-Dropout state evaluated under each dropout rate (JAX
    :1118-1145, reference civilcomments/test_drop_rates.py:33-51): dropout
    has no parameters, so the state is restored into a model rebuilt at
    each rate. Returns ``{"p=<rate>": metrics}``."""
    config = {**config, "model": "mcd"}
    results = {}
    for rate in rates:
        rate_config, built, _, test = _rebuild(task, {**config, "dropout_p": float(rate)}, device)
        built.state = ckpt.restore_final(run_dir, "mcd", built.state)
        res = eval_task(built, task, rate_config, *test)
        results[f"p={rate}"] = res
        if log:
            log(f"drop rate {rate}: acc={res.get('accuracy', float('nan')):.4f} "
                f"ece={res.get('ece', float('nan')):.4f}")
    return results


def multix_phase(task: str, config: dict, run_dirs, leave_out: Optional[int] = None, log=None, device=None) -> dict:
    """Multi-X from independently trained ``{model}_final`` states, one per
    run directory, ``leave_out`` (an index into ``run_dirs``) left out (JAX
    :1148-1167, reference civilcomments/eval_ensembles.py:34-48)."""
    config, built, _, test = _rebuild(task, config, device)
    states = phases.load_members(run_dirs, config["model"], lambda: _build_for(task, config, built.device).state)
    built.method, built.state = phases.multix_from_checkpoints(built.method, states, leave_out=leave_out)
    if log:
        log(f"multix: {len(run_dirs)} members, leave_out={leave_out}")
    return eval_task(built, task, config, *test)
