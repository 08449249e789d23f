"""WILDS experiment runner: the DistilBERT text task Amazon under MAP and
full-model MC-Dropout.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/wilds_task.py``
(reference experiments/amazon/{amazon.py,models.py,amazon.yaml}). Ported:
``build`` -> ``train`` -> ``eval_task`` / ``run_single`` for
``task="amazon"`` with ``model`` ``map`` or ``mcd`` (``dropout_p`` on the
head; every encoder dropout and the attention dropout then sample at eval
too), one member, from random weights made from the caller's generator.
The optimizer is the JAX package's ``_tx``: weight decay added to the
gradient, then Adam or SGD with momentum, at a constant rate.

Not ported yet, each raising ``NotImplementedError``: the image tasks,
CivilComments (its L = 300 needs a ragged last key tile in K3), the other
methods, ``members > 1``, last-layer-only MC-Dropout (``last_layer_mcd``), pretrained DistilBERT weights (``load_hf_weights``
waits until the files are in the repository), the ``exponential`` and
``cosine_warmup`` schedules, bf16 compute, remat, checkpoints, the
device-resident epoch and data parallelism.

Entry points run on CUDA unless ``device="cpu"`` is passed. The data sets move
to the device once; each step gathers its batch there, in the order of the
JAX package's native loader (``data/native_loader.py``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data import wilds as wilds_data
from ..data.native_loader import shuffled_indices
from ..data.uci import data_dir
from ..evals.classification import EvalResult, analyze_output, bayesian_model_average
from ..methods.api import LossOutput, PosteriorMethod
from ..methods.ensemble import predict
from ..methods.map import map_method
from ..models.bert import TINY_CONFIG, BertClassifier, DistilBertConfig
from ..nn.base import Model
from ..nn.gaussian import NoiseSource
from ..utils.device import resolve_device

# the keys the map and mcd variants read (the JAX DEFAULT_CONFIG's values);
# the other methods' keys come with their ports
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
    "tiny": False,  # TINY_CONFIG's DistilBERT, for tests
}


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
    if task != "amazon":
        raise NotImplementedError(f"task {task!r}: not ported yet (amazon is)")
    if config["model"] not in ("map", "mcd"):
        raise NotImplementedError(f"model {config['model']!r}: not ported yet")
    if config.get("members", 1) != 1:
        raise NotImplementedError("members > 1: not ported yet")
    if config.get("compute_dtype", "fp32") not in ("fp32", "float32"):
        raise NotImplementedError("bf16 compute: not ported yet")
    if config.get("lr_schedule_kind", "none") != "none":
        raise NotImplementedError(f"lr schedule {config['lr_schedule_kind']!r}: not ported yet")
    for key in ("checkpoint_dir", "data_parallel", "device_data", "eval_while_train", "last_layer_mcd"):
        if config.get(key):
            raise NotImplementedError(f"{key}: not ported yet")
    if config.get("scan_steps", 1) > 1:
        raise NotImplementedError("scan_steps: not ported yet")
    pretrained = config.get("pretrained_path") or (
        config.get("pretrained", True)
        and os.path.exists(os.path.join(data_dir(), "distilbert-base-uncased", "pytorch_model.bin"))
    )
    if pretrained:
        raise NotImplementedError("pretrained DistilBERT weights (load_hf_weights): not ported yet")


def _make_backbone(task: str, config: dict, generator: torch.Generator, dropout_p=None) -> Model:
    """The text tasks' DistilBERT classifier: the ``map`` head, or with
    ``dropout_p`` the MC-Dropout ``drop`` head, whose encoder dropouts sample
    at eval too (reference amazon/models.py:67-73)."""
    head = "map" if dropout_p is None else "drop"
    return Model(BertClassifier(
        classes=wilds_data.TASKS[task].classes,
        head_kind=head,
        drop_p=dropout_p or 0.2,
        config=_bert_config(config),
        mc_encoder_dropout=head == "drop",
        generator=generator,
    ))


def _loss_fn_for(model: Model):
    def loss_fn(params, model_state, noise, batch):
        x, y = batch
        out, kl, new_state = model.apply(params, model_state, noise, x, train=True)
        logp = F.log_softmax(out, dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
        acc = torch.mean((torch.argmax(out, dim=-1) == y).float())
        return LossOutput(loss=loss, kl=kl, model_state=new_state, metrics={"acc": acc})

    return loss_fn


def _predict_fn(model: Model):
    def apply_fn(params, model_state, noise, x):
        out, _, _ = model.apply(params, model_state, noise, x, train=False)
        return F.log_softmax(out, dim=-1)

    return apply_fn


def _tx(config: dict):
    """optax ``add_decayed_weights`` then ``adam`` (or ``sgd`` with momentum):
    torch's ``weight_decay`` adds ``wd * p`` to the gradient before the
    moments, so this is torch ``Adam``, not ``AdamW``; Adam's defaults
    (betas 0.9, 0.999, eps 1e-8) are optax's. ``train_all_layers: false``
    freezes the encoder in ``build`` (no gradient, so no step and no decay,
    as optax's ``set_to_zero`` leaves it)."""
    lr, wd = config["lr"], config.get("weight_decay", 0.0)

    def tx(params):
        if config.get("optimizer_kind", "sgd") == "adam":
            return torch.optim.Adam(params, lr=lr, weight_decay=wd), None
        return torch.optim.SGD(params, lr=lr, momentum=config.get("momentum", 0.9), weight_decay=wd), None

    return tx


@dataclasses.dataclass
class BuiltExperiment:
    model: Model
    method: PosteriorMethod
    state: object
    apply_fn: Callable
    device: torch.device


def build(task: str, config: dict, generator: torch.Generator, device=None) -> BuiltExperiment:
    """The model (initialized from ``generator``) and its method state. The
    JAX ``build``'s ``steps_per_epoch`` feeds schedules and methods not
    ported yet, so it has no counterpart here."""
    device = resolve_device(device)
    _not_ported(task, config)
    dropout_p = config["dropout_p"] if config["model"] == "mcd" else None
    model = _make_backbone(task, config, generator, dropout_p)
    model.module.to(device)
    if not config.get("train_all_layers", True):
        model.module.bert.requires_grad_(False)  # reference civilcomments/models.py:165-176
    method = map_method(_loss_fn_for(model), _tx(config))
    state = method.init(model.module, {})
    return BuiltExperiment(model, method, state, _predict_fn(model), device)


def train(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray,
          log: Optional[Callable[[str], None]] = None) -> BuiltExperiment:
    """Epoch loop, one update per minibatch, the last partial batch dropped.
    Epoch e walks ``shuffled_indices(n, seed * 1_000_003 + e)``, the JAX
    package's ``PrefetchLoader`` order; dropout draws from a
    ``NoiseSource`` seeded by ``config["seed"]``."""
    method, state = built.method, built.state
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(built.device)
    yd = torch.from_numpy(np.asarray(y, np.int64)).to(built.device)
    noise = NoiseSource.seeded(config["seed"])
    bs, n = config["batch_size"], xd.shape[0]
    for epoch in range(config["epochs"]):
        order = torch.from_numpy(shuffled_indices(n, config["seed"] * 1_000_003 + epoch)).to(built.device)
        losses = []
        for step in range(n // bs):
            idx = order[step * bs : (step + 1) * bs]
            state, metrics = method.update(state, noise, (xd[idx], yd[idx]))
            losses.append(metrics["loss"])
        epoch_loss = float(torch.mean(torch.stack(losses)))
        if not math.isfinite(epoch_loss):
            raise RuntimeError("Diverged")  # reference civil.py:156-160
        state = method.finalize_epoch(state)
        if log:
            log(f"epoch {epoch}: loss {epoch_loss:.4f}")
    built.state = state
    return built


def eval_task(built: BuiltExperiment, task: str, config: dict, x: np.ndarray, y: np.ndarray,
              meta: np.ndarray, seed: int = 42) -> dict:
    """Posterior-predictive eval and the task's official WILDS metrics. The
    last partial batch is padded with copies of its last example and
    trimmed, so every example counts once; each batch's S forwards draw
    fresh dropout. Then the log-space model average, ``analyze_output``,
    ``EvalResult`` and ``evaluate_task``."""
    bs = config["eval_batch_size"]
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(built.device)
    noise = NoiseSource.seeded(seed)
    outs = []
    with torch.no_grad():
        for start in range(0, xd.shape[0], bs):
            xb = xd[start : start + bs]
            valid = xb.shape[0]
            if valid < bs:
                xb = torch.cat([xb, xb[-1:].expand(bs - valid, *xb.shape[1:])])
            samples = predict(
                built.method, built.state, built.apply_fn, xb, n_samples=config["eval_samples"], noise=noise
            )
            outs.append(samples[:, :valid])
        log_marginal = bayesian_model_average(torch.cat(outs, dim=1))
        targets = torch.from_numpy(np.asarray(y, np.int64)).to(built.device)
        correct, conf, ll, _, _ = analyze_output(log_marginal, targets)
        result = EvalResult.create(correct, conf, ll, bin_count=config["ece_bins"])
    preds = log_marginal.argmax(dim=1).cpu().numpy()
    official = wilds_data.evaluate_task(task, preds, np.asarray(y), meta[: len(preds)])
    return {**result.as_dict(), **official}


def _load_task_data(task: str, config: dict):
    x, y, _ = wilds_data.load_wilds(task, "train", subsample=config["subsample"], fold=config.get("fold"))
    xt, yt, mt = wilds_data.load_wilds(task, "test", subsample=config["test_subsample"], fold=config.get("fold"))
    return x, y, xt, yt, mt


def run_single(task: str, config: dict, log=None, device=None) -> dict:
    """Train, then evaluate on the test split; returns the metric dict."""
    config = {**DEFAULT_CONFIG, **config}
    _not_ported(task, config)
    device = resolve_device(device)
    x, y, xt, yt, mt = _load_task_data(task, config)
    built = build(task, config, torch.Generator().manual_seed(config["seed"]), device=device)
    built = train(built, config, x, y, log=log)
    return eval_task(built, task, config, xt, yt, mt)
