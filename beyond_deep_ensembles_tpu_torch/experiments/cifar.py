"""CIFAR-10 experiment: ResNet-20-FRN-swish under BBB or SVGD.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/cifar.py`` (reference
experiments/cifar/{cifar.py,models.py,cifar.yaml}): SGD (momentum 0.9,
nesterov) under the Wilson schedule stepped per epoch, crop + flip
augmentation inside the loss, 50 posterior samples at eval. Ported: the
``bbb`` variant and the ``svgd`` variant (``svgd_particles`` plain
ResNet-20s), each with one member; the others raise. No checkpointing, HMC
baseline or corrupted splits yet.

Entry points run on CUDA unless ``device="cpu"`` is passed. The data sets
move to the device once, as NCHW float32; each step gathers its batch there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import cifar as cifar_data
from ..evals.classification import EvalResult, analyze_output, bayesian_model_average
from ..methods.api import GaussianPrior, LossOutput, PosteriorMethod
from ..methods.bbb import bbb_method
from ..methods.ensemble import predict
from ..methods.svgd import svgd_method
from ..models.resnet import ResNet20
from ..nn.base import Model
from ..nn.gaussian import NoiseSource
from ..utils.device import resolve_device
from ..utils.schedules import wilson_schedule

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
    # the bbb and svgd variants' knobs (cifar.yaml defaults); the other
    # methods' keys come with their ports
    "prior_std": 1.0,
    "bbb_mc_samples": 2,
    "kl_rescaling": 0.2,
    "svgd_particles": 5,
    "svgd_reg_scale": 0.0003,
    "swag_lr": 0.0005,  # the Wilson schedule's final lr
    "dataset_size": 50_000,
}


def _xent_loss_fn(model: Model, augment: bool = True):
    def loss_fn(params, model_state, noise, batch):
        x, y = batch
        if augment:
            x = cifar_data.augment(x, generator=noise.generator)
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


def _base_tx(config, steps_per_epoch: int):
    """SGD (optax ``add_decayed_weights`` then ``sgd``: torch's
    ``weight_decay`` adds ``wd * p`` to the gradient before momentum, as
    optax does) with lr ``lr * factor(step // steps_per_epoch)``."""
    lr = config["lr"]

    def tx(params):
        optimizer = torch.optim.SGD(
            params, lr=lr, momentum=config["momentum"], nesterov=config["nesterov"],
            weight_decay=config.get("weight_decay", 0.0),
        )
        if not config.get("lr_schedule", True):
            return optimizer, None
        factor = wilson_schedule(config["epochs"], lr, config.get("swag_lr"))
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda step: factor(step // steps_per_epoch)
        )
        return optimizer, scheduler

    return tx


@dataclasses.dataclass
class BuiltExperiment:
    model: Model
    method: PosteriorMethod
    state: object
    apply_fn: Callable
    device: torch.device


def _resnet(config, generator: torch.Generator, conv_kind: str) -> ResNet20:
    if config.get("bf16"):
        raise NotImplementedError("bf16 compute: not ported yet")
    return ResNet20(classes=10, activation="swish", norm="frn", conv_kind=conv_kind, generator=generator)


def _not_ported(config: dict) -> None:
    if config["model"] not in ("bbb", "svgd"):
        raise NotImplementedError(f"model {config['model']!r}: not ported yet")
    if config.get("members", 1) != 1:
        raise NotImplementedError("members > 1: not ported yet")
    for key in ("corrupted_intensities", "use_hmc_baseline", "checkpoint_dir"):
        if config.get(key):
            raise NotImplementedError(f"{key}: not ported yet")


def build(
    config: dict,
    generator: torch.Generator,
    steps_per_epoch: int = 390,
    device=None,
) -> BuiltExperiment:
    """The model (initialized from ``generator``) and its method state. SVGD
    initializes its ``svgd_particles`` particles from ``generator`` in turn."""
    device = resolve_device(device)
    _not_ported(config)
    augment = config.get("augment", True)
    tx = _base_tx(config, steps_per_epoch)
    if config["model"] == "svgd":
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
    else:
        model = Model(_resnet(config, generator, "bbb").to(device))
        method = bbb_method(
            _xent_loss_fn(model, augment=augment),
            tx,
            GaussianPrior(0.0, config["prior_std"]),
            dataset_size=config["dataset_size"],
            mc_samples=config["bbb_mc_samples"],
            kl_rescaling=config["kl_rescaling"],
        )
        state = method.init(model.module, {})
    return BuiltExperiment(model, method, state, _predict_fn(model), device)


def _to_device(built: BuiltExperiment, x: np.ndarray, y: np.ndarray):
    xd = torch.from_numpy(np.ascontiguousarray(x)).to(built.device).permute(0, 3, 1, 2).contiguous()
    return xd, torch.from_numpy(np.asarray(y, np.int64)).to(built.device)


def train(
    built: BuiltExperiment,
    config: dict,
    x: np.ndarray,
    y: np.ndarray,
    log: Optional[Callable[[str], None]] = None,
) -> BuiltExperiment:
    """Epoch loop, one update per minibatch (reference cifar.py:131-186).
    Each epoch walks ``shuffled_indices(n, seed * 1_000_003 + epoch)`` and
    drops the last partial batch; the noise (and augmentation) stream is
    seeded by ``config["seed"]``."""
    method, state = built.method, built.state
    xd, yd = _to_device(built, x, y)
    noise = NoiseSource.seeded(config["seed"])
    bs = config["batch_size"]
    n = xd.shape[0]
    for epoch in range(config["epochs"]):
        order = torch.from_numpy(
            cifar_data.shuffled_indices(n, config["seed"] * 1_000_003 + epoch)
        ).to(built.device)
        losses = []
        for step in range(n // bs):
            idx = order[step * bs : (step + 1) * bs]
            state, metrics = method.update(state, noise, (xd[idx], yd[idx]))
            losses.append(metrics["loss"])
        epoch_loss = float(torch.mean(torch.stack(losses)))
        if not math.isfinite(epoch_loss):
            raise RuntimeError("Diverged")  # reference poverty.py:137-141
        state = method.finalize_epoch(state)
        if log:
            log(f"epoch {epoch}: loss {epoch_loss:.4f}")
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
    cifar.py:26-69): S samples -> log-space BMA -> EvalResult. The last
    partial batch is padded with copies of its last image and trimmed, so
    every point counts once."""
    method, state = built.method, built.state
    bs = config["eval_batch_size"]
    xd, yd = _to_device(built, x, y)
    noise = NoiseSource.seeded(seed)
    outs = []
    with torch.no_grad():
        for start in range(0, xd.shape[0], bs):
            xb = xd[start : start + bs]
            valid = xb.shape[0]
            if valid < bs:
                xb = torch.cat([xb, xb[-1:].expand(bs - valid, *xb.shape[1:])])
            log_probs = predict(
                method, state, built.apply_fn, xb, n_samples=config["eval_samples"], noise=noise
            )
            outs.append(bayesian_model_average(log_probs)[:valid])
    correct, conf, ll, _, _ = analyze_output(torch.cat(outs), yd)
    return EvalResult.create(correct, conf, ll, bin_count=config["ece_bins"])


def run_single(config: dict, log=None, device=None) -> dict:
    """Train + eval on the clean test split; returns the metric dict."""
    config = {**DEFAULT_CONFIG, **config}
    _not_ported(config)
    device = resolve_device(device)
    x_train, y_train = cifar_data.load_cifar10(True, subsample=config["subsample"])
    x_test, y_test = cifar_data.load_cifar10(False, subsample=config["test_subsample"])
    config["dataset_size"] = x_train.shape[0]
    steps_per_epoch = max(1, x_train.shape[0] // config["batch_size"])
    generator = torch.Generator().manual_seed(config["seed"])
    built = build(config, generator, steps_per_epoch, device=device)
    built = train(built, config, x_train, y_train, log=log)
    return {"test": eval_model(built, config, x_test, y_test).as_dict()}
