"""WILDS experiment runner: the DistilBERT text tasks, Amazon and
CivilComments, the DenseNet-121 image tasks, Camelyon17 and FMoW, the
ResNet-50 image tasks, iWildCam and RxRx1, and PovertyMap's ResNet-18
regression, under every method of
``configs/{amazon,civilcomments,camelyon,fmow,iwildcam,rxrx1,poverty}.yaml``.

Counterpart of ``beyond_deep_ensembles_tpu/experiments/wilds_task.py``
(reference experiments/{amazon,civilcomments,camelyon,fmow,iwildcam,rxrx1,
poverty}/{*.py,models.py,*.yaml}), for ``task`` ``amazon`` (L = 512, 5 classes, the
10th-percentile user accuracy), ``civilcomments`` (L = 300, 2 classes, the
worst-group accuracy), ``camelyon17`` (96x96, 2 classes, a from-scratch
DenseNet-121 under SGD with momentum, BBB and Rank-1 variational throughout,
frozen dropout masks at eval), ``fmow`` (224x224, 62 classes, the
worst-region accuracy, Adam under the ``exponential`` schedule),
``iwildcam`` (448x448, 182 classes, macro-F1, Adam at a constant rate) and
``rxrx1`` (256x256, 1139 classes, Adam under ``cosine_warmup``, the linear
warmup and cosine decay stepped per batch) and ``poverty`` (224x224x8, one
Gaussian output per image from a from-scratch ResNet-18 under GaussLayer,
the NLL loss, ``RegressionResults`` and the worst urban/rural Pearson r,
one fold of five per run); on fmow, iwildcam and rxrx1 BBB
and Rank-1 sit on the head only unless ``all_layers_bbb``. Ported: ``build``
-> ``train`` -> ``eval_task`` / ``run_single`` with ``model`` ``map``,
``mcd`` (``dropout_p``; ``last_layer_mcd`` keeps the encoder's dropouts off
at eval), ``swag``, ``bbb``, ``rank1``, ``svgd``, ``ivon``, ``sngp`` (a
spectral DenseNet or ResNet-50 under the SNGP head for the images),
``laplace`` (``ll_hessian``) and the last-layer ``swag_ll``, ``ll_bbb``,
``ll_ivon`` and ``ll_svgd`` (``methods/last_layer.py``; the text head is both
dense layers, the image head the backbone's ``Dense_0``), each with
``members`` > 1 as a ``deep_ensemble`` (``svgd`` with one: its particles are
its ensemble); ``ring_dtype``; DenseNet's ``conv_remat``,
``densenet_incremental_bn`` and ``densenet_concat_mode``; DistilBERT's
``bert_remat``; ResNet-50's ``torchvision_arch``; the staged weights the
JAX package loads, ``$BDE_DATA_DIR/pretrained/resnet50.pth`` (iwildcam,
rxrx1; ``torchvision_arch`` then defaults on) and ``densenet121.pth``
(fmow) through ``models/torch_convert.py``, and
``$BDE_DATA_DIR/distilbert-base-uncased/pytorch_model.bin`` (the text
tasks) through ``models/bert.py::load_hf_weights``; the
``exponential`` and ``cosine_warmup`` schedules (Adam's, SGD's and iVON's lr
from the device count); periodic checkpoints with auto-resume and the
``{model}_final`` artifact (``checkpoint_dir``, ``checkpoint_interval``); the
device-resident epoch (``device_data``), K steps per call (``scan_steps``)
and the device-resident eval (``device_eval``), whose runners replay CUDA
graphs on a card (``parallel/multistep.py``); ``eval_while_train``; and the
phases ``fit_laplace_phase``, ``eval_only_phase``, ``sweep_drop_rates_phase``
and ``multix_phase``. The optimizer is the JAX package's ``_tx``: weight
decay added to the gradient, then Adam or SGD with momentum (the port's
``utils/optim.py``, whose state lives on the device, so a CUDA graph can
capture a step). Every path draws its noise in key mode from
``keys.fold_in`` of the seed: per step, per epoch, per eval batch.
``data_parallel`` and ``ring_shard`` are no-ops on one device, as in JAX,
and raise with more than one visible card (ROADMAP item 18).

Not ported yet, each raising ``NotImplementedError``: bf16 compute (ROADMAP
item 13), ResNet-50 remat, the DenseNet's running-statistics BatchNorm
(``static_bn: false``) and the benchmark knob ``no_norm``. ``model: sngp``
on poverty raises too: the JAX package's own run fails there (its SNGP
head's one output meets the regression eval), so there is no reference.

Entry points run on CUDA unless ``device="cpu"`` is passed. The text data
sets move to the device once and each step gathers its batch there; an image
train set stays on the host (a staged camelyon17 train set is about 33 GB
in fp32) and each step
moves its batch, in the order of the JAX package's native loader
(``data/native_loader.py``) either way. Image arrays are NCHW
(:func:`task_images`; the loaders give NHWC).
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
from ..evals.regression import RegressionResults, nll_loss
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
from ..models.bert import TINY_CONFIG, BertClassifier, BertSNGP, DistilBertConfig, load_hf_weights
from ..models.densenet import DenseNetClassifier, DenseNetSNGP
from ..models.resnet import ResNet18, ResNet50, ResNet50SNGP
from ..models.torch_convert import load_torch_backbone
from ..nn.base import Model, add_auto_named
from ..nn.gauss import GaussLayer
from ..nn.gaussian import NoiseSource
from ..parallel.multistep import make_epoch_runner, make_eval_runner, make_multi_step, stack_batches
from ..utils import checkpoint as ckpt
from ..utils.device import refuse_multi_device, resolve_device
from ..utils.optim import SGD, Adam
from ..utils.schedules import cosine_with_warmup, exponential_schedule
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

# the Laplace fit's batch (the JAX ``laplace_method`` default): under static
# BN the batches decide the statistics, so both engines cut the same ones
LAPLACE_BATCH = 256
TEXT_TASKS = ("amazon", "civilcomments")
DENSENET_TASKS = ("camelyon17", "fmow")
RESNET50_TASKS = ("iwildcam", "rxrx1")
IMAGE_TASKS = DENSENET_TASKS + RESNET50_TASKS + ("poverty",)
# the pretrained-backbone tasks put BBB and Rank-1 on the head of a plain net
# (JAX :453-483; reference iwildcam/models.py:101-114, rxrx1/models.py:82-92,
# fmow/models.py:92-102) unless all_layers_bbb (BBB only)
HEAD_ONLY_TASKS = ("iwildcam", "rxrx1", "fmow")
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
    if config["model"] not in MODELS:
        raise ValueError(f"unknown model {config['model']!r}")
    if task == "poverty" and config["model"] == "sngp":
        # no configs/poverty.yaml row asks for it
        raise NotImplementedError(
            "model 'sngp' on poverty: the JAX package's own run fails there (its SNGP head's single output "
            "meets the regression eval, which wants GaussLayer's (mean, std) pair: \"TypeError: sub got "
            "incompatible shapes for broadcasting: (8, 1), (2, 8)\"), so it has no reference to port")
    if config["model"] == "svgd" and config.get("members", 1) != 1:
        # the JAX build ignores members for svgd; the port refuses
        raise NotImplementedError("members > 1 with svgd (an ensemble of particle sets): not ported yet")
    if config.get("compute_dtype", "fp32") not in ("fp32", "float32"):
        raise NotImplementedError("bf16 compute: not ported yet (ROADMAP item 13)")
    if config.get("lr_schedule_kind", "none") not in ("none", "exponential", "cosine_warmup"):
        raise ValueError(f"unknown lr_schedule_kind {config['lr_schedule_kind']!r}")
    refuse_multi_device(config)


def _pretrained_path(task: str, config: dict):
    """Where the JAX package loads pretrained weights from (JAX
    ``_pretrained_path``, :337-363): ``pretrained_path``, else, unless
    ``pretrained: false``, iwildcam's and rxrx1's
    ``$BDE_DATA_DIR/pretrained/resnet50.pth``, fmow's
    ``$BDE_DATA_DIR/pretrained/densenet121.pth`` or, for the text tasks,
    the directory ``$BDE_DATA_DIR/distilbert-base-uncased`` where it holds
    ``pytorch_model.bin``, each where the file exists. camelyon17 and
    poverty train from scratch."""
    if config.get("pretrained_path"):
        return config["pretrained_path"]
    if not config.get("pretrained", True):
        return None
    if task in TEXT_TASKS:
        path = os.path.join(data_dir(), "distilbert-base-uncased")
        return path if os.path.exists(os.path.join(path, "pytorch_model.bin")) else None
    name = {"iwildcam": "resnet50.pth", "rxrx1": "resnet50.pth", "fmow": "densenet121.pth"}.get(task)
    if name is None:
        return None
    path = os.path.join(data_dir(), "pretrained", name)
    return path if os.path.exists(path) else None


def _load_pretrained(task: str, module: nn.Module, path: str) -> None:
    """``module`` filled in place from ``path`` (JAX ``_load_pretrained``,
    :366-373): a text task's encoder from the HuggingFace checkpoint in the
    directory ``path`` (``models/bert.py::load_hf_weights``), an image
    backbone from a torchvision-layout state dict
    (``models/torch_convert.py::load_torch_backbone``)."""
    if task in TEXT_TASKS:
        load_hf_weights(module, path)
    else:
        load_torch_backbone(path, module)


def task_images(task: str, config: dict, x: np.ndarray) -> np.ndarray:
    """A loader's array as the port's model takes it: an image task's NHWC
    float array as NCHW, cut to 32x32 under ``tiny`` (JAX :393,1035,1072);
    a text task's as it is."""
    if task not in IMAGE_TASKS:
        return x
    if config.get("tiny"):
        x = x[:, :32, :32, :]
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def _densenet_kwargs(task: str, config: dict) -> dict:
    """DenseNet-121 (growth 32, blocks (6, 12, 24, 16), 64 initial features,
    bn_size 4), or under ``tiny`` growth 4, blocks (2, 2), 8 and 2 (JAX
    :128-161)."""
    tiny = config.get("tiny", False)
    return dict(
        growth_rate=4 if tiny else 32,
        block_config=(2, 2) if tiny else (6, 12, 24, 16),
        init_features=8 if tiny else 64,
        bn_size=2 if tiny else 4,
        track_running_stats=not config.get("static_bn", True),
        norm_off=config.get("no_norm", False),
    )


def _resnet50_stages(config: dict):
    """ResNet-50's (3, 4, 6, 3), or (1, 1) under ``tiny`` (JAX :176)."""
    return (1, 1) if config.get("tiny", False) else (3, 4, 6, 3)


class PovertyNet(nn.Module):
    """PovertyMap's regression net (JAX ``_make_backbone``'s ``PovertyNet``,
    :187-207; reference poverty/models.py:47): a ``ResNet18_0`` of one
    output on 8 channels, ``batch_static`` norms, layers of ``kind``, under
    ``GaussLayer_0(init_std, learn_var)``, whose ``rho__mle`` the SVGD,
    iVON, SWAG and BBB methods leave out of their posteriors.
    ``forward(x, noise, train, component)`` -> ``[B, 1, 2]`` (mean,
    std)."""

    def __init__(self, kind: str, components: int, dropout_p, init_std: float, learn_var: bool, *,
                 generator: torch.Generator):
        super().__init__()
        net = add_auto_named(self, ResNet18(1, norm="batch_static", conv_kind=kind, components=components,
                                            dropout_p=dropout_p, generator=generator))
        gauss = add_auto_named(self, GaussLayer(std_init=init_std, learn_var=learn_var))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._layers = (net, gauss)

    def forward(self, x, noise, train: bool = True, component=None):
        net, gauss = self._layers
        return gauss(net(x, noise, train=train, component=component), noise, train=train)


def _make_backbone(task: str, config: dict, generator: torch.Generator, kind: str = "plain",
                   head_kind: Optional[str] = None, dropout_p=None) -> nn.Module:
    """The task's classifier with layers of ``kind`` and a head of
    ``head_kind`` (default ``kind``; JAX ``_make_backbone``). Text: the
    DistilBERT classifier, its head ``map`` for plain layers, ``bbb`` or
    ``rank1`` (``rank1_components``), or with ``dropout_p`` the MC-Dropout
    ``drop`` head, whose encoder dropouts sample at eval too unless
    ``last_layer_mcd`` (reference amazon/models.py:67-73). Images: the
    DenseNet classifier (``dropout_freeze_eval`` on camelyon17 only,
    ``remat`` from ``conv_remat``), or ResNet-50 for iwildcam and rxrx1
    (``batch_static`` norms under ``static_bn``, else FRN; the torchvision
    topology under ``torchvision_arch``; rescaled per-example dropout at
    eval, reference iwildcam/models.py:75; JAX :162-186), or poverty's
    :class:`PovertyNet` (layers of ``kind`` throughout, ``head_kind``
    unused, as in JAX)."""
    components = config.get("rank1_components", 1)
    classes = wilds_data.TASKS[task].classes
    if task == "poverty":
        return PovertyNet(kind, components, dropout_p, config.get("init_std", 0.1), config.get("learn_var", True),
                          generator=generator)
    if task in RESNET50_TASKS:
        return ResNet50(
            classes,
            norm="none" if config.get("no_norm") else "batch_static" if config.get("static_bn", True) else "frn",
            conv_kind=kind,
            head_kind=head_kind,
            components=components,
            dropout_p=dropout_p,
            stage_sizes=_resnet50_stages(config),
            torchvision=config.get("torchvision_arch", False),
            dropout_freeze_eval=False,
            remat=config.get("conv_remat", "none"),
            generator=generator,
        )
    if task in DENSENET_TASKS:
        return DenseNetClassifier(
            classes,
            head_kind=head_kind or kind,
            conv_kind=kind,
            components=components,
            dropout_p=dropout_p,
            dropout_freeze_eval=task == "camelyon17",
            remat=config.get("conv_remat", "none"),
            incremental_bn=config.get("densenet_incremental_bn", True),
            concat_mode=config.get("densenet_concat_mode", "concat"),
            generator=generator,
            **_densenet_kwargs(task, config),
        )
    head = "drop" if dropout_p is not None else {"bbb": "bbb", "rank1": "rank1"}.get(head_kind or kind, "map")
    return BertClassifier(
        classes=classes,
        head_kind=head,
        drop_p=dropout_p or 0.2,
        components=components,
        config=_bert_config(config),
        mc_encoder_dropout=head == "drop" and not config.get("last_layer_mcd", False),
        generator=generator,
    )


def _make_sngp(task: str, config: dict, generator: torch.Generator) -> nn.Module:
    """The SNGP model (JAX ``_make_sngp``): DistilBERT, a spectral DenseNet
    or a spectral ResNet-50 (its default ``batch_static`` norms whatever
    ``static_bn`` says, never the torchvision topology, JAX :585-620) under
    the SNGP head."""
    classes = wilds_data.TASKS[task].classes
    if task in RESNET50_TASKS:
        return ResNet50SNGP(classes, config["sngp"], generator=generator, stage_sizes=_resnet50_stages(config))
    if task in DENSENET_TASKS:
        return DenseNetSNGP(classes, config["sngp"], generator=generator, **_densenet_kwargs(task, config))
    return BertSNGP(classes, _bert_config(config), config["sngp"], generator=generator)


def _loss_fn_for(model: Model, regression: bool):
    """The cross-entropy and its ``acc`` metric, or under ``regression`` the
    GaussLayer's ``nll_loss`` and no metric (JAX :231-245)."""

    def loss_fn(params, model_state, noise, batch, component=None):
        x, y = batch
        kwargs = {} if component is None else {"component": component}
        out, kl, new_state = model.apply(params, model_state, noise, x, train=True, **kwargs)
        if regression:
            return LossOutput(loss=nll_loss(out, y), kl=kl, model_state=new_state, metrics={})
        logp = F.log_softmax(out, dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
        acc = torch.mean((torch.argmax(out, dim=-1) == y).float())
        return LossOutput(loss=loss, kl=kl, model_state=new_state, metrics={"acc": acc})

    return loss_fn


def _predict_fn(model: Model, regression: bool):
    """``apply_fn(params, model_state, noise, x, **kwargs)``: log-probs of one
    forward at eval, or under ``regression`` the raw ``(mean, std)`` output
    (JAX :248-262); ``kwargs`` a Rank-1 model's joint ``component`` or an
    SNGP model's ``n_samples``."""

    def apply_fn(params, model_state, noise, x, **kwargs):
        out, _, _ = model.apply(params, model_state, noise, x, train=False, **kwargs)
        return out if regression else F.log_softmax(out, dim=-1)

    return apply_fn


def _scheduled_lr(config: dict, lr: float):
    """``lr`` under ``lr_schedule_kind`` as a function of an update count (a
    device tensor), or the constant ``lr`` (JAX ``_scheduled_lr``,
    :272-293): ``exponential``, the staircase decay by ``lr_decay_rate`` once
    an epoch, ``lr * factor(count // steps_per_epoch)``; ``cosine_warmup``,
    the linear warmup and cosine decay stepped per batch over ``total =
    steps_per_epoch * epochs`` updates, ``warmup_steps`` (default ``total //
    20``) of them warmup. One schedule drives every optimizer of a
    composition: the backbone's Adam or SGD and iVON's rate (the reference's
    fmow decays both, fmow.py:154-158)."""
    kind = config.get("lr_schedule_kind", "none")
    steps = config.get("steps_per_epoch", 1000)
    if kind == "exponential":
        factor = exponential_schedule(config.get("lr_decay_rate", 0.96))
        return lambda count: lr * factor(count // steps)
    if kind == "cosine_warmup":
        total = steps * config["epochs"]
        return cosine_with_warmup(lr, config.get("warmup_steps", total // 20), total)
    return lr


def _tx(config: dict):
    """optax ``add_decayed_weights`` then ``adam`` (or ``sgd`` with momentum)
    as the port's ``Adam`` and ``SGD`` (``utils/optim.py``): weight decay
    added to the gradient before the moments, so torch ``Adam``, not
    ``AdamW``; Adam's defaults (betas 0.9, 0.999, eps 1e-8) are optax's; the
    lr under :func:`_scheduled_lr`, computed on the device from the
    optimizer's count. ``train_all_layers: false`` freezes the encoder in
    ``build`` (no gradient, so no step and no decay, as optax's
    ``set_to_zero`` leaves it). Returns ``tx(params) -> (optimizer,
    None)``."""
    lr, wd = config["lr"], config.get("weight_decay", 0.0)
    scheduled = _scheduled_lr(config, lr)
    schedule = scheduled if callable(scheduled) else None

    def tx(params):
        if config.get("optimizer_kind", "sgd") == "adam":
            return Adam(params, lr, weight_decay=wd, schedule=schedule), None
        return SGD(params, lr, momentum=config.get("momentum", 0.9), weight_decay=wd, schedule=schedule), None

    return tx


def _ring_kwargs(config: dict) -> dict:
    """``ring_dtype: bf16`` stores SWAG's deviation ring in bfloat16 (JAX
    ``_ring_kwargs``); ``ring_shard`` is a no-op on one device and raises
    in ``_not_ported`` with more than one visible card."""
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
    task: str = ""
    regression: bool = False
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
    pre_path = _pretrained_path(task, config)
    if pre_path and task in RESNET50_TASKS:
        config.setdefault("torchvision_arch", True)
    name, members = config["model"], config.get("members", 1)
    regression = wilds_data.TASKS[task].classes == 1
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
            return lambda lf: ivon_method(lf, lr=_scheduled_lr(config, config["ivon_lr"]),
                                          prior_prec=config["ivon_prior_prec"],
                                          dataset_size=config["dataset_size"], mc_samples=config["ivon_mc_samples"],
                                          damping=config.get("ivon_damping", 0.0))
        if inner_name == "svgd":
            return lambda lf: svgd_method(lf, tx, particle_count=config["svgd_particles"],
                                          dataset_size=config["dataset_size"], l2_reg=config["svgd_reg_scale"])
        raise ValueError(inner_name)

    def made(module):
        """``module`` on the device, every member and particle from the
        pretrained backbone where there is one (JAX :529-537: heads and
        variational std leaves keep their init)."""
        if pre_path:
            _load_pretrained(task, module, pre_path)
        return module.to(device)

    def modules(make):
        return [made(make()) for _ in range(members)]

    if name == "svgd":
        particles = nn.ModuleList(made(_make_backbone(task, config, generator))
                                  for _ in range(config["svgd_particles"])).to(device)
        model = Model(particles[0])
        method = inner_factory_for("svgd")(_loss_fn_for(model, regression))
        state = method.init(particles, {})
        return BuiltExperiment(model, method, state, _predict_fn(model, regression), device, task, regression)

    if name == "sngp":
        made = modules(lambda: _make_sngp(task, config, generator))
    elif name in ("bbb", "rank1"):
        # the variational scope follows the reference per task (JAX
        # :453-483): the pretrained-backbone protocol puts the layer on the
        # head of a plain net unless all_layers_bbb (BBB only);
        # camelyon17's from-scratch net and the text heads take it throughout
        head_only = task in HEAD_ONLY_TASKS and not (name == "bbb" and config.get("all_layers_bbb", False))
        made = modules(lambda: _make_backbone(task, config, generator, "plain" if head_only else name,
                                              head_kind=name))
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
    loss_fn = _loss_fn_for(model, regression)
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
        mask = {"mask_fn": bert_head_mask} if task in TEXT_TASKS else {}
        method = last_layer_method(
            loss_fn, inner_factory_for(inner_name), backbone_tx=tx, **mask,
            head_particles=config["svgd_particles"] if inner_name == "svgd" else 0, generator=generator,
        )
    if members > 1:
        method = deep_ensemble(method, members)
        state = method.init(made)
    else:
        state = method.init(made[0], {})
    return BuiltExperiment(model, method, state, _predict_fn(model, regression), device, task, regression)


def _targets(regression: bool, y: np.ndarray) -> np.ndarray:
    """Labels as int64, or a regression task's ``[N, 1]`` targets as
    float32."""
    return np.asarray(y, np.float32 if regression else np.int64)


def _to_device(built: BuiltExperiment, x: np.ndarray, y: np.ndarray):
    return (torch.from_numpy(np.ascontiguousarray(x)).to(built.device),
            torch.from_numpy(_targets(built.regression, y)).to(built.device))


def _host_data(task: str) -> bool:
    """Whether ``train`` keeps the train set on the host and moves each batch
    (the image tasks, whose staged train sets do not fit the card; JAX's
    host ``PrefetchLoader`` loop, :784-850, moves each batch too), rather
    than gathering batches on the device (the text tasks)."""
    return task in IMAGE_TASKS


class _HostBatches:
    """``(x, y)`` batches of ``batch_size`` cut from host arrays, each moved
    to ``device`` when it is reached: a re-iterable for the Laplace fit,
    which sees the same batches as the JAX package's (its ``batch_size``,
    the last one partial)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, device):
        self.x, self.y, self.bs, self.device = x, y, batch_size, device

    def __len__(self):
        return -(-self.x.shape[0] // self.bs)

    def __iter__(self):
        for i in range(0, self.x.shape[0], self.bs):
            yield (torch.from_numpy(np.ascontiguousarray(self.x[i : i + self.bs])).to(self.device),
                   torch.from_numpy(self.y[i : i + self.bs]).to(self.device))


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
        last) and the rest of an epoch through single updates. The batches
        are gathered on the device from the train set moved there once, or,
        under :func:`_host_data`, gathered on the host and moved one at a
        time: the same batches either way.

    With ``checkpoint_dir``, both paths resume from the latest
    ``checkpoint_<epoch>`` there (the host loop's step count at ``start *
    (n // batch_size)``) and save one every ``checkpoint_interval`` epochs
    (default 20), written behind the next epoch and waited for when the loop
    ends, however it ends. ``epoch_callback(epoch, built)`` runs after each
    epoch's ``finalize_epoch`` (eval_while_train, early stopping). One host
    read per epoch, the divergence check."""
    method, state = built.method, built.state
    seed, bs, n = config["seed"], config["batch_size"], x.shape[0]
    host = _host_data(built.task) and not config.get("device_data")
    if host:
        yh = _targets(built.regression, y)

        def gather(order, s):
            idx = order[s * bs : (s + 1) * bs]
            return (torch.from_numpy(x[idx]).to(built.device), torch.from_numpy(yh[idx]).to(built.device))
    else:
        xd, yd = _to_device(built, x, y)

        def gather(order, s):
            idx = order[s * bs : (s + 1) * bs]
            return xd[idx], yd[idx]
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
            order = shuffled_indices(n, seed * 1_000_003 + epoch)
            if not host:
                order = torch.from_numpy(order).to(built.device)
            step, losses, pending = epoch * (n // bs), [], []
            for s in range(n // bs):
                batch = gather(order, s)
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
              meta: np.ndarray, seed: int = 42, z: Optional[torch.Tensor] = None) -> dict:
    """Posterior-predictive eval and the task's official WILDS metrics (JAX
    ``eval_task``, :868-1021): batch i under ``fold_in(seed, i)``, S samples
    each (a Rank-1 model's sample i on the joint component ``i %
    rank1_components``), the log-space model average per example, then
    :func:`eval_metrics` and ``evaluate_task``. A regression task (poverty)
    keeps the S ``(mean, std)`` outputs ``[S, N, 1, 2]`` instead: its
    metrics are ``RegressionResults`` (the quantile draw ``z`` given, or
    from ``seed + 1``) and the worst urban/rural Pearson r of the sample
    means (JAX :994-1009). With ``device_eval`` (the
    default on a card, or under ``device_data``, for a test set of at most
    2 GiB) the whole set goes through the eval runner, cached on ``built``
    per (points, eval batch, S) and method; else a host loop over the same batches and
    keys, each batch moved to the device when it is reached. Either way the
    last partial batch is padded with copies of its last example and
    trimmed, so every example counts once (and, under static BN, the padded
    batch's statistics are the same on both paths). An image task's ``x``
    is NCHW (:func:`task_images`)."""
    method, state = built.method, built.state
    bs, n_samples = config["eval_batch_size"], config["eval_samples"]
    components = config.get("rank1_components", 1) if config.get("model") == "rank1" else 1
    n = x.shape[0]

    def predict_batch(state, key, xb):
        out = predict(method, state, built.apply_fn, xb, n_samples=n_samples, noise=NoiseSource(key=key),
                      components=components)
        # the runner and the host loop cut and join along the batch
        return out.transpose(0, 1) if built.regression else bayesian_model_average(out)

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
            outputs = runner(state, seed, _to_device(built, x, y)[0])
        else:
            outs = []
            for i, start in enumerate(range(0, n, bs)):
                xb = torch.from_numpy(np.ascontiguousarray(x[start : start + bs])).to(built.device)
                valid = xb.shape[0]
                if valid < bs:
                    xb = torch.cat([xb, xb[-1:].expand(bs - valid, *xb.shape[1:])])
                key = keys.as_key(keys.fold_in(seed, i), built.device)
                outs.append(predict_batch(state, key, xb)[:valid])
            outputs = torch.cat(outs)
        yd = torch.from_numpy(_targets(built.regression, y)).to(built.device)
        if built.regression:
            samples = outputs.transpose(0, 1)  # [S, N, 1, 2]
            res = RegressionResults.create(samples, yd, key=seed + 1, z=z)
            preds = samples[..., 0].cpu().numpy().mean(axis=0)  # numpy's float32 sum order, as JAX's
        else:
            result = eval_metrics(outputs, yd, config["ece_bins"])
            preds = outputs.argmax(dim=1).cpu().numpy()
    official = wilds_data.evaluate_task(task, preds, np.asarray(y), meta[: len(preds)])
    if built.regression:
        return {"avg_lml": float(res.average_lml), "avg_ll": float(res.average_log_likelihood),
                "mse": float(res.mse_of_means), "qce": float(res.qce), "sqce": float(res.sqce), **official}
    return {**result.as_dict(), **official}


def _load_task_data(task: str, config: dict):
    """The train and test splits (images NCHW, :func:`task_images`); sets
    ``dataset_size`` and ``steps_per_epoch`` in ``config`` (JAX
    :1068-1075)."""
    x, y, _ = wilds_data.load_wilds(task, "train", subsample=config["subsample"], fold=config.get("fold"))
    xt, yt, mt = wilds_data.load_wilds(task, "test", subsample=config["test_subsample"], fold=config.get("fold"))
    x, xt = task_images(task, config, x), task_images(task, config, xt)
    config["dataset_size"] = x.shape[0]
    config["steps_per_epoch"] = max(1, x.shape[0] // config["batch_size"])
    return x, y, xt, yt, mt


def _build_for(task: str, config: dict, device) -> BuiltExperiment:
    return build(task, config, torch.Generator().manual_seed(config["seed"]), config["steps_per_epoch"],
                 device=device)


def _fit_laplace(built: BuiltExperiment, config: dict, x: np.ndarray, y: np.ndarray) -> None:
    """``built``'s trained MAP state (or MAP ensemble) replaced by its
    last-layer Laplace posterior (the text head's ``Dense_1``, the
    DenseNet's, ResNet-50's or ResNet-18's ``Dense_0``), fitted on ``(x,
    y)`` with ``ll_hessian`` (JAX :1055-1063, :1090-1095; a regression
    task's GGN is ``I / sigma^2`` on GaussLayer's mean channel); with
    ``members`` > 1 a ``deep_ensemble`` over the fitted members. Under
    :func:`_host_data` the fit's batches move one at a time."""
    lap = laplace_method(built.model, hessian=config["ll_hessian"], regression=built.regression,
                         inner=built.method, batch_size=LAPLACE_BATCH)
    if _host_data(built.task):
        data = _HostBatches(x, _targets(built.regression, y), LAPLACE_BATCH, built.device)
    else:
        data = _to_device(built, x, y)
    built.state = lap.fit(built.state, data)
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
    ``{model}_final`` (its file written behind the Laplace fit and the
    evaluation, and waited for before this returns); ``laplace`` fits its
    posterior on the training split after the save; ``eval_while_train``
    evaluates the val split every ``eval_interval`` epochs."""
    config, built, (x, y), (xt, yt, mt) = _rebuild(task, config, device)
    epoch_callback = None
    if config.get("eval_while_train"):
        xv, yv, mv = wilds_data.load_wilds(task, "val", subsample=config["test_subsample"], fold=config.get("fold"))
        xv = task_images(task, config, xv)
        interval = config.get("eval_interval", 1)

        def epoch_callback(epoch, b):
            if epoch % interval == 0:
                val = eval_task(b, task, config, xv, yv, mv)
                if log:
                    log(f"  val@{epoch}: " + ", ".join(f"{k}={v:.4f}" for k, v in val.items() if isinstance(v, float)))

    built = train(built, config, x, y, log=log, epoch_callback=epoch_callback)
    ckpt_dir = config.get("checkpoint_dir")
    if ckpt_dir:
        ckpt.save_final(ckpt_dir, config["model"], built.state, async_save=True)
    try:
        if config["model"] == "laplace":
            _fit_laplace(built, config, x, y)
        return eval_task(built, task, config, xt, yt, mt)
    finally:
        if ckpt_dir:
            ckpt.wait_for_async_saves(ckpt_dir)


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
