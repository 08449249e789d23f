#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``beyond_deep_ensembles_tpu_torch``) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failed check raises and exits non-zero; nothing is caught):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. the CUDA C++ kernels K2 and K3 built at once (one nvcc each, by
     ``ops/_cuda_build.py`` into ``build/kernels/``): build time and ptxas
     report;
  3. K1 (``ops/sampling.py``, Triton, built at first use into ``build/``)
     against its plain PyTorch version at the main path's layer shapes:
     given noise, Philox moments, seeds, frozen rows (the train mode's draw
     of one example, also at every eval-path shape at batch 500), gradients
     (given noise against the plain autograd;
     the Philox mode's, whose backward kernel draws z again, equal to the
     true draw given back bit for bit, train and frozen, on layer planes at
     rho -3 and -6, one backward launch each); then its time and the plain
     version's, replayed in CUDA graphs, for one train forward's 22
     launches, the largest layer (Philox and given noise) and the head
     alone, the backward's 22 launches (and the whole autograd backward
     against the plain version's, between events), the frozen-eval
     forward's 22 launches at batch 500, and the host time of an eager
     launch;
  4. K2 (``ops/svgd_kernel.py`` over ``csrc/svgd_gram.cu``, one launch): G
     against an fp64 product and against ``gram_plain`` at (5, 273,610),
     (20, 25,000,000), (3, 1,000,003) and (1, 4097) within a bound from sum
     |x_i||x_j| and the summation depth; repeat runs and CUDA-graph replays
     bit for bit; its CUDA-graph time beside ``gram_plain``'s and
     ``torch.mm``'s at the first two shapes, against the byte bound; the
     host time of an eager launch;
  5. K3a and K3b (``ops/attention.py`` over ``csrc/dropout_attention.cu``) at
     the Amazon train and eval shapes (8 and 16, 12, 512, 64) and at a ragged
     length (8, 12, 300, 64), with ragged key padding on three rows: the
     output and dQ, dK, dV against the plain version at p = 0 and with a
     given mask at p = 0.1; with Philox at p = 0.1 the keep rate,
     bit-identical repeats (the output, and dQ, dK, dV), another seed's mask,
     and the output and gradients against the plain version fed the realized
     mask; then, at the Amazon shapes, the times of K3a, K3b, the plain
     version and SDPA in turns (minimum and spread of each) against the
     operation bounds of the tensor cores (three TF32 products per
     operation) and of the CUDA cores;
  6. the BBB slice: BBB ResNet-20 (the ``BBB`` variant of configs/cifar.yaml)
     through ``experiments/cifar.py`` ``build`` -> ``train`` (10 steps at
     batch 128 on synthetic CIFAR-10, one update per call) -> ``eval_model``
     (50 posterior samples, eval batch 500, the host loop), with every
     kernel's launch count set to 0
     before and read after (K1's backward 44 a step, none at eval); steady
     steps; a profile of steady train steps (kernels per step)
     (device busy share, top kernels, the host's wait in the NaN guard's
     sync); the card's logits held against the CPU path's on a small input
     with the same weights and noise;
  7. the SVGD slice: the ``SVGD`` variant (5 plain ResNet-20 particles) the
     same way, K2 launched once per train step and never in eval; steady
     steps and a profile; one SVGD step of 3 particles at batch 4 on the card
     held against the CPU path from the same weights;
  7b. the CUDA-graph runners (``parallel/multistep.py``), for BBB and for
     SVGD: ``run_single`` as configs/cifar.yaml writes it (DEFAULT's
     corrupted intensities 0-4) with ``device_data``, one epoch of 100 steps
     replayed from one captured graph and the test split and five corrupted
     splits (1000 images each, S = 50) through the eval runner, every count
     set to 0 before and read after (warm-ups and captures count, replays
     do not); then 4 captured steps against 4 eager ones from one key and
     state (cuDNN deterministic), a captured loss forward replayed under two
     keys (different noise, each equal to the eager forward), steady steps
     eager against captured with the device's busy share and, from a
     profile, the kernels a replay launches (K1: 88 a BBB step; K2: 1 an
     SVGD step), and the eval runner against the host loop, warm, beside the
     card's name and power limit;
  7c. the Multi-X slice (configs/cifar.yaml's DeepEnsemble, MultiBBB,
     MultiMCD and MultiSWAG at 5 members, MCD and SWAG at one): each through
     ``run_single`` with ``device_data``, cut to 2 epochs of 20 steps and
     1000 images per split (SWAG's start epoch in proportion), every count
     set to 0 before and read after (K1 only on MultiBBB), SWAG's
     collections per member from its saved final; 4 captured steps against
     4 eager ones bit for bit (DeepEnsemble, MultiBBB, MCD: its key-mode
     masks); steady steps eager and captured, a profile of the captured ones
     (MultiBBB: K1 440 launches a replay) and the eval runner against the host loop
     (DeepEnsemble, MultiBBB, MultiSWAG); a DeepEnsemble step and MultiBBB's
     log-probs on the card against the CPU; a MultiSWAG run stopped after
     epoch 1 and resumed from its checkpoint against an uninterrupted one,
     bit for bit; ``multix_phase`` over three saved ``map_final`` runs
     against ``eval_model`` of the same ensemble;
  7d. the rest of CIFAR (configs/cifar.yaml's Rank1, iVON, MultiiVON, SNGP,
     Laplace and MultiLaplace, Multi-X at 5 members): each through
     ``run_single`` with ``device_data`` at the Multi-X cut, every count set
     to 0 before and read after (no kernel of the port on these paths); 4
     captured steps against 4 eager ones bit for bit (Rank1: its component
     counter; iVON: its count and moments; SNGP: its precision and spectral
     u); steady steps eager and captured, a profile of the captured ones,
     the eval runner against the host loop (Rank1, iVON, SNGP, Laplace);
     SNGP's epoch boundary (a 1024 x 1024 Cholesky); the Laplace fit's wall
     time (GGN pass, marginal-likelihood search); one step of Rank1, iVON
     and SNGP and a Laplace fit on the card against the CPU; resumed iVON
     and SNGP runs against uninterrupted ones, bit for bit;
     ``fit_laplace_phase`` on a saved ``map_final`` against the Laplace
     row's fit and eval of the same state;
  8. the DistilBERT slice: the ``MCD`` variant of configs/amazon.yaml
     (distilbert-base, full-model MC-Dropout, L = 512, random weights from a
     seed) through ``experiments/wilds_task.py`` ``build`` -> ``train`` (10
     steps at batch 8 on synthetic Amazon) -> ``eval_task`` (32 reviews, eval
     batch 16, 10 samples), K3a launched 6 times per forward and K3b 6 times
     per step, exactly; 20 steady steps and a profile of 3; then the ``MAP``
     variant the same way; the card's MCD logits and one Adam step held
     against the CPU path with the same weights and masks;
  9. UCI regression (``experiments/uci.py`` through the CLI): configs/uci.yaml
     written to a temporary file with its list of data sets cut to naval (the
     largest), 2 epochs and 1 repetition, the grid's nine models and
     DEFAULT's values kept, and driven through ``run.main`` (every count set
     to 0 just before and read just after: K1 on bbb and bbb_fixed_kl only,
     K2 once a svgd step), each run's five metrics finite and its wall time;
     SVGD at 20 particles through ``run_single`` (K2 at n = 20) and map on
     yacht with the gap splits; 16 steps of map, bbb and svgd through the
     multi-step runner (two replays of a graph of 8) against 16 eager ones
     from one key, bit for bit; 20 steady steps eager and captured of map,
     bbb, svgd at 10 and 20 particles and ivon, with K1 and K2 launches per
     step; evaluate's samples/s at S = 1000; one step of map, bbb and svgd
     and evaluate at S = 8 on the card against the CPU; K1 at the MLP's
     planes and K2 at (10, P) and (20, P) against their plain versions, K2's
     time beside ``torch.mm``'s;
 10. the WILDS text tasks: K1 at the BBB head's train planes ([8, 768],
     [8, 5], [16, 768], [16, 2]; given noise and DeviceSeed draws, forward
     and backward) and frozen eval planes (eval batch 16 and 32) against its
     plain version; K3 with a DeviceSeed (the key in device memory) against the equal host seed bit for bit, against the plain version fed
     its mask, a captured launch under two keys, and its time against a
     host-seed launch; K3 and SDPA at CivilComments' (16, 12, 300, 64); K2
     at (5, 66,957,317) and (5, 592,130) beside torch.mm; every row of
     configs/amazon.yaml and configs/civilcomments.yaml through ``run.main``
     at distilbert-base's width, cut to one epoch of 8 steps and 64 test
     examples (SWAG's collections in proportion), a row at a time with
     every count set to 0 just before and read just after, exact; the
     ``eval``, ``fit_laplace``, ``drop_rates`` and ``multix`` phases on the
     written checkpoints against the runs' own evals; a captured DistilBERT
     MCD step against an eager one bit for bit, a captured loss forward
     under two keys, the eval runner against the host loop; 20 captured and
     10 eager steady steps of MAP, MCD, SVGD and LL_SVGD; one step of each
     new method on the card against the CPU at one layer of the same width;
 11. the runner figures, the Multi-X figures, the rest-of-CIFAR figures, the
     UCI figures and the WILDS figures as JSON lines, the card's name and
     power limit, one JSON line of kernel figures (K1, K2, K3a, K3b), then
     the result line ``{"ok": true, "device": {...}}``.
Exits non-zero and prints no result without CUDA or without the package
beside this file.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")
CARD = ""  # "name, power limit" as nvidia-smi gives them, printed beside every phase's times

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # tensor cores, dense
# fp32 operations K1 does per element: two bias adds, sqrt, multiply, add,
# and Box-Muller's log, sqrt, cos and four multiplies/conversions. Philox's
# integer rounds are left out: the peak table has no rate for them.
K1_FLOPS_PER_ELEMENT = 12

# configs/cifar.yaml, variant "BBB" (its DEFAULT block's values are the
# port's DEFAULT_CONFIG; corrupted splits are not ported yet)
BBB_VARIANT = {
    "model": "bbb", "members": 1, "prior_std": 1.0, "weight_decay": 0.0,
    "bbb_mc_samples": 2, "kl_rescaling": 0.2,
}
# configs/cifar.yaml, variant "SVGD" (weight decay 3e-4 from its DEFAULT block)
SVGD_VARIANT = {"model": "svgd", "members": 1, "svgd_particles": 5, "svgd_reg_scale": 0.0003}
# cut to size: one epoch of 1280 synthetic images = 10 steps at batch 128;
# these phases drive the one-update-per-call loop and the host eval loop
# (device_eval off), the runner phase the CUDA-graph runners
SMOKE = {"epochs": 1, "subsample": 1280, "test_subsample": 1000, "seed": 0, "device_eval": False}
TRAIN_STEPS = 10
# configs/cifar.yaml's DEFAULT block beyond the port's DEFAULT_CONFIG
YAML_DEFAULT = {"corrupted_intensities": [0, 1, 2, 3, 4]}
# the runner phase: device_data (the epoch runner, the eval runner), one
# epoch of 100 steps at batch 128 on synthetic images, 1000 test images per
# split at S = 50, eval batch 500; then COMPARE_STEPS captured steps against
# eager ones and TIMED_STEPS of each timed
RUNNER = {"epochs": 1, "subsample": 100 * 128, "test_subsample": 1000, "seed": 0, "device_data": True}
COMPARE_STEPS = 4
TIMED_STEPS = 20
# idle host time on each side of a profile's window (profile_steps)
PROFILE_PAD_S = 0.1
# the Multi-X phase: configs/cifar.yaml's variants (DEFAULT's lr, weight
# decay and schedule are the port's DEFAULT_CONFIG), each through run_single
# with device_data, cut to MULTIX (epochs and data size only): 2 epochs of 20
# steps at batch 128, the test split and five corrupted splits of 1000
# images at S = 50; SWAG's start epoch cut in proportion (250 of 300 -> 1 of
# 2), so each member collects the last epoch's 20 steps
MULTIX_VARIANTS = [
    ("DeepEnsemble", {"model": "map", "members": 5}),
    ("MultiBBB", {"model": "bbb", "members": 5, "prior_std": 1.0, "weight_decay": 0.0, "bbb_mc_samples": 2,
                  "kl_rescaling": 0.2}),
    ("MultiMCD", {"model": "mcd", "members": 5, "p": 0.1}),
    ("MultiSWAG", {"model": "swag", "members": 5, "swag_deviation_samples": 30, "swag_start_epoch": 250,
                   "swag_lr": 0.0005}),
    ("MCD", {"model": "mcd", "members": 1, "p": 0.1}),
    ("SWAG", {"model": "swag", "members": 1, "swag_deviation_samples": 30, "swag_start_epoch": 250,
              "swag_lr": 0.0005}),
]
MULTIX = {"epochs": 2, "subsample": 20 * 128, "test_subsample": 1000, "seed": 0, "device_data": True}
MULTIX_SWAG_START = MULTIX["epochs"] * 250 // 300
MULTIX_EAGER_STEPS = 10  # an eager MultiBBB step takes about a second
# resume: MultiSWAG over 3 epochs of 10 steps, collecting from epoch 1;
# multix: three MAP runs of one epoch of 10 steps, the test split only
RESUME = {"epochs": 3, "subsample": 10 * 128, "test_subsample": 100, "seed": 0, "device_data": True,
          "swag_start_epoch": 1}
MULTIX_CHECK = {"epochs": 1, "subsample": 10 * 128, "test_subsample": 1000, "seed": 0, "device_data": True,
                "corrupted_intensities": []}
# the rest of CIFAR: configs/cifar.yaml's rows Rank1, iVON, MultiiVON, SNGP,
# Laplace and MultiLaplace (DEFAULT's lr, weight decay and schedule are the
# port's DEFAULT_CONFIG), each through run_single with device_data at the
# MULTIX cut (2 epochs of 20 steps, six splits of 1000 images, S = 50, SNGP's
# row S = 1)
SNGP_HEAD = {"num_random_features": 1024, "num_gp_features": -1, "normalize_gp_features": False,
             "ridge_penalty": 1.0, "mean_field_factor": 20.0, "feature_scale": 1.0, "rff_init_std": 0.05}
IVON_ROW = {"model": "ivon", "members": 1, "lr_schedule": False, "ivon_lr": 0.0001, "ivon_prior_prec": 50,
            "ivon_damping": 0.001, "ivon_augmentation": 10, "ivon_mc_samples": 2}
REST_VARIANTS = [
    ("Rank1", {"model": "rank1", "members": 1, "prior_std": 0.1, "rank1_components": 4, "rank1_l2_scale": 0.0003,
               "rank1_kl_rescaling": 1.0}),
    ("iVON", IVON_ROW),
    ("MultiiVON", {**IVON_ROW, "members": 5}),
    ("SNGP", {"model": "sngp", "members": 1, "eval_samples": 1, "spectral_norm_bound": 6.0, "sngp": SNGP_HEAD}),
    ("Laplace", {"model": "laplace", "members": 1, "ll_hessian": "full"}),
    ("MultiLaplace", {"model": "laplace", "members": 5, "ll_hessian": "full"}),
]
# K2's shapes: the SVGD slice's particle matrix (5 particles of ResNet-20's
# 273,610 parameters), the JAX package's upper end (20 particles of 25 M),
# ragged P, one row
K2_SHAPES = [(5, 273_610), (20, 25_000_000), (3, 1_000_003), (1, 4097)]


# K3's shapes: the Amazon train batch and eval batch of distilbert-base (B, H,
# L, D), at the attention dropout of configs/amazon.yaml's DistilBERT (0.1)
K3_SHAPES = [(8, 12, 512, 64), (16, 12, 512, 64)]
# held to the plain version only, not timed: CivilComments' length, which ends
# inside a 64-wide tile (300 = 4 x 64 + 44)
K3_RAGGED_SHAPE = (8, 12, 300, 64)
K3_P = 0.1
# configs/amazon.yaml: its DEFAULT block, and the variants "MCD" and "MAP"
AMAZON_DEFAULT = {
    "batch_size": 8, "eval_batch_size": 16, "epochs": 5, "eval_samples": 10,
    "optimizer_kind": "adam", "lr": 1e-5, "weight_decay": 0.01, "train_all_layers": True,
}
MCD_VARIANT = {"model": "mcd", "dropout_p": 0.2}
MAP_VARIANT = {"model": "map"}
# cut to size: one epoch of 80 synthetic reviews = 10 steps at batch 8; 32
# test reviews = 2 eval batches of 16, through the host eval loop (the WILDS
# phase drives the eval runner)
BERT_SMOKE = {"epochs": 1, "subsample": 80, "test_subsample": 32, "seed": 0, "device_eval": False}


def block_widths():
    return [(16, 1, 32)] * 3 + [(32, 2, 16), (32, 1, 16), (32, 1, 16), (64, 2, 8), (64, 1, 8), (64, 1, 8)]


def bbb_shapes(batch):
    """(output shape, has bias) of the 22 BBB layers of one ResNet-20
    forward at 32x32, in call order."""
    shapes = [((batch, 16, 32, 32), True)]
    for features, stride, side in block_widths():
        shapes += [((batch, features, side, side), True)] * 2
        if stride != 1:
            shapes.append(((batch, features, side, side), False))
    return shapes + [((batch, 10), True)]


def noise_shapes(batch, train):
    """The 76 draws of one forward in call order: per block conv1, three
    per variational FRN, conv2, three more, then the skip conv."""
    shapes = [(batch, 16, 32, 32)]
    for features, stride, side in block_widths():
        for _ in range(2):
            shapes += [(batch, features, side, side)] + [(batch, features)] * 3
        if stride != 1:
            shapes.append((batch, features, side, side))
    shapes.append((batch, 10))
    return shapes if train else [s[1:] for s in shapes]


def phase(title):
    """A phase's heading: every time printed under it was taken on this card."""
    print(f"== {title} [{CARD}]")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"ok: {what}")


def graph_ms(torch, fn, reps=20):
    """Device time of one call of ``fn``, replayed from a CUDA graph so that
    host launch overhead does not show."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def layer_planes(torch, gen, shape, bias, rho):
    """The mean and variance planes (and bias mean and variance) a BBB layer
    hands K1, as ``nn/bbb.py`` computes them, with every weight's
    std = softplus(rho): a 3x3 conv from 16 channels for an output of 16
    channels, a 1x1 stride-2 conv from 16 channels at 32x32 otherwise, and
    the 64 -> 10 dense head for a rank-2 shape."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    var_w = max(F.softplus(torch.tensor(rho)).item() ** 2, 1e-4)  # the layer's clamp
    if len(shape) == 2:
        x = F.silu(torch.randn(shape[0], 64, device=dev, generator=gen))
        w = 0.1 * torch.randn(shape[1], 64, device=dev, generator=gen)
        act_mean = x @ w.T
        act_var = torch.clamp(x * x, min=1e-4) @ torch.full_like(w, var_w).T
    else:
        kernel, stride = (3, 1) if shape[1] == 16 else (1, 2)
        x = F.silu(torch.randn(shape[0], 16, 32, 32, device=dev, generator=gen))
        w = 0.1 * torch.randn(shape[1], 16, kernel, kernel, device=dev, generator=gen)
        act_mean = F.conv2d(x, w, stride=stride, padding=kernel // 2)
        act_var = F.conv2d(torch.clamp(x * x, min=1e-4), torch.full_like(w, var_w), stride=stride, padding=kernel // 2)
    if not bias:
        return [act_mean, act_var]
    b_var = F.softplus(torch.tensor(rho)).item() ** 2  # conv bias variance: not clamped
    if len(shape) == 2:
        b_var = max(b_var, 1e-4)
    b_mean = 0.1 * torch.randn(shape[1], device=dev, generator=gen)
    return [act_mean, act_var, b_mean, torch.full((shape[1],), b_var, device=dev)]


def kernel_phase(torch, sampling):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def planes(shape, bias):
        mean = 0.5 * torch.randn(shape, device=dev, generator=gen)
        var = 0.25 * torch.rand(shape, device=dev, generator=gen) + 1e-4
        b_mean = torch.randn(shape[1], device=dev, generator=gen) if bias else None
        b_var = torch.rand(shape[1], device=dev, generator=gen) if bias else None
        return mean, var, b_mean, b_var

    # given noise, full shape (train) and one row (frozen eval)
    worst = 0.0
    for batch, frozen in ((128, False), (500, True)):
        for shape, bias in bbb_shapes(batch):
            args = planes(shape, bias)
            eps = torch.randn(shape[1:] if frozen else shape, device=dev, generator=gen)
            out = sampling.gaussian_sample(*args, eps=eps)
            ref = sampling.gaussian_sample_plain(*args, eps)
            worst = max(worst, float((out - ref).abs().max()))
    torch.cuda.synchronize()
    check(worst <= 1e-6, f"K1 given noise = plain at the main path's shapes (max abs err {worst:.3g} <= 1e-6)")

    # frozen eval at the eval path's 22 shapes (batch 500, where a program
    # of the largest layers loops over several examples and the last batch
    # chunk holds fewer): equal, bit for bit, to the train mode's draw of
    # one example given as the row, and to the plain version within 1e-6
    same, frozen_worst = True, 0.0
    for shape, bias in bbb_shapes(500):
        args = planes(shape, bias)
        one = torch.zeros((1,) + shape[1:], device=dev)
        row = sampling.gaussian_sample(one, torch.ones_like(one), seed=17)[0].contiguous()
        out = sampling.gaussian_sample(*args, seed=17, frozen=True)
        same = same and torch.equal(out, sampling.gaussian_sample(*args, eps=row))
        frozen_worst = max(frozen_worst, float((out - sampling.gaussian_sample_plain(*args, row)).abs().max()))
    _, _, _, per_program, chunks = sampling.frozen_plan(500, 16 * 32 * 32)
    check(same and frozen_worst <= 1e-6,
          f"K1 frozen eval at batch 500 (largest layers: {per_program} examples a program, {500 - (chunks - 1) * per_program} "
          f"in the last chunk) = the train mode's row given, bit for bit, and = plain (max abs err "
          f"{frozen_worst:.3g} <= 1e-6)")
    worst = max(worst, frozen_worst)

    zeros = torch.zeros(1024, 16, 32, 32, device=dev)
    z = sampling.gaussian_sample(zeros, torch.ones_like(zeros), seed=11)
    mean, std = float(z.mean()), float(z.std())
    check(abs(mean) < 2e-3 and abs(std - 1.0) < 2e-3,
          f"K1 Philox over {z.numel()} draws: mean {mean:.2e}, std {std:.6f}")
    other = sampling.gaussian_sample(zeros, torch.ones_like(zeros), seed=12)
    check(float((z == other).float().mean()) < 1e-3, "K1 seeds 11 and 12 draw different noise")
    rows = sampling.gaussian_sample(zeros[:128], torch.ones_like(zeros[:128]), seed=13, frozen=True)
    check(bool((rows == rows[:1]).all()) and float(rows[0].std()) > 0.5, "K1 frozen mode: one row for the batch")
    one = sampling.gaussian_sample(zeros[:1], torch.ones_like(zeros[:1]), seed=13)
    check(torch.equal(rows[:1], one), "K1 frozen row = the train mode's draw of one example at the same seed")

    # gradients: given noise against the plain version; the Philox mode,
    # whose backward kernel draws z again, equal to given noise at the true
    # draw bit for bit, train and frozen, on planes a BBB layer computes at
    # init (rho -3) and after rho has shrunk (rho -6, the weight variance
    # then at the 1e-4 clamp)
    for shape, bias in ((128, 16, 32, 32), True), ((128, 32, 16, 16), False), ((128, 10), True):
        for rho in (-3.0, -6.0):
            leaves = [t.requires_grad_(True) for t in layer_planes(torch, gen, shape, bias, rho)]
            args = leaves if bias else leaves + [None, None]
            g = torch.randn(shape, device=dev, generator=gen)
            for frozen in (False, True):
                mode = "frozen" if frozen else "train"
                z = sampling.gaussian_sample(torch.zeros(shape, device=dev), torch.ones(shape, device=dev),
                                             seed=21, frozen=frozen)
                z = z[0].contiguous() if frozen else z
                given = sampling.gaussian_sample(*args, eps=z)
                want = torch.autograd.grad((given * g).sum(), leaves)
                ref = sampling.gaussian_sample_plain(*args, z)
                plain = torch.autograd.grad((ref * g).sum(), leaves)
                for a, b in zip(want, plain):
                    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    check(err <= 1e-5, f"K1 given-noise gradient {tuple(a.shape)}, {mode}, rho {rho:g} = plain "
                          f"autograd (rel err {err:.2e} <= 1e-5)")
                out = sampling.gaussian_sample(*args, seed=21, frozen=frozen)
                check(torch.equal(out, given), f"K1 Philox draw at seed 21 = the same z given, {shape}, {mode}")
                backwards = sampling.gaussian_sample_backward.launches
                got = torch.autograd.grad((out * g).sum(), leaves)
                check(sampling.gaussian_sample_backward.launches == backwards + 1,
                      f"K1 backward: one launch for one backward, {shape}, {mode}")
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"K1 Philox gradients = given-noise gradients bit for bit, {shape}, {mode}, rho {rho:g}")

    # time: the 22 launches of one train forward at batch 128, Philox mode
    layers = [planes(shape, bias) for shape, bias in bbb_shapes(128)]
    n_elem = sum(m.numel() for m, _, _, _ in layers)
    n_bytes = sum(12 * m.numel() + (8 * m.shape[1] if bm is not None else 0) for m, _, bm, _ in layers)

    def kernel_forward():
        for m, v, bm, bv in layers:
            sampling.gaussian_sample(m, v, bm, bv, seed=5)

    def plain_forward():
        for m, v, bm, bv in layers:
            sampling.gaussian_sample_plain(m, v, bm, bv, torch.randn(m.shape, device=dev))

    with torch.no_grad():  # in turns: plain, kernel, kernel, plain
        plain_ms, ms = graph_ms(torch, plain_forward), graph_ms(torch, kernel_forward)
        ms2, plain_ms2 = graph_ms(torch, kernel_forward), graph_ms(torch, plain_forward)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_elem * K1_FLOPS_PER_ELEMENT / FP32_FLOPS_PER_S * 1e3
    print(f"K1 one train forward at batch 128 ({len(layers)} launches, {n_elem} elements, {n_bytes} bytes): "
          f"kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} / {plain_ms2:.4f} ms, "
          f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, fp32 ops {ops_ms:.4f})")

    # single layers, 20 launches in one graph, turn about over four copies
    # of the inputs (over 50 MB, the card's L2, for the largest layer), so
    # that each launch reads device memory: the largest layer (stem and
    # stage 1) against its own bound parts the kernel body's rate from the
    # fixed cost of a launch, which the 1280-element head shows alone; the
    # largest layer with given noise (z read, 16 bytes per element, no
    # Philox) parts the memory traffic from the in-kernel draw
    def copies(layer, eps=None):
        return [(*(t.clone() if t is not None else None for t in layer), eps if eps is None else eps.clone())
                for _ in range(4)]

    eps = torch.randn(layers[0][0].shape, device=dev, generator=gen)
    singles = (
        ("largest layer 128x16x32x32", copies(layers[0]), 12),
        ("head 128x10", copies(layers[-1]), 12),
        ("largest layer 128x16x32x32, given noise", copies(layers[0], eps), 16),
    )
    for label, inputs, per_element in singles:
        def repeated():
            for i in range(20):
                m, v, bm, bv, z = inputs[i % 4]
                if z is None:
                    sampling.gaussian_sample(m, v, bm, bv, seed=5)
                else:
                    sampling.gaussian_sample(m, v, bm, bv, eps=z)

        with torch.no_grad():
            one_ms = graph_ms(torch, repeated) / 20
        m = inputs[0][0]
        one_bound = (per_element * m.numel() + 8 * m.shape[1]) / HBM_BYTES_PER_S * 1e3
        print(f"K1 {label} alone: {one_ms * 1e3:.2f} us per launch, byte bound {one_bound * 1e3:.2f} us "
              f"({100 * one_bound / one_ms:.0f}% of the bound)")
    backward = k1_backward_times(torch, sampling, layers, n_elem, n_bytes)
    del layers
    frozen = k1_frozen_times(torch, sampling, [planes(shape, bias) for shape, bias in bbb_shapes(500)])
    torch.cuda.empty_cache()
    return {
        "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": worst, **backward, **frozen,
    }


def k1_bound_ms(n_elem, n_bytes):
    return max(n_bytes / HBM_BYTES_PER_S, n_elem * K1_FLOPS_PER_ELEMENT / FP32_FLOPS_PER_S) * 1e3


def host_us(torch, fn, reps=200):
    """Host time of one eager call of ``fn`` (enqueue only, no sync), on
    calls small enough that the device keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def k1_backward_times(torch, sampling, layers, n_elem, n_bytes):
    """K1's backward for one train forward at batch 128 (22 launches, Philox
    mode): the kernels alone in a CUDA graph against their bound (g and
    act_var read, d act_var written: the forward's bytes), and the whole
    autograd backward through ``gaussian_sample`` (kernels, channel sums)
    against autograd through the plain version, between events, in turns;
    then the host time of one eager forward (autograd recording, as in
    training) and one eager backward launch on the head."""
    dev = torch.device("cuda")
    gs = [torch.randn_like(m) for m, _, _, _ in layers]

    def kernel_backward():
        for (_, v, _, bv), g in zip(layers, gs):
            sampling.gaussian_sample_backward(g, v, bv, seed=5)

    with torch.no_grad():
        times = in_turns({"kernel": lambda: graph_ms(torch, kernel_backward)})
    leaves = [[t.detach().clone().requires_grad_(True) if t is not None else None for t in layer] for layer in layers]
    flat = [t for layer in leaves for t in layer if t is not None]
    ours = [sampling.gaussian_sample(*layer, seed=5) for layer in leaves]
    plain = [sampling.gaussian_sample_plain(*layer, torch.randn(layer[0].shape, device=dev)) for layer in leaves]
    full = in_turns({
        "ours": lambda: events_ms(torch, lambda: torch.autograd.grad(ours, flat, gs, retain_graph=True)),
        "plain": lambda: events_ms(torch, lambda: torch.autograd.grad(plain, flat, gs, retain_graph=True)),
    })
    del ours, plain
    bound = k1_bound_ms(n_elem, n_bytes)
    ms = times["kernel"][0]
    print(f"K1 backward kernels of one train backward at batch 128 ({len(layers)} launches): {ms:.4f} ms "
          f"(max {times['kernel'][-1]:.4f}), bound {bound:.4f} ms ({100 * bound / ms:.0f}% of it); whole autograd "
          f"backward: through gaussian_sample {full['ours'][0]:.4f} ms, through the plain version "
          f"{full['plain'][0]:.4f} ms (minimum of {len(full['ours'])} turns each)")

    head = leaves[-1]
    g_head = gs[-1]
    fwd_us = host_us(torch, lambda: sampling.gaussian_sample(*head, seed=5))
    bwd_us = host_us(torch, lambda: sampling.gaussian_sample_backward(g_head, head[1].detach(), head[3].detach(), seed=5))
    print(f"K1 host time per eager launch (head 128x10, no sync): forward {fwd_us:.2f} us (autograd recording), "
          f"backward {bwd_us:.2f} us")
    return {"backward_ms": ms, "backward_bound_ms": bound, "backward_autograd_ms": full["ours"][0],
            "backward_plain_autograd_ms": full["plain"][0], "host_us": fwd_us, "backward_host_us": bwd_us}


def k1_frozen_times(torch, sampling, layers):
    """The frozen-eval forward at eval batch 500 (22 launches, one noise row
    per layer for the whole batch) in a CUDA graph, against its byte bound
    and the plain version (one row of torch.randn broadcast), in turns."""
    dev = torch.device("cuda")
    n_elem = sum(m.numel() for m, _, _, _ in layers)
    n_bytes = sum(12 * m.numel() + (8 * m.shape[1] if bm is not None else 0) for m, _, bm, _ in layers)

    def kernel_forward():
        for m, v, bm, bv in layers:
            sampling.gaussian_sample(m, v, bm, bv, seed=5, frozen=True)

    def plain_forward():
        for m, v, bm, bv in layers:
            sampling.gaussian_sample_plain(m, v, bm, bv, torch.randn(m.shape[1:], device=dev))

    with torch.no_grad():
        times = in_turns({"kernel": lambda: graph_ms(torch, kernel_forward, reps=10),
                          "plain": lambda: graph_ms(torch, plain_forward, reps=10)}, rounds=1)
    bound = k1_bound_ms(n_elem, n_bytes)
    ms = times["kernel"][0]
    print(f"K1 one frozen-eval forward at batch 500 ({len(layers)} launches, {n_elem} elements, {n_bytes} bytes): "
          f"kernel {ms:.4f} ms (max {times['kernel'][-1]:.4f}), plain {times['plain'][0]:.4f} ms, bound {bound:.4f} ms "
          f"({100 * bound / ms:.0f}% of it)")
    return {"frozen_eval_ms": ms, "frozen_eval_plain_ms": times["plain"][0], "frozen_eval_bound_ms": bound}


def k2_check(torch, svgd_kernel, x):
    """K2 on ``x`` against an fp64 product and against ``gram_plain``.
    Bound per element: ``gram_error_bound`` (gamma_d * sum_p |x_ip||x_jp|,
    d the kernel's summation depth) plus the fp64 product's own rounding, at
    most P * 2^-53 of that sum; against the plain fp32 product, the kernel's
    bound plus the plain product's own measured distance from fp64 and the
    fp64 rounding on each side. Returns (max abs err vs plain, largest share
    of the bound used)."""
    out = svgd_kernel.gram(x)
    torch.cuda.synchronize()
    plain = svgd_kernel.gram_plain(x).double()
    xd = x.double()
    ref = xd @ xd.T
    del xd
    a = x.abs().double()
    b64 = x.shape[1] * 2.0**-53 * (a @ a.T)
    del a
    bound = svgd_kernel.gram_error_bound(x)
    share = float(((out.double() - ref).abs() / (bound + b64)).max())
    plain_ok = bool(((out.double() - plain).abs() <= bound + (plain - ref).abs() + 2 * b64).all())
    err = float((out.double() - plain).abs().max())
    check(share <= 1.0 and plain_ok and torch.equal(out, out.T),
          f"K2 {tuple(x.shape)} = fp64 product within its bound ({share:.3f} of it) and = gram_plain "
          f"(max abs err {err:.3g}; plain's own max error vs fp64 {float((plain - ref).abs().max()):.3g})")
    return err, share


def k2_phase(torch, svgd_kernel):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {}
    for n, p in K2_SHAPES:
        # particles around a shared centre, as SVGD's are: G's off-diagonal is large
        x = torch.randn(n, p, device=dev, generator=gen) + torch.randn(1, p, device=dev, generator=gen)
        errs[(n, p)], _ = k2_check(torch, svgd_kernel, x)
        first = svgd_kernel.gram(x)
        check(all(torch.equal(svgd_kernel.gram(x), first) for _ in range(3)), f"K2 {(n, p)}: repeat runs equal bit for bit")
        before = svgd_kernel.gram.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = svgd_kernel.gram(x)
        check(svgd_kernel.gram.launches == before + 1, f"K2 {(n, p)}: one launch per call")
        same = []
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            same.append(torch.equal(captured, first))
        check(all(same), f"K2 {(n, p)}: three CUDA-graph replays equal the eager result bit for bit")
        del x, first, graph, captured
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    timings = {}
    for n, p in K2_SHAPES[:2]:
        # enough copies that the turn over them exceeds the 50 MB L2, so each
        # launch reads device memory
        copies = max(1, -(-60_000_000 // (4 * n * p)))
        xs = [torch.randn(n, p, device=dev, generator=gen) for _ in range(copies)]
        reps = max(copies, 4)

        def run(fn):
            def repeated():
                for i in range(reps):
                    fn(xs[i % copies])
            return graph_ms(torch, repeated, reps=5) / reps

        with torch.no_grad():  # in turns: plain, kernel, kernel, plain, library
            plain_ms = run(svgd_kernel.gram_plain)
            ms = run(svgd_kernel.gram)
            ms2 = run(svgd_kernel.gram)
            plain_ms2 = run(svgd_kernel.gram_plain)
            lib_ms = run(lambda x: torch.mm(x, x.T))
        n_bytes = 4 * n * p + 4 * n * n
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * n * p / FP32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        print(f"K2 ({n}, {p}), {copies} copies in turn: kernel {ms * 1e3:.2f} / {ms2 * 1e3:.2f} us, "
              f"gram_plain {plain_ms * 1e3:.2f} / {plain_ms2 * 1e3:.2f} us, torch.mm {lib_ms * 1e3:.2f} us, "
              f"bound {bound * 1e3:.2f} us (bytes {bytes_ms * 1e3:.2f}, fp32 ops {ops_ms * 1e3:.2f}); "
              f"K2 at {100 * bound / min(ms, ms2):.0f}% of the bound")
        timings[(n, p)] = {
            "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2), "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        del xs
        torch.cuda.empty_cache()
    n, p = K2_SHAPES[0]
    x = torch.randn(n, p, device=dev, generator=gen)
    k2_host_us = host_us(torch, lambda: svgd_kernel.gram(x))
    print(f"K2 host time per eager launch ({n}, {p}), no sync: {k2_host_us:.2f} us")
    return {**timings[(n, p)], "max_abs_err": errs[(n, p)], "host_us": k2_host_us}


def profile_steps(torch, step, ours, steps=3, label="train steps"):
    """Device time by kernel over ``steps`` steady train steps (``step(i)``
    runs step i); prints the top entries (and every kernel whose name holds
    one of ``ours``), the device's busy share of the window and the host's
    wait in ``aten::_local_scalar_dense`` (a NaN guard's or a loss's read).
    Returns {"kernels": kernels per step, "launches": {name in ``ours``:
    launches per step}, "busy": the device's busy share}, or None where the
    trace has no device time. The trace starts with a warm-up period, one
    small kernel traced and discarded: without it the tracer once missed
    the first kernels of a window that opened on a graph replay (one of
    each of a BBB forward's first layers). The tracer keeps a device record
    only where its timestamps, on the card's clock, fall inside the window,
    which opens and closes on the host's: the trace of a runner eval, which
    ran from the window's first moment to its last, once lost 24 of its 2200
    K1 launches. So the window has ``PROFILE_PAD_S`` of idle host time on
    each side of the steps, and the margins between it and the first and
    last device record are printed, with the last record's end less the
    end of the host's ``cudaDeviceSynchronize`` after the steps (which
    waited for it: at most 0 where the two clocks agree)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()  # the window: only what follows is reported
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
        prof.step()
    events = prof.events()
    window = [e.time_range for e in events if e.name.startswith("ProfilerStep") and "CPU" in str(e.device_type)]
    device = [e.time_range for e in events if "CUDA" in str(e.device_type) and not e.is_user_annotation]
    syncs = [e.time_range for e in events if e.name == "cudaDeviceSynchronize"]
    if window and device:
        first, last = min(r.start for r in device), max(r.end for r in device)
        line = (f"trace window margins: first device record {(first - window[0].start) / 1e3:.3f} ms after the "
                f"window opened, last {(window[0].end - last) / 1e3:.3f} ms before it closed "
                f"({PROFILE_PAD_S * 1e3:.0f} ms of idle host time on each side)")
        # the host's last synchronize before the closing idle time (the
        # profiler's own, after it, waits for nothing of the steps)
        syncs = [r.end for r in syncs if r.start < window[0].end - PROFILE_PAD_S * 1e6 / 2]
        if syncs:
            line += (f"; the last device record ended {(last - max(syncs)) / 1e3:+.3f} ms after the host's "
                     f"synchronize returned (<= 0 where the clocks agree)")
        print(line)
    averages = prof.key_averages()
    # kernels only: a record_function range (the optimizer's step) also
    # carries device time, that of the kernels inside it
    kernels = [e for e in averages if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("ProfilerStep")]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        print("profile: no device time in the trace (not measured)")
        return None
    ops = sum(e.count for e in averages if e.key.startswith("aten::"))
    print(f"profile of {steps} {label}: wall {wall_ms:.2f} ms, device busy {device_us / 1e3:.2f} ms "
          f"({100 * device_us / 1e3 / wall_ms:.1f}% of the window); per step "
          f"{sum(e.count for e in kernels) // steps} kernels, {ops // steps} aten ops (nested ops counted)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    top += [e for e in kernels if any(name in e.key for name in ours) and e not in top]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step  {e.count // steps:5d} calls/step  {e.key[:90]}")
    item_us = sum(e.cpu_time_total for e in averages if e.key == "aten::_local_scalar_dense")
    print(f"host blocked in scalar reads: {item_us / 1e3 / steps:.3f} ms/step "
          f"({100 * item_us / 1e3 / wall_ms:.1f}% of the window)")
    per_name = {name: sum(e.count for e in kernels if name in e.key) / steps for name in ours}
    return {"kernels": sum(e.count for e in kernels) // steps, "launches": per_name,
            "busy": device_us / 1e3 / wall_ms}


def steady_steps(torch, step, label, batch, count=2 * TRAIN_STEPS):
    """``count`` steady train steps (``step(i)`` runs step i and returns its
    loss), timed one by one with CUDA events."""
    losses = []
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(count + 1)]
    marks[0].record()
    for i in range(count):
        losses.append(step(i))
        marks[i + 1].record()
    marks[-1].synchronize()
    check(all(bool(torch.isfinite(v)) for v in losses), f"{label} steady steps: every loss finite")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    print(f"{label} steady train step over {count} steps (batch {batch}): median "
          f"{step_ms[len(step_ms) // 2]:.2f} ms, max {step_ms[-1]:.2f} ms, min {step_ms[0]:.2f} ms [{CARD}]")
    return {"median_ms": step_ms[len(step_ms) // 2], "min_ms": step_ms[0], "max_ms": step_ms[-1]}


def small_input_check(torch, NoiseSource, ResNet20):
    """The card's forward (K1 given mode, cuDNN without TF32) against the CPU
    path's on 4 images, same weights and noise, train and eval."""
    gen = torch.Generator().manual_seed(3)
    cpu = ResNet20(10, "swish", "frn", "bbb", generator=torch.Generator().manual_seed(1))
    gpu = ResNet20(10, "swish", "frn", "bbb", generator=torch.Generator().manual_seed(2)).cuda()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(4, 3, 32, 32, generator=gen)
    for train in (True, False):
        draws = [torch.randn(s, generator=gen) for s in noise_shapes(4, train)]
        with torch.no_grad():
            ref = cpu(x, NoiseSource(given=draws), train=train)
            out = gpu(x.cuda(), NoiseSource(given=[d.cuda() for d in draws]), train=train).cpu()
        err = float((out - ref).abs().max())
        check(out.shape == (4, 10) and bool(torch.isfinite(out).all()) and err <= 1e-4,
              f"ResNet-20 logits on the card = CPU path ({'train' if train else 'eval'}, max abs err {err:.2e} <= 1e-4)")


def svgd_step_check(torch, cifar, NoiseSource):
    """One SVGD step of 3 particles at batch 4, augmentation off, on the card
    (cuDNN without TF32, K2) against the CPU path (gram_plain) from the same
    weights. Tolerance: loss 1e-5 relative; parameters 1e-5 absolute (the
    gradients of the two paths sum in other orders and agree to about 1e-5
    relative; the step moves a parameter by lr 0.05 x 1.9 x |phi|)."""
    config = {**cifar.DEFAULT_CONFIG, **SVGD_VARIANT, "svgd_particles": 3, "augment": False,
              "dataset_size": 1280, "epochs": 1}
    cpu = cifar.build(config, torch.Generator().manual_seed(4), 10, device="cpu")
    gpu = cifar.build(config, torch.Generator().manual_seed(4), 10)
    gen = torch.Generator().manual_seed(5)
    x, y = torch.randn(4, 3, 32, 32, generator=gen), torch.randint(0, 10, (4,), generator=gen)
    before = [p.detach().clone() for p in cpu.state.params.parameters()]
    cpu.state, m_cpu = cpu.method.update(cpu.state, NoiseSource.seeded(0), (x, y))
    gpu.state, m_gpu = gpu.method.update(gpu.state, NoiseSource.seeded(0), (x.cuda(), y.cuda()))
    err = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in zip(gpu.state.params.parameters(), cpu.state.params.parameters()))
    moved = max(float((b.detach() - p0).abs().max()) for b, p0 in zip(cpu.state.params.parameters(), before))
    loss_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    check(err <= 1e-5 and loss_err <= 1e-5,
          f"SVGD step on the card = CPU path (3 particles, batch 4: params max abs err {err:.2e} <= 1e-5 "
          f"of a step moving them up to {moved:.3g}; loss rel err {loss_err:.1e} <= 1e-5)")


def run_slice(torch, cifar, NoiseSource, kernels, variant, label):
    """``variant``'s slice through the entry points: build -> train (10 steps)
    -> eval_model, with every kernel's launch count set to 0 just before
    train and read after train and after eval. Returns the built
    experiment, the counts {name: (train, eval)} and the data on the card."""
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10

    config = {**cifar.DEFAULT_CONFIG, **variant, **SMOKE}
    x_train, y_train = load_cifar10(True, subsample=config["subsample"])
    x_test, y_test = load_cifar10(False, subsample=config["test_subsample"])
    config["dataset_size"] = x_train.shape[0]
    steps = x_train.shape[0] // config["batch_size"]
    check(steps == TRAIN_STEPS, f"{label}: {steps} train steps of batch {config['batch_size']}")
    built = cifar.build(config, torch.Generator().manual_seed(config["seed"]), steps)
    check(built.device.type == "cuda", f"{label}: build() defaults to the card")

    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for fn in kernels.values():
        fn.launches = 0
    start.record()
    cifar.train(built, config, x_train, y_train, log=print)  # raises on a non-finite loss
    mid.record()
    trained = {name: fn.launches for name, fn in kernels.items()}
    result = cifar.eval_model(built, config, x_test, y_test).as_dict()
    end.record()
    counts = {name: (trained[name], fn.launches - trained[name]) for name, fn in kernels.items()}
    end.synchronize()
    check(all(bool(torch.isfinite(p).all()) for p in built.state.params.parameters()),
          f"{label}: parameters finite after training")
    check(all(isinstance(v, float) and v == v and abs(v) != float("inf") for v in result.values()),
          f"{label}: eval metrics finite: {json.dumps(result)}")
    check(0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0, f"{label}: eval metrics in range")
    train_ms, eval_ms = start.elapsed_time(mid), mid.elapsed_time(end)
    n_eval = x_test.shape[0] * config["eval_samples"]
    print(f"{label} train: {TRAIN_STEPS} steps in {train_ms:.1f} ms = {train_ms / TRAIN_STEPS:.2f} ms/step (first steps included)")
    print(f"{label} eval: {x_test.shape[0]} images x {config['eval_samples']} samples in {eval_ms:.1f} ms = "
          f"{n_eval / eval_ms * 1e3:.0f} samples/s ({x_test.shape[0] / eval_ms * 1e3:.1f} images/s)")

    # steady train steps on the trained state, outside the counted run, each
    # under its own key, as train's one-update-per-call loop draws
    from beyond_deep_ensembles_tpu_torch import keys

    xd = torch.from_numpy(x_train).cuda().permute(0, 3, 1, 2).contiguous()
    yd = torch.from_numpy(y_train).cuda()

    def step(i):
        idx = slice((i % TRAIN_STEPS) * 128, (i % TRAIN_STEPS + 1) * 128)
        noise = NoiseSource(key=keys.as_key(keys.fold_in(1, i), xd.device))
        built.state, m = built.method.update(built.state, noise, (xd[idx], yd[idx]))
        return m["loss"]

    steady_steps(torch, step, label, 128)
    return built, counts, config, step


def runner_counts_check(label, counts, config):
    """Host launch counts of the runner phase's run_single: the runners'
    warm-ups and captures launch through the wrappers (two warm-ups and one
    capture of the step, the same of the eval batch), replays never."""
    per_capture = 1 + 2  # multistep._WARMUP updates, then the capture
    forward = len(bbb_shapes(1))
    if config["model"] == "bbb":
        want = {"k1_gaussian_sample": per_capture * (config["bbb_mc_samples"] + config["eval_samples"]) * forward,
                "k1_gaussian_sample_backward": per_capture * config["bbb_mc_samples"] * forward, "k2_svgd_gram": 0}
    else:
        want = {"k1_gaussian_sample": 0, "k1_gaussian_sample_backward": 0, "k2_svgd_gram": per_capture}
    want.update({"k3a_attention_forward": 0, "k3b_attention_backward": 0})
    check(counts == want, f"{label} runner path: host launch counts {counts} (warm-ups and captures; replays "
          f"launch no wrapper)")


def runner_phase(torch, cifar, kernels, variant, label, ours):
    """``variant`` through ``run_single`` as configs/cifar.yaml writes it
    (DEFAULT's corrupted intensities) with ``device_data``: the epoch runner
    (one epoch of 100 replayed steps) and the eval runner (the test split and
    five corrupted splits, one capture), every count set to 0 just before and
    read just after. Then, on a model built afresh (the loss augmenting per
    step, as the scan_steps path runs it): COMPARE_STEPS captured steps
    against eager ones from one key and state and a captured loss forward
    under two keys (fresh noise per replay, each equal to the eager forward
    under its key), both on cuDNN's deterministic algorithms; then, on its
    default ones, steady steps eager and captured (CUDA events), a profile of
    each (kernels per step, the device's busy share, the ``ours`` kernels
    per step: K1's forward and backward both appear as ``_flat_kernel``);
    the eval runner against the host eval loop, warm, metrics and
    samples/s. Returns the figures."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    config = {**cifar.DEFAULT_CONFIG, **YAML_DEFAULT, **variant, **RUNNER}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = cifar.run_single(config, log=print)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    splits = ["test"] + [f"corrupted{i}" for i in YAML_DEFAULT["corrupted_intensities"]]
    check(list(results) == splits, f"{label} run_single (device_data, DEFAULT corrupted intensities): splits {list(results)}")
    for split, m in results.items():
        check(all(math.isfinite(v) for v in m.values()) and 0.0 <= m["accuracy"] <= 1.0 and m["avg_log_likelihood"] < 0.0,
              f"{label} {split}: metrics finite and in range: {json.dumps(m)}")
    runner_counts_check(label, counts, config)
    print(f"{label} run_single: {RUNNER['subsample'] // config['batch_size']} replayed steps + 6 splits x 1000 images x S {config['eval_samples']} in {wall:.1f} s "
          f"(data made, kernels compiled and graphs captured in it) [{CARD}]")

    dev = torch.device("cuda")
    bs, k = config["batch_size"], COMPARE_STEPS
    x, y = load_cifar10(True, subsample=config["subsample"])
    x_test, y_test = load_cifar10(False, subsample=config["test_subsample"])
    step_config = {**config, "device_data": False, "dataset_size": x.shape[0]}
    built = cifar.build(step_config, torch.Generator().manual_seed(1), x.shape[0] // bs)
    xd, yd = cifar._to_device(built, x, y)
    method, state = built.method, built.state
    batches = [(xd[i * bs : (i + 1) * bs].clone(), yd[i * bs : (i + 1) * bs].clone()) for i in range(TIMED_STEPS)]

    # captured against eager, from one state and one key, on cuDNN's
    # deterministic algorithms (so that the two can agree bit for bit; the
    # timings below run on its default ones, as training does)
    torch.backends.cudnn.deterministic = True
    written = multistep._written_tensors(state)
    with torch.no_grad():
        saved = [t.clone() for t in written]
    key = keys.fold_in(7, 0)
    state, sums = multistep.eager_steps(method.update, state, key, batches[:k])
    eager = [t.clone() for t in written]
    eager_metrics = {name: float(v) / k for name, v in sums.items()}
    with torch.no_grad():
        for t, v in zip(written, saved):
            t.copy_(v)
    state.step -= k
    multi = multistep.make_multi_step(method.update, k)
    state, metrics = multi(state, key, multistep.stack_batches(batches[:k]))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(written, eager))
    param_err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(written, eager))
    metric_err = max(abs(float(metrics[n]) - v) / max(abs(v), 1e-30) for n, v in eager_metrics.items())
    check(param_err <= 1e-5 and metric_err <= 1e-5 and int(written[-1]) == int(eager[-1]) == k,
          f"{label}: {k} captured steps (one graph, {k} replays) = {k} eager steps from one key and state: parameters, "
          f"momentum and count max abs err {param_err:.3g} <= 1e-5, metrics rel err {metric_err:.2g} <= 1e-5; "
          f"bit for bit: {bitwise} (cuDNN deterministic algorithms; K1 and K2 deterministic)")

    # a captured loss forward replayed under two keys: fresh noise per replay
    particle = state.params if config["model"] == "bbb" else state.params[0]
    loss_fn = cifar._xent_loss_fn(built.model, augment=config["model"] != "bbb")  # BBB: K1's noise alone
    key_buf = keys.as_key(0, dev)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            loss_fn(particle, {}, NoiseSource(key=key_buf), batches[0])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured_loss = loss_fn(particle, {}, NoiseSource(key=key_buf), batches[0]).loss
        replayed, same = [], True
        for value in (keys.fold_in(9, 1), keys.fold_in(9, 2)):
            key_buf.fill_(value)
            graph.replay()
            replayed.append(captured_loss.clone())
            eager_loss = loss_fn(particle, {}, NoiseSource(key=keys.as_key(value, dev)), batches[0]).loss
            same = same and torch.equal(replayed[-1], eager_loss)
    del graph
    what = "K1's noise" if config["model"] == "bbb" else "the crops"
    check(same and not torch.equal(replayed[0], replayed[1]),
          f"{label}: a captured loss forward replayed under two keys draws two different samples of {what} "
          f"(losses {float(replayed[0]):.6f}, {float(replayed[1]):.6f}), each = the eager forward under its key")
    torch.backends.cudnn.deterministic = False

    single = multistep.make_multi_step(method.update, 1)
    stacked = [multistep.stack_batches([b]) for b in batches]

    def captured_step(i):
        nonlocal state
        state, m = single(state, keys.fold_in(11, i), stacked[i % TIMED_STEPS])
        return m["loss"]

    def eager_step(i):
        nonlocal state
        state, m = method.update(state, NoiseSource(key=keys.as_key(keys.fold_in(11, i), dev)), batches[i % TIMED_STEPS])
        return m["loss"]

    captured_step(0)  # the capture
    times = {"eager": steady_steps(torch, eager_step, f"{label} eager", bs, count=TIMED_STEPS),
             "captured": steady_steps(torch, captured_step, f"{label} captured", bs, count=TIMED_STEPS)}
    profiles = {"eager": profile_steps(torch, eager_step, ours, label="eager steps"),
                "captured": profile_steps(torch, captured_step, ours, label="captured steps (graph replays)")}
    per_replay = profiles["captured"] and profiles["captured"]["launches"]
    if config["model"] == "bbb":
        want = 2 * config["bbb_mc_samples"] * len(bbb_shapes(1))
        check(per_replay is not None and per_replay["_flat_kernel"] == want,
              f"{label}: K1 launches per replayed step, from the profile: {per_replay and per_replay['_flat_kernel']} "
              f"= {want} ({config['bbb_mc_samples'] * len(bbb_shapes(1))} forward + as many backward)")
    else:
        check(per_replay is not None and per_replay["gram_kernel"] == 1,
              f"{label}: K2 launches per replayed step, from the profile: {per_replay and per_replay['gram_kernel']} = 1")

    # eval: the runner against the host loop, warm, on the same keys
    evals, figures = {}, {}
    n_samples = x_test.shape[0] * config["eval_samples"]
    for mode, device_eval in (("runner", True), ("host loop", False), ("host loop", False), ("runner", True)):
        eval_config = {**config, "device_eval": device_eval}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = cifar.eval_model(built, eval_config, x_test, y_test).as_dict()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if mode in evals:  # the second of each: warm
            figures[mode] = n_samples / seconds
        evals[mode] = result
    diff = max(abs(evals["runner"][m] - evals["host loop"][m]) / max(abs(evals["host loop"][m]), 1e-30)
               for m in evals["runner"])
    check(diff <= 1e-5, f"{label}: eval runner = host eval loop on the same keys (metrics max rel diff {diff:.2g} "
          f"<= 1e-5; equal: {evals['runner'] == evals['host loop']})")
    print(f"{label} eval of {x_test.shape[0]} images x S {config['eval_samples']}, warm: runner "
          f"{figures['runner']:.0f} samples/s, host loop {figures['host loop']:.0f} samples/s [{CARD}]")
    eval_profile = profile_steps(torch, lambda i: cifar.eval_model(built, {**config, "device_eval": True}, x_test, y_test),
                                 ours, steps=1, label="runner evals")
    if config["model"] == "bbb":
        want = -(-x_test.shape[0] // config["eval_batch_size"]) * config["eval_samples"] * len(bbb_shapes(1))
        got = eval_profile and eval_profile["launches"]["_frozen_kernel"]
        check(got == want, f"{label}: K1 frozen launches in one runner eval, from the profile: {got} = {want}")
    del built, state, batches, stacked, single, multi, xd, yd
    torch.cuda.empty_cache()
    return {"run_single_s": wall, "steps": times, "profiles": profiles, "eval_samples_per_s": figures,
            "eval_busy": eval_profile and eval_profile["busy"], "captured_equals_eager_bitwise": bitwise,
            "captured_vs_eager_param_err": param_err, "host_counts": counts}


def _variant_runs(torch, cifar, kernels, variants=MULTIX_VARIANTS):
    """The variants through ``run_single`` (MULTIX cut, device_data, the
    test split and DEFAULT's five corrupted splits of 1000 images, S = 50,
    or the row's own S), every count set to 0 just before each and read just
    after; SWAG's ``updates`` per member read from the run's saved
    ``swag_final``. Returns {label: {"wall_s", "host_counts", "updates"}}."""
    runs = {}
    per_forward = len(bbb_shapes(1))
    splits = ["test"] + [f"corrupted{i}" for i in YAML_DEFAULT["corrupted_intensities"]]
    for label, variant in variants:
        config = {**cifar.DEFAULT_CONFIG, **YAML_DEFAULT, **variant, **MULTIX}
        if "swag_start_epoch" in variant:
            config["swag_start_epoch"] = MULTIX_SWAG_START
            config["checkpoint_dir"] = os.path.join(BUILD, "multix_runs", label)
            print(f"{label}: swag_start_epoch cut from {variant['swag_start_epoch']} of "
                  f"{cifar.DEFAULT_CONFIG['epochs']} epochs to {MULTIX_SWAG_START} of {MULTIX['epochs']}")
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = cifar.run_single(config, log=print)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in kernels.items()}
        check(list(results) == splits, f"{label} run_single (device_data): splits {list(results)}")
        for split, m in results.items():
            check(all(math.isfinite(v) for v in m.values()) and 0.0 <= m["accuracy"] <= 1.0
                  and m["avg_log_likelihood"] < 0.0, f"{label} {split}: metrics finite and in range: {json.dumps(m)}")
        members = config["members"]
        want = {name: 0 for name in kernels}
        if config["model"] == "bbb":
            # host counts: the step graph's two warm-ups and capture (every
            # member, mc forwards each) and the eval graph's (S forwards)
            train_forwards = (1 + 2) * members * config["bbb_mc_samples"]
            want["k1_gaussian_sample"] = (train_forwards + (1 + 2) * config["eval_samples"]) * per_forward
            want["k1_gaussian_sample_backward"] = train_forwards * per_forward
        check(counts == want, f"{label} run_single: host launch counts {counts} (warm-ups and captures; replays launch "
                              f"no wrapper)")
        updates = None
        if "checkpoint_dir" in config:
            final = torch.load(os.path.join(config["checkpoint_dir"], "swag_final"), weights_only=True)
            updates = [int(v) for k, v in sorted(final.items()) if k.endswith("swag.updates")]
            check(len(updates) == members and min(updates) >= 2,
                  f"{label}: SWAG collections per member {updates} (each at least 2)")
        print(f"{label} run_single: {MULTIX['epochs']} epochs x {MULTIX['subsample'] // config['batch_size']} replayed "
              f"steps x {members} member(s) + 6 splits x 1000 images x S {config['eval_samples']} in {wall:.1f} s [{CARD}]")
        runs[label] = {"wall_s": wall, "host_counts": counts, "updates": updates}
        torch.cuda.empty_cache()
    return runs


def _built(torch, cifar, variant, steps=TIMED_STEPS, **extra):
    """``variant`` built afresh at full width (the loss augmenting per step,
    as the host loop runs it), with ``steps`` batches of 128 and the test
    split on the card."""
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10

    x, y = load_cifar10(True, subsample=steps * 128)
    x_test, y_test = load_cifar10(False, subsample=1000)
    config = {**cifar.DEFAULT_CONFIG, **YAML_DEFAULT, **variant, "dataset_size": x.shape[0], "epochs": 1, **extra}
    built = cifar.build(config, torch.Generator().manual_seed(1), steps)
    xd, yd = cifar._to_device(built, x, y)
    batches = [(xd[i * 128 : (i + 1) * 128].clone(), yd[i * 128 : (i + 1) * 128].clone()) for i in range(steps)]
    return built, config, batches, (x_test, y_test)


def captured_vs_eager(torch, built, batches, label):
    """COMPARE_STEPS captured steps (one graph, replayed) against as many
    eager ones from one key and state, on cuDNN's deterministic algorithms:
    every tensor the update writes (``written_tensors``: every member's
    parameters and optimizer) and the metrics, ``*_per_member`` included.
    Returns whether they are equal bit for bit."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    k, method, state = COMPARE_STEPS, built.method, built.state
    torch.backends.cudnn.deterministic = True
    written = multistep._written_tensors(state)
    with torch.no_grad():
        saved = [t.clone() for t in written]
    key, step = keys.fold_in(7, 0), state.step
    state, sums = multistep.eager_steps(method.update, state, key, batches[:k])
    eager = [t.clone() for t in written]
    with torch.no_grad():
        for t, v in zip(written, saved):
            t.copy_(v)
    state.step = step
    state, metrics = multistep.make_multi_step(method.update, k)(state, key, multistep.stack_batches(batches[:k]))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    bitwise = all(torch.equal(a, b) for a, b in zip(written, eager))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(written, eager))
    metric_err = max(float(((metrics[n] - sums[n] / k).abs() / (sums[n] / k).abs().clamp_min(1e-30)).max())
                     for n in sums)
    check(bitwise and state.step == step + k and metric_err <= 1e-5,
          f"{label}: {k} captured steps = {k} eager steps from one key and state, bit for bit (all {len(written)} "
          f"written tensors, max abs err {err:.3g}; cuDNN deterministic); metrics {sorted(metrics)} rel err "
          f"{metric_err:.2g} <= 1e-5")
    return bitwise


def eval_runner_vs_host(torch, cifar, built, config, test, label):
    """The eval runner against the host loop on the same keys, warm (each
    run twice, in the order runner, host, host, runner): metrics within
    1e-5 relative, and samples/s of each."""
    x_test, y_test = test
    evals, rates = {}, {}
    n_samples = x_test.shape[0] * config["eval_samples"]
    for mode, device_eval in (("runner", True), ("host loop", False), ("host loop", False), ("runner", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = cifar.eval_model(built, {**config, "device_eval": device_eval}, x_test, y_test).as_dict()
        torch.cuda.synchronize()
        if mode in evals:
            rates[mode] = n_samples / (time.perf_counter() - t0)
        evals[mode] = result
    diff = max(abs(evals["runner"][m] - evals["host loop"][m]) / max(abs(evals["host loop"][m]), 1e-30)
               for m in evals["runner"])
    check(diff <= 1e-5, f"{label}: eval runner = host eval loop on the same keys (metrics max rel diff {diff:.2g} "
          f"<= 1e-5; equal: {evals['runner'] == evals['host loop']})")
    print(f"{label} eval of {x_test.shape[0]} images x S {config['eval_samples']}, warm: runner {rates['runner']:.0f} "
          f"samples/s, host loop {rates['host loop']:.0f} samples/s [{CARD}]")
    return rates


def step_figures(torch, built, batches, label, ours):
    """Steady steps eager (MULTIX_EAGER_STEPS) and captured (TIMED_STEPS,
    one replay a step), CUDA events, and a profile of the captured ones
    (kernels per step, the device's busy share, the ``ours`` kernels per
    step)."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    method, dev = built.method, torch.device("cuda")
    single = multistep.make_multi_step(method.update, 1)
    stacked = [multistep.stack_batches([b]) for b in batches]

    def captured_step(i):
        built.state, m = single(built.state, keys.fold_in(11, i), stacked[i % len(batches)])
        return m["loss"]

    def eager_step(i):
        noise = NoiseSource(key=keys.as_key(keys.fold_in(11, i), dev))
        built.state, m = method.update(built.state, noise, batches[i % len(batches)])
        return m["loss"]

    captured_step(0)  # the capture
    times = {"eager": steady_steps(torch, eager_step, f"{label} eager", 128, count=MULTIX_EAGER_STEPS),
             "captured": steady_steps(torch, captured_step, f"{label} captured", 128, count=TIMED_STEPS)}
    profiles = {"captured": profile_steps(torch, captured_step, ours, label=f"{label} captured steps (graph replays)")}
    return {"steps": times, "profiles": profiles}


def ensemble_card_vs_cpu(torch, cifar, NoiseSource):
    """One DeepEnsemble step (M = 2, batch 4, augmentation off) on the card
    against the CPU path from the same weights: parameters within 1e-5
    absolute, the loss and each member's loss within 1e-5 relative (as the
    SVGD step check); then MultiBBB's log-probs (M = 5, one frozen forward
    per member, 4 images) with the same given noise on both, within 1e-4."""
    config = {**cifar.DEFAULT_CONFIG, "model": "map", "members": 2, "augment": False, "dataset_size": 1280,
              "epochs": 1}
    cpu = cifar.build(config, torch.Generator().manual_seed(4), 10, device="cpu")
    gpu = cifar.build(config, torch.Generator().manual_seed(4), 10)
    gen = torch.Generator().manual_seed(5)
    x, y = torch.randn(4, 3, 32, 32, generator=gen), torch.randint(0, 10, (4,), generator=gen)
    cpu.state, m_cpu = cpu.method.update(cpu.state, NoiseSource.seeded(0), (x, y))
    gpu.state, m_gpu = gpu.method.update(gpu.state, NoiseSource.seeded(0), (x.cuda(), y.cuda()))
    err = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in zip(gpu.state.params.parameters(), cpu.state.params.parameters()))
    loss_err = max(float(((m_gpu[k].cpu() - m_cpu[k]).abs() / m_cpu[k].abs()).max()) for k in ("loss", "loss_per_member"))
    check(err <= 1e-5 and loss_err <= 1e-5,
          f"DeepEnsemble step on the card = CPU path (2 members, batch 4: params max abs err {err:.2e} <= 1e-5; "
          f"loss and per-member loss rel err {loss_err:.1e} <= 1e-5)")

    config = {**cifar.DEFAULT_CONFIG, **dict(MULTIX_VARIANTS)["MultiBBB"], "dataset_size": 1280, "epochs": 1}
    cpu = cifar.build(config, torch.Generator().manual_seed(6), 10, device="cpu")
    gpu = cifar.build(config, torch.Generator().manual_seed(6), 10)
    members = config["members"]
    draws = [torch.randn(s, generator=gen) for _ in range(members) for s in noise_shapes(4, False)]
    with torch.no_grad():
        ref = predict_fn(cpu, x, members, NoiseSource(given=draws))
        out = predict_fn(gpu, x.cuda(), members, NoiseSource(given=[d.cuda() for d in draws])).cpu()
    err = float((out - ref).abs().max())
    check(out.shape == (members, 4, 10) and bool(torch.isfinite(out).all()) and err <= 1e-4,
          f"MultiBBB log-probs on the card = CPU path ({members} members, one frozen forward each, given noise: "
          f"max abs err {err:.2e} <= 1e-4)")
    return err


def predict_fn(built, x, n_samples, noise):
    from beyond_deep_ensembles_tpu_torch.methods import predict

    return predict(built.method, built.state, built.apply_fn, x, n_samples, noise)


class _Preempted(Exception):
    """Stops a run at the end of an epoch, before its checkpoint: the resume
    check's stand-in for a preemption."""


def resume_check(torch, cifar, variant, label):
    """``variant`` over RESUME epochs with ``checkpoint_dir`` and
    ``checkpoint_interval`` 1 (device_data): stopped when epoch 1 ends
    (checkpoint_0 on disk), built afresh and resumed to the end; equal bit
    for bit, on cuDNN's deterministic algorithms, to an uninterrupted run
    without checkpoints: every tensor of the state (MultiSWAG: every
    member's parameters, optimizer, moments, ring and counters; iVON: mean,
    momentum, precision, count; SNGP: parameters, optimizer and buffers)."""
    import shutil

    from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

    run_dir = os.path.join(BUILD, "resume_check", label)
    shutil.rmtree(run_dir, ignore_errors=True)
    config = {**cifar.DEFAULT_CONFIG, **variant, **RESUME}
    config, (x, y), _ = cifar._load_data(config)
    torch.backends.cudnn.deterministic = True
    whole = cifar.train(cifar._build_for(config, None), config, x, y).state.state_dict()

    def stop_after_epoch_1(line):
        print(line)
        if line.startswith("epoch 1:"):
            raise _Preempted(line)

    run = {**config, "checkpoint_dir": run_dir, "checkpoint_interval": 1}
    try:
        cifar.train(cifar._build_for(run, None), run, x, y, log=stop_after_epoch_1)
    except _Preempted:
        pass
    check(ckpt.latest_checkpoint_step(run_dir) == 0, f"resume {label}: stopped after epoch 1 with checkpoint_0 on disk")
    resumed = cifar.train(cifar._build_for(run, None), run, x, y, log=print).state.state_dict()
    torch.backends.cudnn.deterministic = False
    same = whole.keys() == resumed.keys() and all(torch.equal(whole[k], resumed[k]) for k in whole)
    counters = {k: int(v) for k, v in sorted(resumed.items()) if k.endswith(("swag.updates", "ivon.count", "seen_data"))}
    check(same, f"resume: {label} resumed from checkpoint_0 to {config['epochs']} epochs = the uninterrupted run, "
                f"bit for bit ({len(whole)} tensors; counters {counters}; cuDNN deterministic)")
    return same


def multix_check(torch, cifar):
    """Three MAP runs (``run_single`` with ``checkpoint_dir``, seeds 0-2)
    save ``map_final``; ``multix_phase`` with leave_out 0 against
    ``eval_model`` of a deep_ensemble of the other two states, the same
    test split and keys."""
    import shutil

    from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble
    from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
    from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

    dirs = [os.path.join(BUILD, "multix_check", f"rep_{i}") for i in range(3)]
    shutil.rmtree(os.path.join(BUILD, "multix_check"), ignore_errors=True)
    base = {**dict(MULTIX_VARIANTS)["DeepEnsemble"], "members": 1, **MULTIX_CHECK}
    for seed, d in enumerate(dirs):
        cifar.run_single({**base, "seed": seed, "checkpoint_dir": d})
    got = cifar.multix_phase(base, dirs, leave_out=0, log=print)["test"]
    config, built, _, (x_test, y_test) = cifar._rebuild(base)
    states = [ckpt.restore_final(d, "map", cifar._build_for(config, None).state) for d in dirs[1:]]
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    want = cifar.eval_model(built, config, x_test, y_test).as_dict()
    diff = max(abs(got[m] - want[m]) / max(abs(want[m]), 1e-30) for m in want)
    check(diff <= 1e-5, f"multix_phase over 3 saved map_final runs, leave_out 0 = eval_model of a deep_ensemble of "
                        f"the other two (metrics max rel diff {diff:.2g} <= 1e-5; equal: {got == want}): {json.dumps(got)}")
    return diff


def multi_x_phase(torch, cifar, kernels, NoiseSource, single_bbb):
    """The Multi-X slice: the six variants through run_single, captured
    against eager for the ensemble step (map and BBB members) and the MCD
    step, the eval runner against the host loop (DeepEnsemble, MultiSWAG),
    the card against the CPU, resume, the multix phase, then the step and
    eval figures of DeepEnsemble and MultiBBB beside MAP's and BBB's single
    member. Returns the figures."""
    print(f"cut: {MULTIX['epochs']} epochs of {MULTIX['subsample']} synthetic images at batch 128 (configs/cifar.yaml: "
          f"{cifar.DEFAULT_CONFIG['epochs']} epochs of 50,000), each eval split {MULTIX['test_subsample']} images "
          f"(10,000); widths, batch, eval batch and S as the yaml writes them")
    figures = {"runs": _variant_runs(torch, cifar, kernels)}
    variants = dict(MULTIX_VARIANTS)
    bitwise = {}
    for label in ("DeepEnsemble", "MultiBBB", "MCD"):
        built, _, batches, _ = _built(torch, cifar, variants[label], steps=COMPARE_STEPS)
        bitwise[label] = captured_vs_eager(torch, built, batches, label)
        del built, batches
    figures["captured_equals_eager_bitwise"] = bitwise

    evals = {}
    for label, ours in (("DeepEnsemble", ()), ("MultiBBB", ("_flat_kernel", "_frozen_kernel")), ("MAP", ())):
        variant = variants.get(label, {**variants["DeepEnsemble"], "members": 1})
        built, config, batches, test = _built(torch, cifar, variant)
        figures[label] = step_figures(torch, built, batches, label, ours)
        if label != "MAP":
            figures[label]["eval_samples_per_s"] = eval_runner_vs_host(torch, cifar, built, config, test, label)
        if label == "MultiBBB":
            per_replay = figures[label]["profiles"]["captured"]
            want = config["members"] * 2 * config["bbb_mc_samples"] * len(bbb_shapes(1))
            got = per_replay and per_replay["launches"]["_flat_kernel"]
            check(got == want, f"MultiBBB: K1 launches per replayed step, from the profile: {got} = {want} "
                               f"({config['members']} members x {config['bbb_mc_samples'] * len(bbb_shapes(1))} forward "
                               f"+ as many backward)")
        del built, batches
        torch.cuda.empty_cache()
    # MultiSWAG: a few captured steps collecting from the start, then eval
    built, config, batches, test = _built(torch, cifar, variants["MultiSWAG"], steps=COMPARE_STEPS, swag_start_epoch=0)
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    built.state, _ = multistep.make_multi_step(built.method.update, COMPARE_STEPS)(
        built.state, keys.fold_in(13, 0), multistep.stack_batches(batches))
    evals["MultiSWAG"] = eval_runner_vs_host(torch, cifar, built, config, test, "MultiSWAG")
    figures["MultiSWAG"] = {"eval_samples_per_s": evals["MultiSWAG"],
                            "updates": [int(m.updates) for m in built.state.members]}
    del built, batches
    torch.cuda.empty_cache()

    figures["card_vs_cpu_multibbb_logit_err"] = ensemble_card_vs_cpu(torch, cifar, NoiseSource)
    figures["resume_bitwise"] = resume_check(torch, cifar, dict(MULTIX_VARIANTS)["MultiSWAG"], "MultiSWAG")
    figures["multix_rel_diff"] = multix_check(torch, cifar)
    summary = {label: {"captured_median_ms": figures[label]["steps"]["captured"]["median_ms"],
                       "eager_median_ms": figures[label]["steps"]["eager"]["median_ms"],
                       "captured_busy": (figures[label]["profiles"]["captured"] or {}).get("busy")}
               for label in ("DeepEnsemble", "MultiBBB", "MAP")}
    summary["BBB"] = {"captured_median_ms": single_bbb["steps"]["captured"]["median_ms"],
                      "eager_median_ms": single_bbb["steps"]["eager"]["median_ms"],
                      "captured_busy": (single_bbb["profiles"]["captured"] or {}).get("busy")}
    print(f"Multi-X steps, captured against one member of the same run [{CARD}]: {json.dumps(summary)}")
    figures["summary"] = summary
    return figures


def rest_card_vs_cpu(torch, cifar, NoiseSource):
    """One step of Rank1, iVON and SNGP (batch 4, augmentation off) on the
    card against the CPU path from the same weights and the same draws (the
    CPU's, drawn in generator mode and recorded, given to the card): every
    floating tensor of the state within 1e-5 of its largest magnitude (at
    least 1), the integer ones equal, the loss within 1e-5 relative (as the
    DeepEnsemble step check); then a full Laplace fit on 64 images: the GGN
    within 1e-5 of its largest entry, and the card's prior precision scored
    on the CPU's marginal-likelihood curve within 1e-5 relative of the CPU's
    own (the curve is flat at its optimum, so two fp32 searches may stop
    apart). Returns the gaps."""
    from beyond_deep_ensembles_tpu_torch.methods.laplace import laplace_method, log_marginal_likelihood

    class Recording(NoiseSource):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.drawn = []

        def normal(self, shape, device, train, freeze_on_eval):
            eps = super().normal(shape, device, train, freeze_on_eval)
            self.drawn.append(eps.clone())
            return eps

    gen = torch.Generator().manual_seed(5)
    x, y = torch.randn(4, 3, 32, 32, generator=gen), torch.randint(0, 10, (4,), generator=gen)
    variants, gaps = dict(REST_VARIANTS), {}
    for label in ("Rank1", "iVON", "SNGP"):
        config = {**cifar.DEFAULT_CONFIG, **variants[label], "augment": False, "dataset_size": 1280, "epochs": 1}
        cpu = cifar.build(config, torch.Generator().manual_seed(4), 10, device="cpu")
        gpu = cifar.build(config, torch.Generator().manual_seed(4), 10)
        noise = Recording(generator=torch.Generator().manual_seed(0))
        cpu.state, m_cpu = cpu.method.update(cpu.state, noise, (x, y))
        gpu.state, m_gpu = gpu.method.update(gpu.state, NoiseSource(given=[d.cuda() for d in noise.drawn]),
                                             (x.cuda(), y.cuda()))
        a, b = cpu.state.state_dict(), {k: v.cpu() for k, v in gpu.state.state_dict().items()}
        err = max(float((b[k].double() - a[k].double()).abs().max()) / max(float(a[k].double().abs().max()), 1.0)
                  for k in a if a[k].is_floating_point())
        ints = all(torch.equal(a[k], b[k]) for k in a if not a[k].is_floating_point())
        loss_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        check(err <= 1e-5 and ints and loss_err <= 1e-5,
              f"{label} step on the card = CPU path (batch 4, {len(noise.drawn)} draws given: state max err {err:.2e} "
              f"of each tensor's scale <= 1e-5, counters equal; loss rel err {loss_err:.1e} <= 1e-5)")
        gaps[label] = {"state_err": err, "loss_rel_err": loss_err}

    config = {**cifar.DEFAULT_CONFIG, **variants["Laplace"], "dataset_size": 1280, "epochs": 1}
    cpu = cifar.build(config, torch.Generator().manual_seed(4), 10, device="cpu")
    gpu = cifar.build(config, torch.Generator().manual_seed(4), 10)
    xs, ys = torch.randn(64, 3, 32, 32, generator=gen), torch.randint(0, 10, (64,), generator=gen)
    laps = [laplace_method(b.model, hessian="full", regression=False, inner=b.method) for b in (cpu, gpu)]
    (h_cpu, ll_cpu), (h_gpu, ll_gpu) = laps[0].ggn(cpu.state, (xs, ys)), laps[1].ggn(gpu.state, (xs.cuda(), ys.cuda()))
    h_err = float((h_gpu.cpu() - h_cpu).abs().max()) / float(h_cpu.abs().max())
    fit_cpu, fit_gpu = laps[0].fit(cpu.state, (xs, ys)), laps[1].fit(gpu.state, (xs.cuda(), ys.cuda()))
    score = log_marginal_likelihood(h_cpu, ll_cpu, fit_cpu.ll_mean, "full")
    s_cpu, s_gpu = float(score(fit_cpu.prior_prec)), float(score(fit_gpu.prior_prec.cpu()))
    scale_err = float((fit_gpu.scale_tril.cpu() - fit_cpu.scale_tril).abs().max()) / float(fit_cpu.scale_tril.abs().max())
    check(h_err <= 1e-5 and abs(float(ll_gpu) - float(ll_cpu)) <= 1e-5 * abs(float(ll_cpu))
          and s_gpu >= s_cpu - 1e-5 * abs(s_cpu),
          f"Laplace fit on the card = CPU path (full, D = 650, 64 images): GGN max err {h_err:.2e} of its largest entry "
          f"<= 1e-5; prior precision card {float(fit_gpu.prior_prec):.6g}, CPU {float(fit_cpu.prior_prec):.6g}, "
          f"the card's on the CPU's curve {s_gpu:.8g} >= {s_cpu:.8g} - 1e-5 rel; scale_tril max err {scale_err:.2e} of "
          f"its largest entry")
    gaps["Laplace"] = {"ggn_err": h_err, "prior_prec_card": float(fit_gpu.prior_prec),
                       "prior_prec_cpu": float(fit_cpu.prior_prec), "scale_tril_err": scale_err}
    return gaps


def sngp_finalize_ms(torch, built, reps=10):
    """Device time of SNGP's epoch boundary (``recompute_covariance_and_reset``
    of the 1024 x 1024 precision: Cholesky, solve, reset), CUDA events over
    ``reps`` calls after one warm-up."""
    from beyond_deep_ensembles_tpu_torch.nn.sngp import recompute_covariance_and_reset

    ridge = SNGP_HEAD["ridge_penalty"]
    recompute_covariance_and_reset(built.state.params, ridge)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        recompute_covariance_and_reset(built.state.params, ridge)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"SNGP finalize_epoch (1024 x 1024 Cholesky inverse and reset): {ms:.3f} ms [{CARD}]")
    return ms


def laplace_figures(torch, cifar):
    """The Laplace row's fit (``ll_hessian: full``, D = 650) on the phase's
    training set of TIMED_STEPS x 128 images, on a fresh MAP state: the wall
    time of the GGN pass alone and of the whole fit (the GGN pass, the
    marginal-likelihood search on the host, the posterior), then the eval
    runner against the host loop on the fitted state."""
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10
    from beyond_deep_ensembles_tpu_torch.methods.laplace import laplace_method

    built, config, _, test = _built(torch, cifar, dict(REST_VARIANTS)["Laplace"])
    x, y = load_cifar10(True, subsample=TIMED_STEPS * 128)
    data = cifar._to_device(built, x, y)
    lap = laplace_method(built.model, hessian=config["ll_hessian"], regression=False, inner=built.method)
    lap.ggn(built.state, (data[0][:256], data[1][:256]))  # warm-up: cuDNN's and the jacrev's first calls
    times = {}
    for name, fn in (("ggn_s", lambda: lap.ggn(built.state, data)), ("fit_s", lambda: lap.fit(built.state, data))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    fitted = out
    print(f"Laplace fit of {x.shape[0]} images (full, D = 650): GGN pass {times['ggn_s']:.3f} s, whole fit "
          f"{times['fit_s']:.3f} s (the marginal-likelihood search and the posterior {times['fit_s'] - times['ggn_s']:.3f} "
          f"s), prior precision {float(fitted.prior_prec):.5g} [{CARD}]")
    built.method, built.state = lap, fitted
    times["eval_samples_per_s"] = eval_runner_vs_host(torch, cifar, built, config, test, "Laplace")
    del built, data
    torch.cuda.empty_cache()
    return times


def fit_laplace_check(torch, cifar):
    """``fit_laplace_phase`` on the ``map_final`` that the Multi-X phase's
    multix check wrote (rep_0) against the Laplace row's build with that
    state restored, fitted on the same training split and evaluated: the
    same test metrics."""
    from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

    run_dir = os.path.join(BUILD, "multix_check", "rep_0")
    base = {**dict(REST_VARIANTS)["Laplace"], **MULTIX_CHECK}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = cifar.fit_laplace_phase({**base, "from_model": "map"}, run_dir, log=print)["test"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    config, built, (x, y), (x_test, y_test) = cifar._rebuild(base)
    built.state = ckpt.restore_final(run_dir, "map", built.state)
    cifar._fit_laplace(built, config, x, y)
    want = cifar.eval_model(built, config, x_test, y_test).as_dict()
    diff = max(abs(got[m] - want[m]) / max(abs(want[m]), 1e-30) for m in want)
    check(diff <= 1e-5, f"fit_laplace_phase on a saved map_final ({wall:.1f} s) = the Laplace row's fit and eval of the "
                        f"same state (metrics max rel diff {diff:.2g} <= 1e-5; equal: {got == want}): {json.dumps(got)}")
    return diff


def rest_phase(torch, cifar, kernels, NoiseSource):
    """The rest of CIFAR: the six rows through run_single (no kernel of
    the port on their paths: every count 0), captured against eager bit
    for bit for Rank1, iVON and SNGP (SNGP's precision and spectral u
    among the written tensors), step and eval figures of the three, SNGP's
    epoch boundary, the Laplace fit's time and eval, the card against the
    CPU, resumed iVON and SNGP runs, and fit_laplace_phase. Returns the
    figures."""
    print(f"cut: {MULTIX['epochs']} epochs of {MULTIX['subsample']} synthetic images at batch 128 (configs/cifar.yaml: "
          f"{cifar.DEFAULT_CONFIG['epochs']} epochs of 50,000), each eval split {MULTIX['test_subsample']} images "
          f"(10,000); widths, batch, eval batch and S as the yaml writes them; MultiiVON and MultiLaplace 5 members")
    figures = {"runs": _variant_runs(torch, cifar, kernels, REST_VARIANTS)}
    variants = dict(REST_VARIANTS)
    bitwise = {}
    for label in ("Rank1", "iVON", "SNGP"):
        built, _, batches, _ = _built(torch, cifar, variants[label], steps=COMPARE_STEPS)
        bitwise[label] = captured_vs_eager(torch, built, batches, label)
        del built, batches
    figures["captured_equals_eager_bitwise"] = bitwise
    for label in ("Rank1", "iVON", "SNGP"):
        built, config, batches, test = _built(torch, cifar, variants[label])
        figures[label] = step_figures(torch, built, batches, label, ())
        figures[label]["eval_samples_per_s"] = eval_runner_vs_host(torch, cifar, built, config, test, label)
        if label == "SNGP":
            figures[label]["finalize_epoch_ms"] = sngp_finalize_ms(torch, built)
        del built, batches
        torch.cuda.empty_cache()
    figures["Laplace"] = laplace_figures(torch, cifar)
    figures["card_vs_cpu"] = rest_card_vs_cpu(torch, cifar, NoiseSource)
    figures["resume_bitwise"] = {label: resume_check(torch, cifar, variants[label], label) for label in ("iVON", "SNGP")}
    figures["fit_laplace_phase_rel_diff"] = fit_laplace_check(torch, cifar)
    summary = {label: {"captured_median_ms": figures[label]["steps"]["captured"]["median_ms"],
                       "eager_median_ms": figures[label]["steps"]["eager"]["median_ms"],
                       "captured_busy": (figures[label]["profiles"]["captured"] or {}).get("busy")}
               for label in ("Rank1", "iVON", "SNGP")}
    print(f"Rank1, iVON and SNGP steps [{CARD}]: {json.dumps(summary)}")
    figures["summary"] = summary
    return figures


# the UCI phase: configs/uci.yaml through the CLI (run.main) with DEFAULT's
# values (batch 32, eval_samples 1000, learn_var, lr 0.01, std_init 1.0) and
# the grid's nine models; cut: the list of eight data sets to naval (the
# largest: 14 inputs, 11,934 rows, 10,741 train and 1,193 test), epochs 100
# -> 2, repetitions 5 -> 1
UCI_DATASET = "naval"
UCI_CUT_EPOCHS = 2
UCI_STEPS = 20  # steady steps timed, each way
UCI_COMPARE_STEPS = 16  # captured (two replays of a graph of 8) against eager
UCI_SCAN = 8
UCI_CHECK_SAMPLES = 8  # the card-against-CPU evaluate


def uci_yaml_docs():
    import yaml

    with open(os.path.join(ROOT, "configs", "uci.yaml")) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def uci_sweep_file(path):
    """configs/uci.yaml cut as UCI_* says, written to ``path``; returns its
    DEFAULT params."""
    import yaml

    default, sweep = uci_yaml_docs()
    print(f"cut: list dataset {sweep['list']['dataset']} -> [{UCI_DATASET!r}], epochs {default['params']['epochs']} "
          f"-> {UCI_CUT_EPOCHS}, repetitions {default['repetitions']} -> 1; grid {sweep['grid']['model']} and "
          f"DEFAULT's other params kept: {default['params']}")
    default = {**default, "repetitions": 1, "params": {**default["params"], "epochs": UCI_CUT_EPOCHS}}
    sweep = {**sweep, "list": {"dataset": [UCI_DATASET]}}
    with open(path, "w") as f:
        yaml.safe_dump_all([default, sweep], f)
    return default["params"]


def uci_cli_phase(torch, kernels):
    """The CLI's nine naval runs on the card, every count set to 0 just
    before ``run.main`` and read just after: K1 on bbb and bbb_fixed_kl
    only (mc 2 x 2 layers a step, forward and backward; S x 2 frozen at
    evaluate), K2 once a svgd step, K3 never. Each run's five metrics finite
    and QCE in [0, 1]; each run's wall time from its log record."""
    import tempfile

    from beyond_deep_ensembles_tpu_torch import run
    from beyond_deep_ensembles_tpu_torch.data.uci import UCI_SHAPES
    from beyond_deep_ensembles_tpu_torch.experiments import uci
    from beyond_deep_ensembles_tpu_torch.utils.config import load_sweep

    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = os.path.join(tmp, "uci_naval.yaml")
        params = uci_sweep_file(path)
        specs = list(load_sweep(path))
        models = [spec["params"]["model"] for spec in specs]
        check(models == list(uci.MODELS) and all(spec["params"]["dataset"] == UCI_DATASET for spec in specs),
              f"the cut sweep holds the nine models on {UCI_DATASET}: {models}")
        out = os.path.join(tmp, "results")
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.main(["uci", path, "--out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in kernels.items()}
        walls = {}
        for i, model in enumerate(models):
            with open(os.path.join(out, f"yacht_{i}", "rep_0", "metrics.jsonl")) as f:
                record = json.loads(f.read().splitlines()[-1])
            (result,) = record["plain"]
            check(sorted(result) == ["avg_ll", "avg_lml", "mse", "qce", "sqce"]
                  and all(math.isfinite(v) for v in result.values()) and 0.0 <= result["qce"] <= 1.0,
                  f"CLI {model} on {UCI_DATASET}: metrics finite, QCE in [0, 1]: {json.dumps(result)}")
            walls[model] = record["_t"]
    n = UCI_SHAPES[UCI_DATASET][1]
    n_train = n - n // 10
    steps = UCI_CUT_EPOCHS * -(-n_train // params["batch_size"])
    mc, s = uci.DEFAULT_CONFIG["mc_samples"], params["eval_samples"]
    want = {name: 0 for name in kernels}
    want["k1_gaussian_sample"] = 2 * (steps * mc * 2 + s * 2)  # bbb and bbb_fixed_kl
    want["k1_gaussian_sample_backward"] = 2 * steps * mc * 2
    want["k2_svgd_gram"] = steps
    check(counts == want, f"CLI: launch counts {counts} = {want} ({steps} steps a run, mc {mc}, S {s}, 2 BBB layers)")
    print(f"CLI runs on {UCI_DATASET}, wall time each (s) [{CARD}]: {json.dumps(walls)}; run.main {wall:.1f} s")
    return {"wall_s": wall, "run_wall_s": walls, "host_counts": counts, "steps_per_run": steps}


def uci_svgd20_and_gap(torch, kernels, params):
    """SVGD at 20 particles through run_single on naval (K2 at n = 20, once
    a step), then ``run`` of map on yacht with the gap splits (6)."""
    from beyond_deep_ensembles_tpu_torch.data.uci import UCI_SHAPES
    from beyond_deep_ensembles_tpu_torch.experiments import uci

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = uci.result_dict(uci.run_single({**params, "model": "svgd", "svgd_particles": 20, "dataset": UCI_DATASET,
                                          "epochs": 1}))
    wall = time.perf_counter() - t0
    n = UCI_SHAPES[UCI_DATASET][1]
    steps = -(-(n - n // 10) // params["batch_size"])
    check(kernels["k2_svgd_gram"].launches == steps and kernels["k1_gaussian_sample"].launches == 0,
          f"SVGD 20 particles, 1 epoch on {UCI_DATASET}: K2 launched {kernels['k2_svgd_gram'].launches} times "
          f"({steps} steps), K1 never")
    check(all(math.isfinite(v) for v in res.values()) and 0.0 <= res["qce"] <= 1.0,
          f"SVGD 20 particles: metrics {json.dumps(res)} ({wall:.1f} s)")
    t0 = time.perf_counter()
    gap = uci.run({**params, "model": "map", "dataset": "yacht", "epochs": 1, "gap": True})
    gap_wall = time.perf_counter() - t0
    results = gap["plain"] + [g["result"] for g in gap["gap_results"]]
    check([g["gap_split"] for g in gap["gap_results"]] == list(range(6))
          and all(math.isfinite(v) for r in results for v in r.values()),
          f"map on yacht with gap: true: the standard split and 6 gap splits, metrics finite ({gap_wall:.1f} s)")
    return {"svgd20_wall_s": wall, "svgd20": res, "gap_wall_s": gap_wall}


def uci_built(torch, uci, model, params, device=None, **extra):
    """``model`` built on naval at the sweep's params (seed 1), with the
    first UCI_STEPS batches of the run's order on its device."""
    import numpy as np

    from beyond_deep_ensembles_tpu_torch.data.uci import UCIDataset, batch_indices

    ds = UCIDataset(UCI_DATASET)
    x, y = ds.get_arrays("train")
    config = {**uci.DEFAULT_CONFIG, **params, "model": model, "dataset": UCI_DATASET, "in_dim": ds.in_dim, **extra}
    built = uci.build(config, x.shape[0], torch.Generator().manual_seed(1), device=device)
    xd, yd = uci._to_device(built, x, y)
    rows = list(batch_indices(x.shape[0], config["batch_size"], np.random.RandomState(0)))[:UCI_STEPS]
    batches = [(xd[torch.from_numpy(r).to(built.device)], yd[torch.from_numpy(r).to(built.device)]) for r in rows]
    return built, config, batches, ds


def uci_captured_vs_eager(torch, built, batches, label):
    """UCI_COMPARE_STEPS steps through the multi-step runner (two replays of
    a graph of UCI_SCAN steps, the second from the key the first left)
    against as many eager ones from one key and state: every written tensor
    bit for bit."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    method, state, k = built.method, built.state, UCI_COMPARE_STEPS
    written = multistep._written_tensors(state)
    with torch.no_grad():
        saved = [t.clone() for t in written]
    key, step = keys.fold_in(7, 0), state.step
    state, _ = multistep.eager_steps(method.update, state, key, batches[:k])
    eager = [t.clone() for t in written]
    with torch.no_grad():
        for t, v in zip(written, saved):
            t.copy_(v)
    state.step = step
    multi = multistep.make_multi_step(method.update, UCI_SCAN)
    for start in range(0, k, UCI_SCAN):
        state, _ = multi(state, key, multistep.stack_batches(batches[start : start + UCI_SCAN]))
        for _ in range(UCI_SCAN):
            key = keys.advance(key)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(written, eager))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(written, eager))
    check(bitwise and state.step == step + k,
          f"UCI {label}: {k} steps as {k // UCI_SCAN} replays of a graph of {UCI_SCAN} = {k} eager steps from one key "
          f"and state, bit for bit (all {len(written)} written tensors, max abs err {err:.3g})")
    return bitwise


def uci_step_times(torch, built, batches, label):
    """UCI_STEPS steady steps eager and captured (a graph of one step,
    replayed), CUDA events; K1 and K2 host launches per eager step."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import sampling, svgd_kernel
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    method, dev = built.method, torch.device("cuda")
    single = multistep.make_multi_step(method.update, 1)
    stacked = [multistep.stack_batches([b]) for b in batches]

    def captured_step(i):
        built.state, m = single(built.state, keys.fold_in(11, i), stacked[i % len(batches)])
        return m["loss"]

    def eager_step(i):
        built.state, m = method.update(built.state, NoiseSource(key=keys.as_key(keys.fold_in(11, i), dev)),
                                       batches[i % len(batches)])
        return m["loss"]

    eager_step(0)
    before = (sampling.gaussian_sample.launches, sampling.gaussian_sample_backward.launches, svgd_kernel.gram.launches)
    times = {"eager": steady_steps(torch, eager_step, f"UCI {label} eager", 32, count=UCI_STEPS)}
    after = (sampling.gaussian_sample.launches, sampling.gaussian_sample_backward.launches, svgd_kernel.gram.launches)
    per_step = [(b - a) / UCI_STEPS for a, b in zip(before, after)]
    captured_step(0)  # the capture
    times["captured"] = steady_steps(torch, captured_step, f"UCI {label} captured", 32, count=UCI_STEPS)
    print(f"UCI {label}: host launches per eager step: K1 {per_step[0]:g}, K1 backward {per_step[1]:g}, "
          f"K2 {per_step[2]:g}")
    return {**times, "k1_per_step": per_step[0], "k1_backward_per_step": per_step[1], "k2_per_step": per_step[2]}


def uci_eval_rate(torch, uci, built, config, ds):
    """``evaluate`` over the test split at the sweep's S, warm (the second of
    two calls): samples/s, and K1 launches per evaluate."""
    from beyond_deep_ensembles_tpu_torch.ops import sampling

    x, y = ds.get_arrays("test")
    uci.evaluate(built, config, x, y, ds)
    before = sampling.gaussian_sample.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = uci.result_dict(uci.evaluate(built, config, x, y, ds))
    torch.cuda.synchronize()
    rate = x.shape[0] * config["eval_samples"] / (time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in res.values()), f"UCI {config['model']} evaluate: metrics finite")
    return rate, sampling.gaussian_sample.launches - before


def uci_card_vs_cpu(torch, uci, params):
    """One step of map, bbb (the CPU's draws given) and svgd on the card
    against the CPU from the same state: every state tensor within 1e-5 of
    its scale (counters equal); then ``evaluate`` at S = UCI_CHECK_SAMPLES
    with the quantile draw (and bbb's frozen draws) given: the five metrics
    within 1e-5 relative."""
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

    gen = torch.Generator().manual_seed(5)
    worst = {}
    for model in ("map", "bbb", "svgd"):
        cpu, config, batches, ds = uci_built(torch, uci, model, params, device="cpu")
        gpu, _, _, _ = uci_built(torch, uci, model, params)
        gpu.state.load_state_dict(cpu.state.state_dict())
        xb, yb = batches[0]
        train = [torch.randn(shape, generator=gen) for _ in range(2) for shape in ((32, 50), (32, 1))
                 if model == "bbb"]
        cpu.state, _ = cpu.method.update(cpu.state, NoiseSource(given=train), (xb, yb))
        gpu.state, _ = gpu.method.update(gpu.state, NoiseSource(given=[d.cuda() for d in train]),
                                         (xb.cuda(), yb.cuda()))
        mine, ref = gpu.state.state_dict(), cpu.state.state_dict()
        err = 0.0
        for name, value in ref.items():
            got = mine[name].cpu()
            if not value.is_floating_point():
                check(torch.equal(got, value), f"UCI {model} card = CPU: {name} equal")
                continue
            err = max(err, float((got - value).abs().max()) / max(float(value.abs().max()), 1e-30))
        check(err <= 1e-5, f"UCI {model}: one step on the card = CPU (every state tensor within {err:.3g} of its "
                           f"scale, <= 1e-5)")
        x, y = ds.get_arrays("test")
        z = torch.randn(UCI_CHECK_SAMPLES, x.shape[0], 1, generator=gen)
        evals = [d for _ in range(UCI_CHECK_SAMPLES) for d in (torch.randn(50, generator=gen),
                                                               torch.randn(1, generator=gen))] if model == "bbb" else []
        cfg = {**config, "eval_samples": UCI_CHECK_SAMPLES}
        results = []
        for built, device in ((cpu, "cpu"), (gpu, "cuda")):
            given = NoiseSource(given=[d.to(device) for d in evals])
            uci.NoiseSource = lambda **kw: given
            try:
                results.append(uci.result_dict(uci.evaluate(built, cfg, x, y, ds, z=z.to(device))))
            finally:
                uci.NoiseSource = NoiseSource
        rel = max(abs(results[1][k] - results[0][k]) / max(abs(results[0][k]), 1e-30) for k in results[0])
        check(rel <= 1e-5, f"UCI {model}: evaluate at S = {UCI_CHECK_SAMPLES} on the card = CPU (metrics max rel diff "
                           f"{rel:.3g} <= 1e-5): {json.dumps(results[1])}")
        worst[model] = {"state_rel_err": err, "metrics_rel_diff": rel}
    return worst


def uci_kernel_checks(torch, sampling, svgd_kernel, p):
    """K1 at the MLP's planes (train [32, 50] and [32, 1]; frozen eval at
    the naval test split's [1193, 50] and [1193, 1]) against its plain
    version; K2 at (10, P) and (20, P), naval's P, against the fp64 product
    and gram_plain, then its CUDA-graph time beside ``torch.mm``'s (TF32
    off) and its byte bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for shape, frozen in (((32, 50), False), ((32, 1), False), ((1193, 50), True), ((1193, 1), True)):
        mean = torch.randn(shape, device=dev, generator=gen)
        var = torch.rand(shape, device=dev, generator=gen) + 1e-4
        bm, bv = torch.randn(shape[1], device=dev, generator=gen), torch.rand(shape[1], device=dev, generator=gen)
        eps = torch.randn(shape[1:] if frozen else shape, device=dev, generator=gen)
        out = sampling.gaussian_sample(mean, var, bm, bv, eps=eps)
        worst = max(worst, float((out - sampling.gaussian_sample_plain(mean, var, bm, bv, eps)).abs().max()))
        drawn = sampling.gaussian_sample(mean, var, bm, bv, seed=9, frozen=frozen)
        row = sampling.gaussian_sample(torch.zeros((1,) + shape[1:], device=dev),
                                       torch.ones((1,) + shape[1:], device=dev), seed=9)
        ones = torch.ones(shape, device=dev)
        z = row[0] if frozen else sampling.gaussian_sample(torch.zeros_like(ones), ones, seed=9)
        worst = max(worst, float((drawn - sampling.gaussian_sample_plain(mean, var, bm, bv, z)).abs().max()))
    torch.cuda.synchronize()
    check(worst <= 1e-6, f"K1 at the UCI MLP's train and eval planes = plain, given noise and Philox draws "
                         f"(max abs err {worst:.3g} <= 1e-6)")
    figures = {"k1_max_abs_err": worst}
    for n in (10, 20):
        x = torch.randn(n, p, device=dev, generator=gen) + torch.randn(1, p, device=dev, generator=gen)
        err, _ = k2_check(torch, svgd_kernel, x)
        before = svgd_kernel.gram.launches
        svgd_kernel.gram(x)
        check(svgd_kernel.gram.launches == before + 1, f"K2 ({n}, {p}): one launch")
        def per_launch(fn, reps=20):  # reps launches in one graph: no replay overhead in the figure
            def repeated():
                for _ in range(reps):
                    fn(x)
            return graph_ms(torch, repeated, reps=5) / reps

        with torch.no_grad():  # in turns: kernel, library, kernel, library, plain
            ms = per_launch(svgd_kernel.gram)
            lib_ms = per_launch(lambda t: torch.mm(t, t.T))
            ms2 = per_launch(svgd_kernel.gram)
            lib_ms2 = per_launch(lambda t: torch.mm(t, t.T))
            plain_ms = per_launch(svgd_kernel.gram_plain)
        n_bytes = 4 * n * p + 4 * n * n
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * n * p / FP32_FLOPS_PER_S * 1e3
        print(f"K2 ({n}, {p}), 20 launches in a CUDA graph, per launch: kernel {ms * 1e3:.2f} / {ms2 * 1e3:.2f} us, "
              f"torch.mm (TF32 off) {lib_ms * 1e3:.2f} / {lib_ms2 * 1e3:.2f} us, gram_plain {plain_ms * 1e3:.2f} us, "
              f"bound {max(bytes_ms, ops_ms) * 1e3:.4f} us ({n_bytes} bytes; fp32 ops {ops_ms * 1e3:.4f} us) [{CARD}]")
        figures[f"k2_{n}"] = {"shape": [n, p], "ms": min(ms, ms2), "library_ms": min(lib_ms, lib_ms2),
                              "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "max_abs_err": err}
    return figures


def uci_phase(torch, kernels):
    """UCI regression (configs/uci.yaml) on the card: the CLI's nine naval
    runs, SVGD at 20 particles and a gap run, captured against eager for
    map, bbb and svgd, steady steps of map, bbb, svgd (10 and 20), ivon,
    evaluate's rate, the card against the CPU, K1 and K2 at the slice's
    shapes. Returns the figures."""
    from beyond_deep_ensembles_tpu_torch.experiments import uci
    from beyond_deep_ensembles_tpu_torch.ops import sampling, svgd_kernel

    figures = {"cli": uci_cli_phase(torch, kernels)}
    params = uci_yaml_docs()[0]["params"]
    figures.update(uci_svgd20_and_gap(torch, kernels, params))
    torch.backends.cudnn.deterministic = True
    figures["captured_equals_eager_bitwise"] = {}
    for model in ("map", "bbb", "svgd"):
        built, _, batches, _ = uci_built(torch, uci, model, params)
        figures["captured_equals_eager_bitwise"][model] = uci_captured_vs_eager(torch, built, batches, model)
    torch.backends.cudnn.deterministic = False
    figures["steps"] = {}
    for label, model, extra in (("map", "map", {}), ("bbb", "bbb", {}), ("svgd10", "svgd", {}),
                                ("svgd20", "svgd", {"svgd_particles": 20}), ("ivon", "ivon", {})):
        built, config, batches, ds = uci_built(torch, uci, model, params, **extra)
        figures["steps"][label] = uci_step_times(torch, built, batches, label)
        if label in ("map", "bbb"):
            rate, k1 = uci_eval_rate(torch, uci, built, config, ds)
            figures["steps"][label].update({"eval_samples_per_s": rate, "k1_per_evaluate": k1})
            print(f"UCI {label} evaluate, {UCI_DATASET} test split x S {config['eval_samples']}, warm: {rate:.0f} "
                  f"samples/s; K1 {k1} launches [{CARD}]")
        del built, batches
    figures["card_vs_cpu"] = uci_card_vs_cpu(torch, uci, params)
    p = sum(t.numel() for t in uci_built(torch, uci, "map", params, device="cpu")[0].state.params.parameters())
    figures["kernels"] = uci_kernel_checks(torch, sampling, svgd_kernel, p)
    summary = {label: {"eager_median_ms": f["eager"]["median_ms"], "captured_median_ms": f["captured"]["median_ms"]}
               for label, f in figures["steps"].items()}
    print(f"UCI steps [{CARD}]: {json.dumps(summary)}")
    figures["summary"] = summary
    return figures


def build_phase(torch, _cuda_build):
    """Both CUDA C++ sources compiled at once, one nvcc each; their build time
    and ptxas report (registers, spills). Triton compiles K1 at first launch."""
    t0 = time.perf_counter()
    _cuda_build.build("svgd_gram.cu", "dropout_attention.cu")
    print(f"K2 and K3 built in {time.perf_counter() - t0:.2f} s (two nvcc processes at once)")
    for source, log in sorted(_cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  nvcc {source}: {line.strip()}")


def events_ms(torch, fn, reps=30):
    """Device time of one call of ``fn`` between CUDA events after a warm-up,
    for calls that a CUDA graph cannot capture (autograd's backward); each
    call is about a millisecond of work, so its launch cost does not show."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k3_inputs(torch, shape, seed):
    """q, k, v, dO ``[B, L, H, D]`` and a key mask with ragged padding on
    three rows: inside a tile (row 0 from 300, row 1 from 77) and of whole
    tiles (row 2 from 64). At L = 300 row 0 keeps all its keys."""
    b, h, l, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, l, h, d, device="cuda", generator=gen) for _ in range(4))
    mask = torch.ones(b, l, dtype=torch.int32, device="cuda")
    mask[0, 300:] = 0
    mask[1, 77:] = 0
    mask[2, 64:] = 0
    return q, k, v, do, mask


def with_grads(torch, fn, q, k, v, do):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    return out.detach(), grads


def k3_hold(torch, label, out, ref, grads, ref_grads):
    """Outputs within 1e-5 absolute; gradients within 3e-5 + 3e-4 |ref| (the
    JAX kernel test's gradient tolerance). Returns the max abs errors of the
    output and of the gradients."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(err <= 1e-5, f"K3a {label} = plain (max abs err {err:.3g} <= 1e-5)")
    worst = max(float(((g - r).abs() - 3e-4 * r.abs()).max()) for g, r in zip(grads, ref_grads))
    gerr = max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads))
    check(worst <= 3e-5, f"K3b {label}: dQ, dK, dV = plain autograd (max abs err {gerr:.3g}, within 3e-5 + 3e-4 |ref|)")
    return err, gerr


def in_turns(timers, rounds=2):
    """Each of ``timers`` (name -> a function that returns one time in ms)
    run in turns, first to last and then last to first (kernel, library,
    library, kernel), ``rounds`` times over: {name: its times, sorted}."""
    times = {name: [] for name in timers}
    for _ in range(rounds):
        for order in (list(timers), list(reversed(timers))):
            for name in order:
                times[name].append(timers[name]())
    return {name: sorted(v) for name, v in times.items()}


def k3_checks(torch, att, shape):
    """K3a and K3b against the plain version at ``shape``: p = 0, a given
    mask, and Philox (keep rate, bit-identical repeats of the output and of
    dQ, dK, dV, another seed's mask, the realized mask fed to the plain
    version). Returns the max abs errors (output, gradients)."""
    b, h, l, d = shape
    q, k, v, do, mask = k3_inputs(torch, shape, seed=b + l)
    given = torch.rand(b, h, l, l, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3)) >= K3_P
    worst = (0.0, 0.0)
    for p, keep, label in ((0.0, None, f"{shape} p = 0"), (K3_P, given, f"{shape} given mask, p = {K3_P}")):
        out, grads = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, keep=keep),
                                q, k, v, do)
        ref, ref_grads = with_grads(torch, lambda *t: att.dropout_attention_plain(*t, mask, keep, dropout_p=p),
                                    q, k, v, do)
        worst = tuple(map(max, worst, k3_hold(torch, label, out, ref, grads, ref_grads)))
        del out, grads, ref, ref_grads
    del given

    # Philox: the keep rate over unpadded keys, bit-identical repeats,
    # another seed another mask, and the output and gradients equal to
    # the plain version fed the realized mask (a kept probability that
    # underflows to 0 counts nothing either way)
    out, probs = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=K3_P, seed=1234)
    out2, probs2 = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=K3_P, seed=1234)
    check(torch.equal(out, out2) and torch.equal(probs, probs2), f"K3a {shape} Philox: repeat runs equal bit for bit")
    del out2, probs2
    _, other = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=K3_P, seed=1235)
    changed = float(((probs > 0) != (other > 0)).float().mean())
    check(changed > 0.05, f"K3a {shape} Philox: seed 1235 draws another mask ({changed:.3f} of the elements differ)")
    del other
    unpadded = (mask > 0)[:, None, None, :].expand(b, h, l, l)
    kept = int(((probs > 0) & unpadded).sum())
    n = int(unpadded.sum())
    rate, sigma = kept / n, (K3_P * (1 - K3_P) / n) ** 0.5
    check(abs(rate - (1 - K3_P)) < 6 * sigma,
          f"K3a {shape} Philox: keep rate {rate:.6f} over {n} unpadded elements, within 6 sigma ({sigma:.2e}) of {1 - K3_P}")
    realized = probs > 0
    del unpadded
    main, grads = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=K3_P, seed=1234),
                             q, k, v, do)
    check(torch.equal(main, out), f"K3a {shape}: the main entry draws the debug entry's mask")
    _, grads2 = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=K3_P, seed=1234),
                           q, k, v, do)
    check(all(torch.equal(g, g2) for g, g2 in zip(grads, grads2)),
          f"K3b {shape} Philox: dQ, dK, dV of repeat runs equal bit for bit")
    del grads2
    ref, ref_grads = with_grads(torch, lambda *t: att.dropout_attention_plain(*t, mask, realized, dropout_p=K3_P),
                                q, k, v, do)
    worst = tuple(map(max, worst, k3_hold(torch, f"{shape} Philox, realized mask", out, ref, grads, ref_grads)))
    del out, probs, realized, main, grads, ref, ref_grads, q, k, v, do
    torch.cuda.empty_cache()
    return worst


def k3_times(torch, att, shape):
    """Times at p = 0.1, Philox, at ``shape``: K3a and K3b through the
    wrappers that count launches, replayed in CUDA graphs; the plain version
    with its mask drawn (torch.rand) and SDPA in graphs; the plain version's
    backward (autograd) and SDPA's backward between events after a warm-up.
    Kernel and yardsticks run in turns (kernel, SDPA, plain, plain, SDPA,
    kernel, twice over); each row keeps the minimum and prints the spread."""
    import torch.nn.functional as F

    b, h, l, d = shape
    q, k, v, do, mask = k3_inputs(torch, shape, seed=b)
    bias = att.key_bias(mask)
    o, lse, _ = att.attention_forward(q, k, v, bias, K3_P, 5, None)
    drop_mask = (mask > 0)[:, None, None, :]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D] views, no copy

    def sdpa(p):
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=drop_mask, dropout_p=p)

    sdpa_p = K3_P
    with torch.no_grad():
        try:
            graph_ms(torch, sdpa(sdpa_p), reps=2)
        except RuntimeError as exc:
            print(f"SDPA with dropout refused CUDA graph capture ({str(exc).splitlines()[0][:120]}); timed at p = 0")
            sdpa_p = 0.0
        forward = in_turns({
            "kernel": lambda: graph_ms(torch, lambda: att.attention_forward(q, k, v, bias, K3_P, 5, None), reps=20),
            "library": lambda: graph_ms(torch, sdpa(sdpa_p), reps=20),
            "plain": lambda: graph_ms(torch, lambda: att.dropout_attention_plain(
                q, k, v, mask, torch.rand(b, h, l, l, device="cuda") >= K3_P, dropout_p=K3_P), reps=10),
        })
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    keep = torch.rand(b, h, l, l, device="cuda") >= K3_P
    plain_out = att.dropout_attention_plain(*leaves, mask, keep, dropout_p=K3_P)
    sdpa_out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves), attn_mask=drop_mask,
                                              dropout_p=K3_P).transpose(1, 2)
    backward = in_turns({
        "kernel": lambda: graph_ms(
            torch, lambda: att.attention_backward(q, k, v, bias, K3_P, 5, None, o, lse, do), reps=20),
        "library": lambda: events_ms(torch, lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True)),
        "plain": lambda: events_ms(torch, lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True)),
    })
    del plain_out, sdpa_out, keep, leaves

    panel = 4 * b * l * h * d
    fwd_bytes = 4 * panel + 4 * b * l + 4 * b * h * l  # q, k, v, bias in; o, lse out
    bwd_bytes = 8 * panel + 4 * b * l + 4 * b * h * l  # q, k, v, o, dO, bias, lse in; dq, dk, dv out
    rows = {}
    for label, times, lib_p, n_bytes, ops in (
        ("K3a", forward, sdpa_p, fwd_bytes, 4 * b * h * l * l * d),
        ("K3b", backward, K3_P, bwd_bytes, 10 * b * h * l * l * d),
    ):
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        fp32_ms = ops / FP32_FLOPS_PER_S * 1e3
        # the unit the kernels use: three TF32 tensor-core products per fp32-accurate operation
        tf32x3_ms = 3 * ops / TF32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, tf32x3_ms)
        t = times["kernel"][0]
        # library_p: the dropout rate SDPA was timed at (0 where graph
        # capture refused its dropout)
        rows[label] = {"ms": t, "plain_ms": times["plain"][0], "library_ms": times["library"][0], "library_p": lib_p,
                       "bound_ms": bound, "bound_by": "bytes" if bytes_ms >= tf32x3_ms else "operations (3xTF32)",
                       "bound_fp32_cores_ms": max(bytes_ms, fp32_ms)}
        spread = "; ".join(f"{name} min {v[0]:.4f}, max {v[-1]:.4f} over {len(v)} turns" for name, v in times.items())
        print(f"{label} {shape}, p = {K3_P} (SDPA, the library call, at p = {lib_p}): {spread} (ms)")
        print(f"{label} {shape}: kernel {t:.4f} ms; bound {bound:.4f} ms by 3xTF32 operations at 495 TFLOP/s "
              f"(kernel at {100 * bound / t:.0f}% of it), {fp32_ms:.4f} ms by fp32 operations at 67 TFLOP/s on the "
              f"CUDA cores ({100 * min(fp32_ms / t, 1.0):.0f}%), bytes {bytes_ms:.4f} ms; "
              f"kernel / SDPA {t / times['library'][0]:.2f}")
    del q, k, v, do, o, lse, bias
    torch.cuda.empty_cache()
    return rows


def k3_phase(torch, att):
    """K3a and K3b against the plain version at the Amazon shapes and at a
    ragged length, the Philox mask's statistics and regeneration, then the
    times of K3a, K3b, the plain version and SDPA (``library_ms`` only) at
    the Amazon shapes, p = 0.1."""
    errs = {shape: k3_checks(torch, att, shape) for shape in K3_SHAPES + [K3_RAGGED_SHAPE]}
    timings = {shape: k3_times(torch, att, shape) for shape in K3_SHAPES}
    main_shape = K3_SHAPES[0]
    return {name: {**timings[main_shape][name], "max_abs_err": errs[main_shape][i]} for i, name in enumerate(("K3a", "K3b"))}


def bert_masks(gen, batch, cfg, seq=512):
    """Given keep masks for one full-model MC-Dropout forward of the
    DistilBERT classifier, in the order it draws them: the embedding
    dropout; per layer, the attention's ``[B, H, L, L]`` and the FFN's; the
    head's."""
    import torch

    def draw(shape, rate):
        return torch.rand(shape, generator=gen) >= rate

    masks = [draw((batch, seq, cfg.dim), cfg.dropout)]
    for _ in range(cfg.n_layers):
        masks += [draw((batch, cfg.n_heads, seq, seq), cfg.attention_dropout), draw((batch, seq, cfg.dim), cfg.dropout)]
    return masks + [draw((batch, cfg.dim), MCD_VARIANT["dropout_p"])]


def bert_card_vs_cpu(torch, wilds_task, NoiseSource):
    """The MCD DistilBERT (full width, 6 layers) built twice from one seed, on
    the card and on the CPU, held together on 2 synthetic reviews (one padded
    from token 400) with the same given masks: the logits of a sampling eval
    forward (<= 1e-4), and one Adam step: the loss (1e-5 relative), every
    gradient (1e-4 of its tensor's largest, plus 1e-6: the k_lin biases'
    gradient is 0 in exact arithmetic, the softmax being blind to a per-row
    shift, so only rounding is left there) and the step of every element
    whose gradient with weight decay exceeds 1e-5 (1e-3 lr, plus the two
    roundings of p + step, 2^-22 |p|; Adam's first step is lr g / (|g| +
    1e-8), which rounding sets where g is near 0)."""
    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds

    config = {**wilds_task.DEFAULT_CONFIG, **AMAZON_DEFAULT, **MCD_VARIANT}
    cpu = wilds_task.build("amazon", config, torch.Generator().manual_seed(11), device="cpu")
    gpu = wilds_task.build("amazon", config, torch.Generator().manual_seed(11))
    sd_cpu, sd_gpu = cpu.state.params.state_dict(), gpu.state.params.state_dict()
    check(all(torch.equal(sd_cpu[key], sd_gpu[key].cpu()) for key in sd_cpu),
          "DistilBERT built on the card and on the CPU from one seed: equal weights")
    x, y, _ = load_wilds("amazon", "test", subsample=2)
    x = torch.from_numpy(x)
    x[1, 400:, 1] = 0
    y = torch.from_numpy(y)
    cfg = cpu.state.params.bert.config
    gen = torch.Generator().manual_seed(12)

    masks = bert_masks(gen, 2, cfg)
    with torch.no_grad():
        ref = cpu.state.params(x, NoiseSource(given=masks), train=False)
        out = gpu.state.params(x.cuda(), NoiseSource(given=[m.cuda() for m in masks]), train=False).cpu()
    err = float((out - ref).abs().max())
    check(out.shape == (2, 5) and bool(torch.isfinite(out).all()) and err <= 1e-4,
          f"DistilBERT MCD logits on the card = CPU path (given masks, max abs err {err:.2e} <= 1e-4)")

    masks = bert_masks(gen, 2, cfg)
    before = {k: p.detach().clone() for k, p in cpu.state.params.named_parameters()}
    cpu.state, m_cpu = cpu.method.update(cpu.state, NoiseSource(given=masks), (x, y))
    gpu.state, m_gpu = gpu.method.update(gpu.state, NoiseSource(given=[m.cuda() for m in masks]), (x.cuda(), y.cuda()))
    loss_err = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    lr, wd = config["lr"], config["weight_decay"]
    grad_share, step_share, step_err, excluded = 0.0, 0.0, 0.0, 0
    gpu_params = dict(gpu.state.params.named_parameters())
    for key, p in cpu.state.params.named_parameters():
        g, gg = p.grad, gpu_params[key].grad.cpu()
        grad_share = max(grad_share, float((gg - g).abs().max()) / (1e-4 * float(g.abs().max()) + 1e-6))
        sure = (g + wd * before[key]).abs() > 1e-5
        excluded += int((~sure).sum())
        if sure.any():
            gap = (gpu_params[key].detach().cpu() - p.detach())[sure].abs()
            step_err = max(step_err, float(gap.max()))
            step_share = max(step_share, float((gap / (1e-3 * lr + 2.0**-22 * before[key][sure].abs())).max()))
    check(loss_err <= 1e-5 and grad_share <= 1.0 and step_share <= 1.0,
          f"DistilBERT MCD Adam step on the card = CPU path (loss rel err {loss_err:.1e} <= 1e-5; gradients at "
          f"{grad_share:.3f} of their bound; parameters after the step max abs err {step_err:.2e}, at "
          f"{step_share:.3f} of 1e-3 lr plus two roundings of the parameter, over the elements whose gradient "
          f"exceeds 1e-5; {excluded} elements below it)")


def run_bert_slice(torch, wilds_task, kernels, variant, label):
    """``variant`` of configs/amazon.yaml through the entry points: build ->
    train (10 steps at batch 8) -> eval_task (32 reviews, eval batch 16, 10
    samples), every kernel's count set to 0 just before train and read after
    train and after eval. Returns the built experiment, the counts {name:
    (train, eval)} and a closure that runs one steady train step."""
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

    config = {**wilds_task.DEFAULT_CONFIG, **AMAZON_DEFAULT, **variant, **BERT_SMOKE}
    x, y, xt, yt, mt = wilds_task._load_task_data("amazon", config)
    steps = x.shape[0] // config["batch_size"]
    check(steps == TRAIN_STEPS and x.shape[1:] == (512, 2),
          f"{label}: {steps} train steps of batch {config['batch_size']} at L = {x.shape[1]}")
    t0 = time.perf_counter()
    built = wilds_task.build("amazon", config, torch.Generator().manual_seed(config["seed"]))
    n_params = sum(p.numel() for p in built.state.params.parameters())
    check(built.device.type == "cuda" and 66_000_000 < n_params < 68_000_000,
          f"{label}: build() defaults to the card; distilbert-base + head: {n_params} parameters "
          f"(built in {time.perf_counter() - t0:.2f} s)")

    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    for fn in kernels.values():
        fn.launches = 0
    start.record()
    wilds_task.train(built, config, x, y, log=print)  # raises on a non-finite loss
    mid.record()
    trained = {name: fn.launches for name, fn in kernels.items()}
    result = wilds_task.eval_task(built, "amazon", config, xt, yt, mt)
    end.record()
    counts = {name: (trained[name], fn.launches - trained[name]) for name, fn in kernels.items()}
    end.synchronize()
    check(all(bool(torch.isfinite(p).all()) for p in built.state.params.parameters()),
          f"{label}: parameters finite after training")
    check(all(isinstance(v, (int, float)) and v == v and abs(v) != float("inf") for v in result.values()),
          f"{label}: eval metrics finite: {json.dumps(result)}")
    check(all(0.0 <= result[key] <= 1.0 for key in ("accuracy", "10th_percentile_acc", "worst_user_acc", "ece"))
          and result["avg_log_likelihood"] < 0.0 and result["n_users"] > 0, f"{label}: eval metrics in range")
    train_ms, eval_ms = start.elapsed_time(mid), mid.elapsed_time(end)
    n_eval = xt.shape[0] * config["eval_samples"]
    print(f"{label} train: {TRAIN_STEPS} steps in {train_ms:.1f} ms = {train_ms / TRAIN_STEPS:.2f} ms/step (first steps included)")
    print(f"{label} eval: {xt.shape[0]} reviews x {config['eval_samples']} samples in {eval_ms:.1f} ms = "
          f"{n_eval / eval_ms * 1e3:.1f} samples/s")

    xd = torch.from_numpy(x).cuda()
    yd = torch.from_numpy(y).cuda()
    noise = NoiseSource.seeded(1)
    bs = config["batch_size"]

    def step(i):
        idx = slice((i % TRAIN_STEPS) * bs, (i % TRAIN_STEPS + 1) * bs)
        built.state, m = built.method.update(built.state, noise, (xd[idx], yd[idx]))
        return m["loss"]

    return built, counts, config, step


# The WILDS text phase: configs/amazon.yaml and configs/civilcomments.yaml
# through run.main at distilbert-base's full width, each row cut in data
# and epochs only: one epoch of 8 steps (64 Amazon reviews at batch 8, 128
# comments at batch 16), 64 test examples (4 Amazon eval batches of 16, 2
# CivilComments batches of 32) at the rows' S; SWAG's collections in
# proportion (3 of 5 epochs -> from the cut's first step; 50 collections
# over 2 epochs -> 4 over 8 steps); MAP run twice (repetitions 2) for the
# multix phase, every other row once
WILDS_STEPS = 8
WILDS_TEST = 64
WILDS_SWAG = {"swag_start_epoch": 0, "swag_updates": 4}
WILDS_ROWS = {
    "amazon": ["MAP", "MCD", "SWAG", "SWAG_LL", "BBB", "Rank1", "SVGD", "iVON", "LL_iVON", "Laplace", "SNGP"],
    "civilcomments": ["MAP", "MCD", "SWAG", "BBB", "Rank1", "LL_SVGD", "LL_iVON", "Laplace", "SNGP"],
}
# K3 at CivilComments' train shape (B, H, L, D); the card-against-CPU steps
# at one layer of distilbert-base's width (dim 768, 12 heads, FFN 3072), a
# vocabulary of 2048 (the token ids taken modulo it) so that the CPU side's
# steps stay short, L = 128, batch 4
K3_CIVIL_SHAPE = (16, 12, 300, 64)
WILDS_CPU_CHECK = {"bert_config": {"n_layers": 1, "vocab_size": 2048}, "seq": 128, "batch": 4}


def wilds_yaml_docs(task):
    import yaml

    with open(os.path.join(ROOT, "configs", f"{task}.yaml")) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def wilds_sweep_file(task, path):
    """configs/<task>.yaml cut as WILDS_* says, written to ``path``; returns
    {row: its params, DEFAULT's merged under}."""
    import yaml

    docs = wilds_yaml_docs(task)
    default = docs[0]
    batch = default["params"]["batch_size"]
    cut = {"epochs": 1, "subsample": WILDS_STEPS * batch, "test_subsample": WILDS_TEST}
    print(f"{task} cut: epochs {default['params']['epochs']} -> 1, subsample -> {cut['subsample']} "
          f"({WILDS_STEPS} steps of {batch}), test_subsample -> {WILDS_TEST}, repetitions {default['repetitions']} "
          f"-> 1 (MAP 2); SWAG {WILDS_SWAG}; the rows' other params kept: {json.dumps(default['params'])}")
    out = [{**default, "repetitions": 1, "params": {**default["params"], **cut}}]
    for doc in docs[1:]:
        params = dict(doc["params"])
        if params["model"] in ("swag", "swag_ll"):
            params.update(WILDS_SWAG)
        out.append({**doc, "params": params, **({"repetitions": 2} if doc["name"] == "MAP" else {})})
    with open(path, "w") as f:
        yaml.safe_dump_all(out, f)
    return {d["name"]: {**out[0]["params"], **d["params"]} for d in out[1:]}


def wilds_expected_counts(config, layers):
    """The exact host launch counts of one row's run_single on the card:
    train (one update per call: every forward launches K3a once a layer and
    its backward K3b once a layer; BBB's two head layers K1 forward and
    backward; K2 once an SVGD step), the Laplace fit's one forward pass
    (K3a), and eval through the eval runner, whose host counters see its two
    warm-ups and its capture, never a replay (S forwards a batch, one for
    SNGP's multisample; BBB's head K1 frozen, twice a forward)."""
    model = config["model"]
    forwards = {"svgd": config["svgd_particles"], "ll_svgd": config["svgd_particles"],
                "ivon": config["ivon_mc_samples"], "ll_ivon": config["ivon_mc_samples"]}.get(model, 1)
    eval_forwards = 3 * (1 if model == "sngp" else config["eval_samples"])
    k3a = WILDS_STEPS * forwards * layers + (layers if model == "laplace" else 0) + eval_forwards * layers
    bbb = model in ("bbb", "ll_bbb")
    return {
        "k1_gaussian_sample": (WILDS_STEPS * 2 + eval_forwards * 2) if bbb else 0,
        "k1_gaussian_sample_backward": WILDS_STEPS * 2 if bbb else 0,
        "k2_svgd_gram": WILDS_STEPS if model in ("svgd", "ll_svgd") else 0,
        "k3a_attention_forward": k3a,
        "k3b_attention_backward": WILDS_STEPS * forwards * layers,
    }


def wilds_cli_rows(torch, task, kernels, out):
    """Every row of configs/<task>.yaml through ``run.main`` (``--name`` a
    row at a time), every count set to 0 just before and read just after:
    the counts exact (``wilds_expected_counts``), the metrics finite and in
    range, the wall time and peak device memory. Each row's checkpoints are
    deleted after it but MAP's, MCD's and Laplace's run directory, which the
    phases read."""
    import shutil
    import tempfile

    from beyond_deep_ensembles_tpu_torch import run
    from beyond_deep_ensembles_tpu_torch.experiments import wilds_task

    sweep = os.path.join(out, f"{task}.yaml")
    rows = wilds_sweep_file(task, sweep)
    layers = wilds_task._bert_config({}).n_layers
    figures, results = {}, {}
    for name in WILDS_ROWS[task]:
        config = {**wilds_task.DEFAULT_CONFIG, **rows[name]}
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run.main([task, sweep, "--name", name, "--out", out, "--rep", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}
        want = wilds_expected_counts(config, layers)
        check(counts == want, f"{task} {name}: launch counts {counts} = {want}")
        run_dir = os.path.join(out, f"{name}_0", "rep_0")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            result = {k: v for k, v in json.loads(f.read().splitlines()[-1]).items() if not k.startswith("_")}
        check(all(math.isfinite(v) for v in result.values() if isinstance(v, (int, float)))
              and 0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0,
              f"{task} {name}: metrics finite and in range: {json.dumps({k: result[k] for k in ('accuracy', 'avg_log_likelihood', 'ece')})}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        figures[name] = {"wall_s": wall, "peak_gib": peak, "counts": counts}
        results[name] = result
        print(f"{task} {name} through run.main: {wall:.1f} s, peak device memory {peak:.2f} GiB [{CARD}]")
        if name not in ("MAP", "MCD", "Laplace"):
            shutil.rmtree(os.path.join(out, f"{name}_0"), ignore_errors=True)
        torch.cuda.empty_cache()
    run.main([task, sweep, "--name", "MAP", "--out", out, "--rep", "1"])  # multix's second member
    return rows, results, figures


def wilds_phases(torch, task, rows, results, out):
    """The checkpoint phases through ``run.main`` on what the rows wrote:
    ``eval`` of MAP's ``map_final`` = the MAP run's own eval;
    ``fit_laplace`` of it (copied into the Laplace row's run directory, so
    that the phase takes that row's ``ll_hessian``) = the Laplace row's eval
    (the same MAP training, then the fit); ``drop_rates`` of MCD's ``mcd_final`` at p = 0.2 = the
    MCD run's eval; ``multix`` over MAP's two repetitions = eval_task of a
    deep_ensemble of the two restored states. Each within 1e-5 relative."""
    import shutil

    from beyond_deep_ensembles_tpu_torch import run
    from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble
    from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
    from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
    from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

    sweep = os.path.join(out, f"{task}.yaml")

    def last(path):
        with open(path) as f:
            return {k: v for k, v in json.loads(f.read().splitlines()[-1]).items() if not k.startswith("_")}

    def close(got, want):
        return max(abs(got[m] - want[m]) / max(abs(want[m]), 1e-30) for m in want if isinstance(want[m], float))

    diffs = {}
    t0 = time.perf_counter()
    run.main([task, sweep, "--name", "MAP", "--out", out, "--rep", "0", "--phase", "eval"])
    diffs["eval"] = close(last(os.path.join(out, "MAP_0", "rep_0", "eval", "metrics.jsonl")), results["MAP"])
    shutil.copy(os.path.join(out, "MAP_0", "rep_0", "map_final"), os.path.join(out, "Laplace_0", "rep_0", "map_final"))
    run.main([task, sweep, "--name", "Laplace", "--out", out, "--rep", "0", "--phase", "fit_laplace"])
    fitted = last(os.path.join(out, "Laplace_0", "rep_0", "fit_laplace", "metrics.jsonl"))
    diffs["fit_laplace"] = close(fitted, results["Laplace"])
    run.main([task, sweep, "--name", "MCD", "--out", out, "--rep", "0", "--phase", "drop_rates"])
    rates = last(os.path.join(out, "MCD_0", "rep_0", "drop_rates", "metrics.jsonl"))
    diffs["drop_rates"] = close(rates["p=0.2"], results["MCD"])
    run.main([task, sweep, "--name", "MAP", "--out", out, "--phase", "multix"])
    got = last(os.path.join(out, "MAP_0", "multix", "metrics.jsonl"))
    dirs = [os.path.join(out, "MAP_0", f"rep_{r}") for r in range(2)]
    config, built, _, test = wilds_task._rebuild(task, rows["MAP"])
    states = [ckpt.restore_final(d, "map", wilds_task._build_for(task, config, built.device).state) for d in dirs]
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    diffs["multix"] = close(got, wilds_task.eval_task(built, task, config, *test))
    check(all(d <= 1e-5 for d in diffs.values()),
          f"{task} phases through run.main = the runs' own evals (max rel diff {json.dumps(diffs)} <= 1e-5): eval of "
          f"map_final = MAP; fit_laplace of it = Laplace; drop_rates p=0.2 of mcd_final = MCD; multix over MAP's two "
          f"repetitions = a deep_ensemble of them")
    print(f"{task} phases: {time.perf_counter() - t0:.1f} s [{CARD}]")
    return diffs


def k3_key_mode(torch, att, sampling, shape):
    """K3 with a DeviceSeed against K3 with the equal host seed, bit for bit
    (output, dQ, dK, dV); against the plain version fed the mask it drew;
    a captured launch replayed under two keys draws two masks, each the
    eager one of its key; then the time of a key-mode launch against a
    host-seed launch (CUDA graphs, forward and backward)."""
    q, k, v, do, mask = k3_inputs(torch, shape, seed=21)
    key = torch.full((), 123_456_789, dtype=torch.int64, device="cuda")
    seed = sampling.DeviceSeed(key, 5 << 20)
    host = 123_456_789 + (5 << 20)
    out_d, grads_d = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=K3_P, seed=seed),
                                q, k, v, do)
    out_h, grads_h = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=K3_P, seed=host),
                                q, k, v, do)
    check(torch.equal(out_d, out_h) and all(torch.equal(a, b) for a, b in zip(grads_d, grads_h)),
          f"K3 {shape}: a DeviceSeed (key in device memory + index) = the equal host seed, bit for bit "
          f"(output, dQ, dK, dV)")
    out, probs = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=K3_P, seed=seed)
    check(torch.equal(out, out_d), f"K3 {shape}: the debug entry draws the key's mask")
    ref, ref_grads = with_grads(torch, lambda *t: att.dropout_attention_plain(*t, mask, probs > 0, dropout_p=K3_P),
                                q, k, v, do)
    err, gerr = k3_hold(torch, f"{shape} DeviceSeed, realized mask", out_d, ref, grads_d, ref_grads)
    del ref, ref_grads, grads_h, out_h

    static = torch.zeros((), dtype=torch.int64, device="cuda")
    graph = torch.cuda.CUDAGraph()
    captured_seed = sampling.DeviceSeed(static, 5 << 20)
    att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=K3_P, seed=captured_seed)  # warm-up
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        _, captured = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=K3_P, seed=captured_seed)
    masks = []
    for value in (123_456_789, 987_654_321):
        static.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        eager = att.fused_dropout_attention_debug(
            q, k, v, mask, dropout_p=K3_P, seed=sampling.DeviceSeed(torch.full_like(static, value), 5 << 20))[1]
        check(torch.equal(captured > 0, eager > 0), f"K3 {shape}: a captured launch replayed with key {value} draws "
                                                    f"that key's eager mask")
        masks.append((captured > 0).clone())
    changed = float((masks[0] != masks[1]).float().mean())
    check(changed > 0.05, f"K3 {shape}: two replays under two keys draw two masks ({changed:.3f} of the elements differ)")
    del graph, captured, masks, probs

    bias = att.key_bias(mask)
    o, lse, _ = att.attention_forward(q, k, v, bias, K3_P, host, None)
    times = in_turns({
        "host seed": lambda: graph_ms(torch, lambda: att.attention_forward(q, k, v, bias, K3_P, host, None)),
        "device seed": lambda: graph_ms(torch, lambda: att.attention_forward(q, k, v, bias, K3_P, seed, None)),
    })
    back = in_turns({
        "host seed": lambda: graph_ms(torch, lambda: att.attention_backward(q, k, v, bias, K3_P, host, None, o, lse, do)),
        "device seed": lambda: graph_ms(torch, lambda: att.attention_backward(q, k, v, bias, K3_P, seed, None, o, lse,
                                                                              do)),
    })
    print(f"K3 {shape} forward, host seed {times['host seed'][0]:.4f} ms, device seed {times['device seed'][0]:.4f} ms; "
          f"backward, host seed {back['host seed'][0]:.4f} ms, device seed {back['device seed'][0]:.4f} ms [{CARD}]")
    del q, k, v, do, o, lse, bias
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "grad_max_abs_err": gerr,
            "forward_ms": {n: t[0] for n, t in times.items()}, "backward_ms": {n: t[0] for n, t in back.items()}}


def k2_wilds_times(torch, svgd_kernel):
    """K2 at the text rows' shapes, (5, 66,957,317) (SVGD over distilbert-base
    + Amazon's head) and (5, 592,130) (LL_SVGD's CivilComments heads):
    against fp64 and gram_plain, then its CUDA-graph time beside
    ``gram_plain``'s and ``torch.mm(x, x.T)``'s (TF32 off), and the byte
    bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for n, p in ((5, 66_957_317), (5, 592_130)):
        x = torch.randn(n, p, device=dev, generator=gen) + torch.randn(1, p, device=dev, generator=gen)
        err, _ = k2_check(torch, svgd_kernel, x)
        copies = max(1, -(-60_000_000 // (4 * n * p)))
        xs = [x] + [torch.randn(n, p, device=dev, generator=gen) for _ in range(copies - 1)]
        reps = max(copies, 4)

        def run(fn):
            def repeated():
                for i in range(reps):
                    fn(xs[i % copies])
            return graph_ms(torch, repeated, reps=5) / reps

        with torch.no_grad():
            times = in_turns({"kernel": lambda: run(svgd_kernel.gram), "plain": lambda: run(svgd_kernel.gram_plain),
                              "library": lambda: run(lambda t: torch.mm(t, t.T))})
        n_bytes = 4 * n * p + 4 * n * n
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * n * p / FP32_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        rows[f"{n}x{p}"] = {"ms": times["kernel"][0], "plain_ms": times["plain"][0], "library_ms": times["library"][0],
                            "bound_ms": bound, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                            "max_abs_err": err}
        print(f"K2 ({n}, {p}): kernel {times['kernel'][0] * 1e3:.2f} us, gram_plain {times['plain'][0] * 1e3:.2f} us, "
              f"torch.mm {times['library'][0] * 1e3:.2f} us, bound {bound * 1e3:.2f} us by "
              f"{rows[f'{n}x{p}']['bound_by']} (K2 at {100 * bound / times['kernel'][0]:.0f}% of it) [{CARD}]")
        del x, xs
        torch.cuda.empty_cache()
    return rows


def wilds_built(torch, wilds_task, task, row, **extra):
    """``row`` of configs/<task>.yaml built at full width on the card, with
    WILDS_STEPS batches of its train split there."""
    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds

    docs = {d["name"]: d.get("params", {}) for d in wilds_yaml_docs(task)}
    bs = docs["DEFAULT"]["batch_size"]
    x, y, _ = load_wilds(task, "train", subsample=WILDS_STEPS * bs)
    config = {**wilds_task.DEFAULT_CONFIG, **docs["DEFAULT"], **docs[row], "dataset_size": x.shape[0],
              "steps_per_epoch": WILDS_STEPS, "epochs": 1, **extra}
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), WILDS_STEPS)
    xd, yd = wilds_task._to_device(built, x, y)
    batches = [(xd[i * bs : (i + 1) * bs].clone(), yd[i * bs : (i + 1) * bs].clone()) for i in range(WILDS_STEPS)]
    return built, config, batches


def wilds_step_times(torch, built, batches, label, captured=20, eager=10):
    """Steady steps, ``captured`` replayed from one graph of WILDS_STEPS / 2
    steps and ``eager`` one update per call, key mode both, CUDA events:
    ms a step each way."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    k = WILDS_STEPS // 2
    multi = multistep.make_multi_step(built.method.update, k)
    stacked = [multistep.stack_batches(batches[i * k : (i + 1) * k]) for i in range(2)]
    built.state, _ = multi(built.state, 1, stacked[0])  # capture, outside the timing
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(captured // k):
        built.state, metrics = multi(built.state, 2 + i, stacked[i % 2])
    end.record()
    end.synchronize()
    captured_ms = start.elapsed_time(end) / captured
    check(bool(torch.isfinite(metrics["loss"])), f"{label}: captured steps' loss finite")
    built.state, _ = built.method.update(built.state, NoiseSource(key=keys.as_key(3, "cuda")), batches[0])
    torch.cuda.synchronize()
    start.record()
    for i in range(eager):
        built.state, metrics = built.method.update(
            built.state, NoiseSource(key=keys.as_key(keys.fold_in(4, i), "cuda")), batches[i % len(batches)])
    end.record()
    end.synchronize()
    eager_ms = start.elapsed_time(end) / eager
    print(f"{label} steady step: captured {captured_ms:.2f} ms ({captured} steps, graphs of {k}), eager {eager_ms:.2f} "
          f"ms ({eager} steps) [{CARD}]")
    return {"captured_ms": captured_ms, "eager_ms": eager_ms}


def wilds_mcd_capture(torch, wilds_task):
    """Amazon's MCD at full width: COMPARE_STEPS captured steps = as many
    eager ones from one key, bit for bit (``captured_vs_eager``); a captured
    loss forward replayed under two keys gives two losses, each the eager
    forward's of its key; the eval runner against the host loop on the same
    keys within 1e-5. Returns the built row and its batches."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

    built, config, batches = wilds_built(torch, wilds_task, "amazon", "MCD")
    captured_vs_eager(torch, built, batches, "DistilBERT MCD (device_data)")
    loss_fn = wilds_task._loss_fn_for(built.model)
    static = torch.zeros((), dtype=torch.int64, device="cuda")
    batch = batches[0]
    with torch.no_grad():
        loss_fn(built.state.params, {}, NoiseSource(key=static), batch)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loss = loss_fn(built.state.params, {}, NoiseSource(key=static), batch).loss
        losses = []
        for value in (keys.fold_in(5, 0), keys.fold_in(5, 1)):
            static.fill_(value)
            graph.replay()
            eager = loss_fn(built.state.params, {}, NoiseSource(key=keys.as_key(value, "cuda")), batch).loss
            check(torch.equal(loss, eager), f"DistilBERT MCD: the captured loss forward under key {value} = the eager "
                                            f"one, bit for bit ({float(loss):.6f})")
            losses.append(float(loss))
    check(losses[0] != losses[1], f"DistilBERT MCD: two replays under two keys draw two sets of masks (losses "
                                  f"{losses[0]:.6f}, {losses[1]:.6f})")
    del graph
    xt, yt, mt = load_wilds("amazon", "test", subsample=WILDS_TEST)
    evals = {mode: wilds_task.eval_task(built, "amazon", {**config, "device_eval": mode}, xt, yt, mt)
             for mode in (True, False)}
    diff = max(abs(evals[True][m] - evals[False][m]) / max(abs(evals[False][m]), 1e-30) for m in evals[False]
               if isinstance(evals[False][m], float))
    check(diff <= 1e-5, f"DistilBERT MCD: eval runner = host eval loop on the same keys (metrics max rel diff "
                        f"{diff:.2g} <= 1e-5; equal: {evals[True] == evals[False]})")
    return built, batches


def k_lin_layouts(state):
    """The flat layouts of a text state's parameter vectors, each as a bool
    vector True on the k_lin biases' elements (the parameters' module order,
    the order of the optimizers', SWAG's and iVON's flat vectors)."""
    import torch

    from beyond_deep_ensembles_tpu_torch.methods.last_layer import LastLayerState

    groups = [list(state.backbone.items()), list(state.inner.params.named_parameters())] \
        if isinstance(state, LastLayerState) else [list(state.params.named_parameters())]
    return [torch.cat([torch.full((p.numel(),), n.endswith("k_lin.bias")) for n, p in group]) for group in groups]


def k_lin_elements(layouts, key, t):
    """True on the elements of state tensor ``key`` that hold a k_lin bias."""
    import torch

    if key.endswith("k_lin.bias"):
        return torch.ones_like(t, dtype=torch.bool)
    for mask in layouts:
        if t.dim() and t.shape[-1] == mask.shape[0]:
            return mask.expand(t.shape)
    return torch.zeros_like(t, dtype=torch.bool)


def wilds_card_vs_cpu(torch, wilds_task, NoiseSource):
    """One update of each text method on the card and on the CPU from the
    same weights and draws, at one layer of distilbert-base's width
    (WILDS_CPU_CHECK: vocabulary 2048, L = 128, batch 4, Amazon's rows; BBB's and LL-BBB's head noise given, the
    rest key mode, whose draws are the same on both; dropout and attention
    dropout off on both, as K3's Philox and the CPU's stream differ): the
    loss within 1e-5 relative, the counters equal, and every tensor of the
    state: at most one element in a thousand (at least one) beyond 1e-4 of
    its tensor's largest change plus two roundings of it (of the mean, for a SWAG
    deviation), none beyond twice that change; the k_lin biases' elements
    (a gradient of zero in exact arithmetic, the softmax being blind to a
    shift of a row of scores, so rounding alone: ``bert_card_vs_cpu``) held
    to twice the largest step of any parameter
    (Adam's first step is lr times the gradient's sign, which rounding sets
    where the gradient is near zero: a flip moves an element by twice the
    step)."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds

    x, y, _ = load_wilds("amazon", "train", subsample=WILDS_CPU_CHECK["batch"])
    x = x[:, : WILDS_CPU_CHECK["seq"]].copy()
    x[..., 0] %= WILDS_CPU_CHECK["bert_config"]["vocab_size"]
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    docs = {d["name"]: d.get("params", {}) for d in wilds_yaml_docs("amazon")}
    bert = {**WILDS_CPU_CHECK["bert_config"], "dropout": 0.0, "attention_dropout": 0.0,
            "max_position_embeddings": WILDS_CPU_CHECK["seq"]}
    figures = {}
    variants = [("SWAG", {}), ("SWAG_LL", {}), ("BBB", {}), ("Rank1", {}), ("SVGD", {}), ("iVON", {}),
                ("LL_iVON", {}), ("SNGP", {}), ("BBB", {"model": "ll_bbb"}),
                ("SVGD", {"model": "ll_svgd"})]
    for row, extra in variants:
        config = {**wilds_task.DEFAULT_CONFIG, **docs["DEFAULT"], **docs[row], **extra, "bert_config": bert,
                  "dataset_size": 64, "steps_per_epoch": 8, "swag_start_epoch": 0, "swag_updates": 8}
        label = extra.get("model", row)
        sides = {}
        for device in ("cpu", "cuda"):
            built = wilds_task.build("amazon", config, torch.Generator().manual_seed(3), 8, device=device)
            state = built.state
            before = {k: t.detach().clone().cpu() for k, t in state.state_dict().items()}
            if config["model"] in ("bbb", "ll_bbb"):
                gen = torch.Generator().manual_seed(4)
                noise = NoiseSource(given=[torch.randn(4, 768, generator=gen),
                                           torch.rand(4, 768, generator=gen) >= 0.2,
                                           torch.randn(4, 5, generator=gen)])
            else:
                noise = NoiseSource(key=keys.as_key(keys.fold_in(6, 0), device))
            state, metrics = built.method.update(state, noise, (x.to(device), y.to(device)))
            sides[device] = (float(metrics["loss"]), before,
                             {k: t.detach().clone().cpu() for k, t in state.state_dict().items()})
            layouts = k_lin_layouts(state)
            del built, state
        (l_cpu, b_cpu, a_cpu), (l_gpu, _, a_gpu) = sides["cpu"], sides["cuda"]
        loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        worst_share, outliers, flip_share, counters = 0.0, 0.0, 0.0, True
        # the largest step of any parameter: the k_lin biases' bound
        moved = max(float((a_cpu[k].double() - b_cpu[k].double()).abs().max()) for k in a_cpu
                    if (".params." in f".{k}" or k.startswith("backbone.")) and a_cpu[k].is_floating_point())
        k_lin_gap = 0.0
        for key, cpu in a_cpu.items():
            gpu, before = a_gpu[key], b_cpu[key]
            if not cpu.is_floating_point():
                counters &= torch.equal(cpu, gpu)
                continue
            change = float((cpu.double() - before.double()).abs().max())
            gap = (gpu.double() - cpu.double()).abs()
            # a SWAG deviation is a parameter less the mean: its rounding is
            # the operands', the mean's magnitude
            operand = a_cpu[key.replace("deviations", "mean")] if key.endswith("deviations") else cpu
            share = gap / (1e-4 * change + 2.0**-22 * operand.double().abs() + 1e-30)
            k_lin = k_lin_elements(layouts, key, cpu)
            over = (share > 1.0) & ~k_lin
            outliers = max(outliers, int(over.sum()) / max(1, cpu.numel() // 1000))
            if over.any():
                flip_share = max(flip_share, float(gap[over].max()) / (2 * change + 1e-30))
            if k_lin.any():
                k_lin_gap = max(k_lin_gap, float(gap[k_lin].max()) / (2 * moved + 1e-30))
            rest = ~(over | k_lin)
            worst_share = max(worst_share, float(share[rest].max()) if rest.any() else 0.0)
        check(loss_err <= 1e-5 and counters and outliers <= 1.0 and flip_share <= 1.0 and k_lin_gap <= 1.0,
              f"{label} update on the card = CPU path at one layer of distilbert-base (loss rel err {loss_err:.1e} "
              f"<= 1e-5; counters equal; state tensors at {worst_share:.3f} of 1e-4 of their largest change plus "
              f"two roundings, elements beyond it at {outliers:.2g} of one in a thousand (at least one) a tensor, "
              f"those within "
              f"{flip_share:.3f} of twice the largest change; k_lin biases within {k_lin_gap:.3f} of twice the "
              f"largest parameter step)")
        figures[label] = {"loss_rel_err": loss_err, "bound_share": worst_share, "outlier_share": outliers,
                          "flip_share": flip_share, "k_lin_share": k_lin_gap}
    return figures


def wilds_k1_checks(torch, sampling):
    """K1 at the planes the text BBB head hands it (768 -> 768 -> classes on
    the [CLS] row): train at batch 8 (amazon, 5 classes) and 16
    (civilcomments, 2), given noise and Philox draws from a DeviceSeed,
    forward and backward; frozen (one row for the batch) at eval batch 16 and
    32. Each against ``gaussian_sample_plain`` on the same inputs: outputs
    within 1e-6 absolute, gradients within 1e-5 relative, as ``kernel_phase``
    holds the ResNet-20 planes; the Philox draw equal to the same z given,
    output and gradients bit for bit, one backward launch a backward."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    key = torch.full((), 987_654_321, dtype=torch.int64, device=dev)
    var_w = max(F.softplus(torch.tensor(-3.0)).item() ** 2, 1e-4)  # init rho -3, the layer's clamp
    worst, grad_worst = 0.0, 0.0
    for batch, classes, frozen in ((8, 5, False), (16, 2, False), (16, 5, True), (32, 2, True)):
        x = torch.randn(batch, 768, device=dev, generator=gen)
        for index, (fan_in, out_dim) in enumerate(((768, 768), (768, classes))):
            shape = (batch, out_dim)
            w = 0.02 * torch.randn(out_dim, fan_in, device=dev, generator=gen)
            leaves = [x @ w.T, torch.clamp(x * x, min=1e-4) @ torch.full_like(w, var_w).T,
                      0.02 * torch.randn(out_dim, device=dev, generator=gen), torch.full((out_dim,), var_w, device=dev)]
            leaves = [t.requires_grad_(True) for t in leaves]
            mode = "frozen" if frozen else "train"
            seed = sampling.DeviceSeed(key, (index + 1) << 20)
            z = sampling.gaussian_sample(torch.zeros(shape, device=dev), torch.ones(shape, device=dev), seed=seed,
                                         frozen=frozen)
            z = z[0].contiguous() if frozen else z
            for noise in (torch.randn(z.shape, device=dev, generator=gen), z):
                given = sampling.gaussian_sample(*leaves, eps=noise)
                ref = sampling.gaussian_sample_plain(*leaves, noise)
                worst = max(worst, float((given - ref).detach().abs().max()))
                if frozen:
                    continue
                g = torch.randn(shape, device=dev, generator=gen)
                want = torch.autograd.grad((given * g).sum(), leaves)
                plain = torch.autograd.grad((ref * g).sum(), leaves)
                for a, b in zip(want, plain):
                    grad_worst = max(grad_worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
            drawn = sampling.gaussian_sample(*leaves, seed=seed, frozen=frozen)
            check(torch.equal(drawn, given), f"K1 DeviceSeed draw = the same z given, {shape}, {mode}")
            if not frozen:
                backwards = sampling.gaussian_sample_backward.launches
                got = torch.autograd.grad((drawn * g).sum(), leaves)
                check(sampling.gaussian_sample_backward.launches == backwards + 1,
                      f"K1 backward: one launch for one backward, {shape}, DeviceSeed")
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"K1 DeviceSeed gradients = given-noise gradients bit for bit, {shape}")
    torch.cuda.synchronize()
    check(worst <= 1e-6 and grad_worst <= 1e-5,
          f"K1 at the text BBB head's train planes [8, 768], [8, 5], [16, 768], [16, 2] and frozen eval planes "
          f"[16, 768], [16, 5], [32, 768], [32, 2] = plain, given noise and DeviceSeed draws (max abs err "
          f"{worst:.3g} <= 1e-6; gradients rel err {grad_worst:.3g} <= 1e-5)")
    return {"max_abs_err": worst, "grad_rel_err": grad_worst}


def wilds_phase(torch, kernels, att, sampling, svgd_kernel, wilds_task, NoiseSource):
    """K1 at the text BBB head's planes, both text yamls through run.main at
    full width with exact launch counts, the checkpoint phases, K3's key mode, K2 and K3 at the text
    shapes, the captured MCD step, steady steps of MAP, MCD, SVGD and
    LL_SVGD, and one step of each new method against the CPU."""
    import shutil

    out = os.path.join(BUILD, "wilds_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    figures = {"k1_head": wilds_k1_checks(torch, sampling)}
    figures["k3_key_mode"] = k3_key_mode(torch, att, sampling, K3_CIVIL_SHAPE)
    figures["k3_civil"] = k3_times(torch, att, K3_CIVIL_SHAPE)
    figures["k2"] = k2_wilds_times(torch, svgd_kernel)
    figures["rows"], figures["phases"] = {}, {}
    for task in WILDS_ROWS:
        rows, results, row_figures = wilds_cli_rows(torch, task, kernels, out)
        figures["rows"][task] = row_figures
        figures["phases"][task] = wilds_phases(torch, task, rows, results, out)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
    shutil.rmtree(out, ignore_errors=True)
    built, batches = wilds_mcd_capture(torch, wilds_task)
    figures["steps"] = {"MCD": wilds_step_times(torch, built, batches, "Amazon MCD")}
    del built
    torch.cuda.empty_cache()
    for row, task in (("MAP", "amazon"), ("SVGD", "amazon"), ("LL_SVGD", "civilcomments")):
        built, _, batches = wilds_built(torch, wilds_task, task, row)
        figures["steps"][row] = wilds_step_times(torch, built, batches, f"{task} {row}")
        del built, batches
        torch.cuda.empty_cache()
    figures["card_vs_cpu"] = wilds_card_vs_cpu(torch, wilds_task, NoiseSource)
    return figures


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "beyond_deep_ensembles_tpu_torch")):
        print("chip_smoke: the beyond_deep_ensembles_tpu_torch package is not beside this file", file=sys.stderr)
        return 1
    os.makedirs(BUILD, exist_ok=True)
    # keep Triton's cache and CUDA's JIT cache inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton_cache")
    os.environ["TRITON_HOME"] = os.path.join(BUILD, "triton_home")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task
    from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import _cuda_build, sampling, svgd_kernel
    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    global CARD
    CARD = smi
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} card(s): {name}")

    phase("build")
    build_phase(torch, _cuda_build)
    phase("K1")
    k1 = kernel_phase(torch, sampling)
    phase("K2")
    k2 = k2_phase(torch, svgd_kernel)
    phase("K3a, K3b")
    k3 = k3_phase(torch, att)
    kernels = {
        "k1_gaussian_sample": sampling.gaussian_sample, "k1_gaussian_sample_backward": sampling.gaussian_sample_backward,
        "k2_svgd_gram": svgd_kernel.gram,
        "k3a_attention_forward": att.attention_forward, "k3b_attention_backward": att.attention_backward,
    }
    no_k3 = {"k3a_attention_forward": (0, 0), "k3b_attention_backward": (0, 0)}
    no_k1 = {"k1_gaussian_sample": (0, 0), "k1_gaussian_sample_backward": (0, 0)}

    phase("BBB slice, one update per call")
    built, bbb_counts, config, step = run_slice(torch, cifar, NoiseSource, kernels, BBB_VARIANT, "BBB")
    per_forward = len(bbb_shapes(1))
    eval_batches = -(-SMOKE["test_subsample"] // config["eval_batch_size"])
    k1_train, k1_eval = bbb_counts["k1_gaussian_sample"]
    check(k1_train == TRAIN_STEPS * config["bbb_mc_samples"] * per_forward,
          f"K1 launched {k1_train} times in {TRAIN_STEPS} BBB train steps ({per_forward} x mc {config['bbb_mc_samples']} per step)")
    check(k1_eval == eval_batches * config["eval_samples"] * per_forward,
          f"K1 launched {k1_eval} times in BBB eval ({eval_batches} batches x {config['eval_samples']} samples x {per_forward})")
    k1b_train, k1b_eval = bbb_counts["k1_gaussian_sample_backward"]
    check(k1b_train == TRAIN_STEPS * config["bbb_mc_samples"] * per_forward and k1b_eval == 0,
          f"K1 backward launched {k1b_train} times in {TRAIN_STEPS} BBB train steps ({per_forward} x mc "
          f"{config['bbb_mc_samples']} per step) and {k1b_eval} times in eval")
    check(bbb_counts["k2_svgd_gram"] == (0, 0), "K2 not launched on the BBB path")
    check(all(bbb_counts[name] == c for name, c in no_k3.items()), "K3a and K3b not launched on the BBB path")
    bbb_profile = profile_steps(torch, step, ours=("_flat_kernel", "_frozen_kernel"))
    print(f"BBB train step: {bbb_profile and bbb_profile['kernels']} kernels per step (8270 before K1's backward kernel)")
    small_input_check(torch, NoiseSource, ResNet20)
    del built, step

    phase("SVGD slice, one update per call")
    built, svgd_counts, config, step = run_slice(torch, cifar, NoiseSource, kernels, SVGD_VARIANT, "SVGD")
    check(svgd_counts["k2_svgd_gram"] == (TRAIN_STEPS, 0),
          f"K2 launched {svgd_counts['k2_svgd_gram'][0]} times in {TRAIN_STEPS} SVGD train steps (one per step) "
          f"and {svgd_counts['k2_svgd_gram'][1]} times in eval")
    check(all(svgd_counts[name] == c for name, c in no_k1.items()), "K1 not launched on the SVGD path")
    check(all(svgd_counts[name] == c for name, c in no_k3.items()), "K3a and K3b not launched on the SVGD path")
    profile_steps(torch, step, ours=("gram_kernel",))
    svgd_step_check(torch, cifar, NoiseSource)
    del built, step
    torch.cuda.empty_cache()

    phase("CIFAR runners (CUDA graphs)")
    runners = {
        "BBB": runner_phase(torch, cifar, kernels, BBB_VARIANT, "BBB", ours=("_flat_kernel", "_frozen_kernel")),
        "SVGD": runner_phase(torch, cifar, kernels, SVGD_VARIANT, "SVGD", ours=("gram_kernel",)),
    }
    print(json.dumps({"card": CARD, "cifar_runners": runners}))

    phase("Multi-X: DeepEnsemble, MultiBBB, MultiMCD, MultiSWAG, MCD, SWAG")
    multix = multi_x_phase(torch, cifar, kernels, NoiseSource, runners["BBB"])
    print(json.dumps({"card": CARD, "multix": multix}))

    phase("CIFAR: Rank1, iVON, MultiiVON, SNGP, Laplace, MultiLaplace")
    rest = rest_phase(torch, cifar, kernels, NoiseSource)
    print(json.dumps({"card": CARD, "rest": rest}))

    # the DistilBERT slice: MCD (its main path), then MAP
    phase("DistilBERT slice")
    layers = wilds_task._bert_config({}).n_layers
    eval_forwards = -(-BERT_SMOKE["test_subsample"] // AMAZON_DEFAULT["eval_batch_size"]) * AMAZON_DEFAULT["eval_samples"]
    bert_counts = {}
    for variant, label in ((MCD_VARIANT, "DistilBERT MCD"), (MAP_VARIANT, "DistilBERT MAP")):
        built, counts, config, step = run_bert_slice(torch, wilds_task, kernels, variant, label)
        bert_counts[label] = counts
        check(counts["k3a_attention_forward"] == (TRAIN_STEPS * layers, eval_forwards * layers),
              f"{label}: K3a launched {counts['k3a_attention_forward'][0]} times in {TRAIN_STEPS} train steps and "
              f"{counts['k3a_attention_forward'][1]} times in eval ({eval_forwards} forwards x {layers} layers)")
        check(counts["k3b_attention_backward"] == (TRAIN_STEPS * layers, 0),
              f"{label}: K3b launched {counts['k3b_attention_backward'][0]} times in {TRAIN_STEPS} train steps and "
              f"{counts['k3b_attention_backward'][1]} times in eval")
        check(all(counts[name] == c for name, c in no_k1.items()) and counts["k2_svgd_gram"] == (0, 0),
              f"{label}: K1 and K2 not launched")
        if variant is MCD_VARIANT:
            steady_steps(torch, step, label, config["batch_size"])
            profile_steps(torch, step, ours=("attn_forward", "attn_backward"))
        del built, step
        torch.cuda.empty_cache()
    bert_card_vs_cpu(torch, wilds_task, NoiseSource)

    phase("UCI regression: configs/uci.yaml through the CLI")
    uci = uci_phase(torch, kernels)
    print(json.dumps({"card": CARD, "uci": uci}))

    phase("WILDS text tasks: configs/amazon.yaml and configs/civilcomments.yaml through the CLI")
    wilds = wilds_phase(torch, kernels, att, sampling, svgd_kernel, wilds_task, NoiseSource)
    print(json.dumps({"card": CARD, "wilds": wilds}))
    wilds_counts = {name: sum(row["counts"][name] for rows in wilds["rows"].values() for row in rows.values())
                    for name in kernels}

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(CARD)
    print(json.dumps({"kernels": [
        {
            "name": "k1_gaussian_sample",
            "route": "triton",
            "source": "beyond_deep_ensembles_tpu_torch/ops/sampling.py",
            "replaces": "beyond_deep_ensembles_tpu/ops/sampling.py:46",
            "launches": sum(bbb_counts["k1_gaussian_sample"]),
            "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"],
            "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"],
            "library_ms": None,
            # the backward kernel (22 launches of one train backward) and
            # the frozen-eval forward (22 launches at eval batch 500)
            "backward_launches": sum(bbb_counts["k1_gaussian_sample_backward"]),
            "backward_ms": k1["backward_ms"],
            "backward_bound_ms": k1["backward_bound_ms"],
            "backward_autograd_ms": k1["backward_autograd_ms"],
            "backward_plain_autograd_ms": k1["backward_plain_autograd_ms"],
            "frozen_eval_ms": k1["frozen_eval_ms"],
            "frozen_eval_plain_ms": k1["frozen_eval_plain_ms"],
            "frozen_eval_bound_ms": k1["frozen_eval_bound_ms"],
            "host_us": k1["host_us"],
            "backward_host_us": k1["backward_host_us"],
            # the runner phase: host counts (warm-ups and captures) and, from
            # a profile, K1 launches per replayed BBB step (forward and backward)
            "runner_launches": runners["BBB"]["host_counts"]["k1_gaussian_sample"],
            "replay_launches_per_step": runners["BBB"]["profiles"]["captured"]["launches"]["_flat_kernel"],
            # MultiBBB (5 members): host counts of its run_single, and K1
            # launches per replayed step from a profile (forward and backward)
            "multibbb_run_single_launches": multix["runs"]["MultiBBB"]["host_counts"]["k1_gaussian_sample"],
            "multibbb_replay_launches_per_step":
                multix["MultiBBB"]["profiles"]["captured"]["launches"]["_flat_kernel"],
            # the UCI phase: the CLI's nine naval runs (bbb and bbb_fixed_kl),
            # host launches per eager bbb step and per evaluate (S = 1000), the
            # MLP's planes against the plain version
            "uci_cli_launches": uci["cli"]["host_counts"]["k1_gaussian_sample"],
            "uci_cli_backward_launches": uci["cli"]["host_counts"]["k1_gaussian_sample_backward"],
            "uci_launches_per_bbb_step": uci["steps"]["bbb"]["k1_per_step"],
            "uci_backward_launches_per_bbb_step": uci["steps"]["bbb"]["k1_backward_per_step"],
            "uci_launches_per_evaluate": uci["steps"]["bbb"]["k1_per_evaluate"],
            "uci_max_abs_err": uci["kernels"]["k1_max_abs_err"],
            # the WILDS phase: host counts over both yamls' rows through
            # run.main (BBB's head: 2 a step forward and backward, 2 frozen a
            # forward at eval)
            "wilds_launches": wilds_counts["k1_gaussian_sample"],
            "wilds_backward_launches": wilds_counts["k1_gaussian_sample_backward"],
            "wilds_head_max_abs_err": wilds["k1_head"]["max_abs_err"],
        },
        {
            "name": "k2_svgd_gram",
            "route": "cuda",
            "source": "beyond_deep_ensembles_tpu_torch/csrc/svgd_gram.cu",
            "replaces": "beyond_deep_ensembles_tpu/ops/svgd_kernel.py:37",
            "launches": sum(svgd_counts["k2_svgd_gram"]),
            "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"],
            "library_ms": k2["library_ms"],
            "host_us": k2["host_us"],
            "runner_launches": runners["SVGD"]["host_counts"]["k2_svgd_gram"],
            "replay_launches_per_step": runners["SVGD"]["profiles"]["captured"]["launches"]["gram_kernel"],
            # the UCI phase: the CLI's svgd run (10 particles), launches per
            # eager svgd step, and K2 at (10, P) and (20, P), naval's P
            "uci_cli_launches": uci["cli"]["host_counts"]["k2_svgd_gram"],
            "uci_launches_per_svgd_step": uci["steps"]["svgd10"]["k2_per_step"],
            "uci_10": uci["kernels"]["k2_10"],
            "uci_20": uci["kernels"]["k2_20"],
            # the WILDS phase: host counts over both yamls' rows (SVGD and
            # LL_SVGD, once a step), and K2 at their shapes beside torch.mm
            "wilds_launches": wilds_counts["k2_svgd_gram"],
            "wilds_shapes": wilds["k2"],
        },
        *(
            {
                "name": name,
                "route": "cuda",
                "source": "beyond_deep_ensembles_tpu_torch/csrc/dropout_attention.cu",
                "replaces": replaces,
                "launches": sum(bert_counts["DistilBERT MCD"][name]),
                "max_abs_err": k3[key]["max_abs_err"],
                "ms": k3[key]["ms"],
                "plain_ms": k3[key]["plain_ms"],
                "bound_ms": k3[key]["bound_ms"],
                "bound_by": k3[key]["bound_by"],
                "bound_fp32_cores_ms": k3[key]["bound_fp32_cores_ms"],
                "library_ms": k3[key]["library_ms"],
                "library_p": k3[key]["library_p"],
                # the WILDS phase: host counts over both yamls' rows, K3 at
                # CivilComments' train shape, key mode (a DeviceSeed)
                "wilds_launches": wilds_counts[name],
                "civilcomments_shape": wilds["k3_civil"][key],
                "key_mode_ms": wilds["k3_key_mode"]["forward_ms" if key == "K3a" else "backward_ms"],
            }
            for name, key, replaces in (
                ("k3a_attention_forward", "K3a", "beyond_deep_ensembles_tpu/ops/attention.py:84"),
                ("k3b_attention_backward", "K3b", "beyond_deep_ensembles_tpu/ops/attention.py:101"),
            )
        ),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
