#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``beyond_deep_ensembles_tpu_torch``) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

It runs as two processes on the one card (``supervise``): the first runs
phases 1-8 and 10; once the CUDA C++ kernels are built (phase 2) it
starts the second (this file with ``--second``), which runs phases 15, 9,
11-14 and 17 beside it, its output in ``build/chip_smoke_second.log`` (printed by
the first when it ends) and its figures handed back in
``build/chip_smoke_second.json``. Every launch count is a process's own.
A timed section (steady steps, CUDA-graph and event timings, profiles,
eval rates, the Laplace fit) stops the other process while it runs
(``alone``), so the times printed are taken alone; the wall times of rows
and ``run_single`` calls are taken beside the other process.

Phases (any failed check raises and exits non-zero; nothing is caught):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. the CUDA C++ kernels K2, K3, K3 on bf16 and K1 on bf16 built at once
     (one nvcc each, by ``ops/_cuda_build.py`` into ``build/kernels/``):
     build time and ptxas report;
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
     corrupted intensities 0-4) with ``device_data``, one epoch of 50 steps
     replayed from one captured graph and the test split and five corrupted
     splits (250 images each, S = 50) through the eval runner, every count
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
     ``run_single`` with ``device_data``, cut to 1 epoch of 20 steps and
     250 images per split (SWAG's start epoch in proportion), every count
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
     per step, exactly; 10 steady steps and a profile of 3; then the ``MAP``
     variant the same way; the card's MCD logits and one Adam step held
     against the CPU path with the same weights and masks;
  9. UCI regression (``experiments/uci.py`` through the CLI): configs/uci.yaml
     written to a temporary file with its list of data sets cut to energy
     (768 rows), 1 epoch and 1 repetition, the grid's nine models and
     DEFAULT's values kept, and driven through ``run.main`` (every count set
     to 0 just before and read just after: K1 on bbb and bbb_fixed_kl only,
     K2 once a svgd step), each run's five metrics finite and its wall time;
     SVGD at 20 particles through ``run_single`` on energy (K2 at n = 20)
     and map on yacht with the gap splits; then on naval (the largest data
     set); 16 steps of map, bbb and svgd through the
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
     at distilbert-base's width, cut to one epoch of 4 steps and 32 test
     examples (SWAG's collections in proportion), a row at a time with
     every count set to 0 just before and read just after, exact; the
     ``eval``, ``fit_laplace``, ``drop_rates`` and ``multix`` phases on the
     written checkpoints against the runs' own evals; a captured DistilBERT
     MCD step against an eager one bit for bit, a captured loss forward
     under two keys, the eval runner against the host loop; 4 captured and
     2 eager steady steps of MAP, MCD, SVGD and LL_SVGD; one step of each
     new method on the card against the CPU at one layer of the same width;
10b. bf16 compute, last in the first process (``bf16_phase``): K1 on bf16
     planes (``csrc/gaussian_sample_bf16.cu``): the SASS instructions an
     element of its CUDA kernels and of the Triton kernel on bf16 planes,
     by part (``benchmarks_torch/k1_sass.py``); over 2^24 kernel draws the
     Philox words equal to the plain twin's bit for bit, z within the
     twin's stated tolerance, mean, variance, KS distance and the 3 and 4
     sigma counts within their bounds, |z| at most its 5.396 cap; on the
     planes of one poverty BBB, one camelyon17 BBB and one CIFAR BBB
     ResNet-20 train forward at bf16 (recorded from the models on the card)
     the kernel's z against the twin, the sample within one bf16 ulp of the
     plain version given that z, forward and backward, the seeded draw and
     its gradient = the same z given, the frozen row = one example's train
     draw, shards at an offset = the whole draw's rows, all bit for bit;
     those forwards' and backwards' launches timed in CUDA graphs against
     the Triton kernel on the same planes, the plain version, the byte bound
     at 6 B an element and the issue-rate floor of the SASS counts, and
     CIFAR's frozen-eval forward at batch 500; K3a and K3b on bf16 operands at (8, 12, 512, 64) and (16, 12,
     300, 64) against the plain version (output 2^-7, gradients 2^-6 of
     their scale; Philox on the fp32 kernel's mask), timed against the bf16
     bound and SDPA at bf16; one row per backbone at ``compute_dtype: bf16``
     (CIFAR ``bf16: true``) through ``run.main``, 2 steps, exact counts
     (amazon MCD, camelyon17 BBB, iwildcam MAP, poverty BBB, CIFAR BBB; K1's
     bf16 kernels every K1 launch of a BBB row but the fp32 head's); a
     captured amazon MCD bf16 step against an eager one bit for bit and its
     eval runner against the host loop; one bf16 BBB ResNet-20 update on the
     card against the CPU (within 3 x the CPU's own bf16 error from its fp32
     update); captured and eager steady steps at bf16 (amazon MAP, iwildcam
     MAP, CIFAR BBB), printed at the end beside the fp32 steps of the same
     rows timed the same way in this run (phases 10, 12; CIFAR BBB here).
 11. the WILDS image tasks: every row of configs/camelyon.yaml and
     configs/fmow.yaml through ``run.main`` at DenseNet-121's full width
     (the yamls' batch and input sizes, lr, S and conv_remat; synthetic
     images of the true shapes), cut to one epoch of 8 (camelyon17) or 4
     (fmow) steps and 32 test images, SWAG collecting at every step,
     MultiSWAG at 5 members, a row at a time with every count set to 0 just
     before and read just after, exact (K1 121 a camelyon17 BBB forward, 1 a
     fmow BBB forward; K2 once an SVGD step; K3 never); each row's wall time
     and peak memory; the four phases on the written checkpoints against the
     runs' own evals; 4 captured steps against 4 eager ones bit for bit
     (camelyon17 MAP and BBB, fmow MCD under remat ``layer``); the eval
     runner against the host loop (camelyon17 BBB, fmow MCD); 4 captured
     and 2 eager steady steps (camelyon17 MAP and BBB, fmow MAP with remat
     ``layer`` and ``none``, fmow SVGD); K1 on the 121 planes of one
     camelyon17 BBB train forward (batch 32) against its plain version, its
     forward and backward launches timed against the byte bound; K2 at (3,
     6,955,906) and (5, 7,017,406) beside ``torch.mm``; one step of
     camelyon17 MAP, BBB (K1, given noise) and Rank1, fmow MAP (remat), SNGP
     and two Adam steps across the schedule's epoch boundary on the card
     against the CPU at batch 4;
 12. the WILDS ResNet-50 tasks: every row of configs/iwildcam.yaml and
     configs/rxrx1.yaml through ``run.main`` at ResNet-50's full width (stage
     sizes (3, 4, 6, 3); the yamls' batch 16 / 75, input 448x448 / 256x256,
     eval batch, lr, S and schedule; synthetic images of the true shapes),
     cut to one epoch of 4 steps (rxrx1 with ``warmup_steps`` 1, so
     that the warmup and the cosine both run) and 32 test images,
     SWAG_LL collecting at every step, MAP twice, a row at a time with every
     count set to 0 just before and read just after, exact (K2 once an
     LL_SVGD step; K1 and K3 never); each row's wall time and peak memory,
     its metrics finite and in range (``macro_f1`` included); the four
     phases on rxrx1's checkpoints against the runs' own evals; 4
     captured iwildcam MAP steps against 4 eager ones bit for bit; the eval
     runner against the host loop (rxrx1 MAP: one padded batch of 75); 4
     captured and 2 eager steady steps of iwildcam MAP and rxrx1 MAP; K1 on
     the 54 planes of one iwildcam train forward with every layer
     variational (``all_layers_bbb``, batch 16) against its plain version,
     forward and backward timed against the byte bound; K2 at (5, 372,918)
     beside ``torch.mm``; one step of iwildcam MAP and SNGP and two rxrx1 MAP
     steps across the warmup's end on the card against the CPU and float64
     at batch 2;
 13. the WILDS PovertyMap task: every row of configs/poverty.yaml through
     ``run.main`` at ResNet-18's full width on 8 channels (224x224, batch
     64, Adam under the exponential schedule, S = 10; synthetic images of the
     true shape) on fold A of its five, cut to one epoch of 3 steps and 32
     test images, SWAG collecting at every step, MAP twice, a row at a time
     with exact counts (K1 21 a forward in BBB, every layer variational; K2
     once an SVGD step; K3 never); each row's wall time and peak memory, the
     regression metrics finite and every Pearson r in [-1, 1]; the four
     phases against the runs' own evals; 4 captured MAP steps against 4
     eager ones bit for bit; the eval runner against the host loop on a
     padded batch (80 test images at eval batch 64); 4 captured and 2 eager
     steady MAP steps and the peak memory; K1 on the 21 planes of one BBB
     train forward against its plain version and the byte bound; K2 at (5,
     11,174,210) beside ``torch.mm``; one MAP step on the card against the
     CPU and float64 at batch 2;
 14. the staged weights and DistilBERT remat: one amazon MAP update with
     ``bert_remat`` against the same update without it, K3 live, bit for
     bit; fmow's torchvision ``densenet121.pth`` and the text tasks'
     HuggingFace ``pytorch_model.bin``, written into ``build/`` at full
     width, loaded through ``build`` on the card, each tensor the file's;
 15. bnn-hmc, first in the second process (``bnn_hmc_phase``): ``run_hmc``
     on ``smooth_cnn_lstm`` at full width (vocabulary 20000, embedding 128,
     64 filters, cell 128) over synthetic IMDB's 2048 x 100-token train
     split (512 test reviews), 4 iterations of 10 leapfrog steps, burn-in 1;
     ``run_hmc`` on ``resnet20_frn_swish`` over 1024 CIFAR images, 2
     iterations of 5; ``run_sgmcmc`` (SGHMC, RMS preconditioner), ``run_vi``
     and ``run_sgd`` on LeNet-5 over synthetic MNIST (8192 images, batch 128,
     one epoch); each with K1, K2 and K3 counts set to 0 before and read 0
     after; one metrics entry an iteration, the ring's ``n_samples`` the
     accepted draws, the predictive average rebuilt from the ring's draws
     after burn-in; one leapfrog trajectory on 64 examples of each model on
     the card, on the CPU and in float64 (the card within 3 x the CPU's own
     error); a WilsonResNet20 chain stopped after 2 of 3 iterations and
     resumed = the uninterrupted chain, bit for bit (cuDNN deterministic);
     Wilson pickles written in the published layout (2 files x 3 chains):
     ``WilsonHMC`` on the card against the CPU on 8 images, ``eval_hmc`` on
     500 images (agreement 1, total variation 0), a CIFAR MAP ``run_single``
     with ``use_hmc_baseline`` at the Multi-X cut (1 epoch of 20 steps, 250
     images); the time of one full-batch gradient and one HMC iteration for
     each model;
 16. the multi-device phase (``parallel/mesh.py``, ``parallel/pipelines.py``),
     in the first process once the second has ended: (a) configs/fmow.yaml's
     SWAG_PODS row (``data_parallel``, ``ring_shard``, bf16 ring), cut as
     phase 11 cuts it with ``device_data`` on, through ``run.main`` under
     ``torchrun`` in a world of one NCCL rank (the epoch and eval runners
     capture its all-reduces), against phase 11's unflagged run of the row;
     (b) a world of two gloo ranks, both on the card (``mesh_rank``): K1 at
     a rank's row offset, fp32 and bf16, forward and backward, and K3a/K3b,
     fp32 and bf16, bit for bit the rows of the whole launch; then, each
     against this process's one-rank step from the same state and batch, a
     ResNet-20 BBB step at mc 2 (K1), a distilbert-base MCD step (K3), an
     SVGD step with one particle a rank (K2 on the gathered block) and one
     ``run_hmc`` iteration on the sharded full batch, within bounds of
     reduction order;
 17. running-statistics BatchNorm and the last models, last in the second
     process (``running_bn_phase``): configs/camelyon.yaml's MAP, MultiSWAG
     (5 members), BBB, SVGD and Laplace rows with ``static_bn: false`` at
     DenseNet-121's full width through ``run.main`` (batch 32, 4 steps, 32
     test images), counts exact (K1 121 a BBB forward, K2 once an SVGD
     step); camelyon17 MAP and BBB captured = eager with the 242 running
     statistics among the tensors compared; an update under remat
     ``layer`` and ``block`` = one under ``none`` (the statistics stepped
     once); K1 at the BBB row's 121 planes and K2 at (3, 6,955,906) against
     their plain twins; one iwildcam ResNet-50 MAP update under
     ``conv_remat`` ``block`` and ``stage`` = one under ``none``; one
     full-width PreResNet-20 BBB update at batch 128 and one with every
     layer on ``sampling="parameters"``, K1's counts exact and K1 held at
     their planes; MidasTiramisu at ``features=256``, card against CPU and
     a timed forward at 2x3x384x384; each part's wall time;
 18. the runner figures, the Multi-X figures, the rest-of-CIFAR figures, the
     UCI figures, the WILDS figures, the image, ResNet-50 and poverty
     figures, the bnn-hmc figures, the staged-weight checks, phase 17's and the
     multi-device figures as JSON lines, the card's name and power limit, one JSON line of kernel figures
     (K1, K1 on bf16 planes, K2, K3a, K3b), then the result line ``{"ok": true, "device":
     {...}}``.
Every phase heading prints the seconds since the script started.
Exits non-zero and prints no result without CUDA or without the package
beside this file.
"""
import contextlib
import fcntl
import functools
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")
CARD = ""  # "name, power limit" as nvidia-smi gives them, printed beside every phase's times
T_START = time.perf_counter()  # reset when main starts

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
SM_COUNT = 132
SM_CLOCK_MHZ = 1980  # the largest SM clock (nvidia-smi clocks.max.sm), read again in the bf16 phase
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
SMOKE = {"epochs": 1, "subsample": 1280, "test_subsample": 500, "seed": 0, "device_eval": False}
TRAIN_STEPS = 10
# configs/cifar.yaml's DEFAULT block beyond the port's DEFAULT_CONFIG
YAML_DEFAULT = {"corrupted_intensities": [0, 1, 2, 3, 4]}
# the runner phase: device_data (the epoch runner, the eval runner), one
# epoch of 50 steps at batch 128 on synthetic images, 250 test images per
# split at S = 50, eval batch 500; then COMPARE_STEPS captured steps against eager ones and
# TIMED_STEPS of each timed
RUNNER = {"epochs": 1, "subsample": 50 * 128, "test_subsample": 250, "seed": 0, "device_data": True}
COMPARE_STEPS = 4
TIMED_STEPS = 10
# idle host time on each side of a profile's window (profile_steps)
PROFILE_PAD_S = 0.1
# the Multi-X phase: configs/cifar.yaml's variants (DEFAULT's lr, weight
# decay and schedule are the port's DEFAULT_CONFIG), each through run_single
# with device_data, cut to MULTIX (epochs and data size only): 1 epoch of 20
# steps at batch 128, the test split and two corrupted splits of 250
# images at S = 50 (intensities 0 and 4, the first and last of DEFAULT's
# five: a depth cut that pays for the ResNet-50 phase; the runner phase keeps
# all five); SWAG's start epoch cut in proportion (250 of 300 -> 0 of 1), so
# each member collects the epoch's 20 steps
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
MULTIX = {"epochs": 1, "subsample": 20 * 128, "test_subsample": 250, "seed": 0, "device_data": True,
          "corrupted_intensities": [0, 4]}
MULTIX_SWAG_START = MULTIX["epochs"] * 250 // 300
MULTIX_EAGER_STEPS = 3  # an eager MultiBBB step takes about a second
# resume: MultiSWAG over 3 epochs of 10 steps, collecting from epoch 1;
# multix: three MAP runs of one epoch of 10 steps, the test split only
RESUME = {"epochs": 3, "subsample": 10 * 128, "test_subsample": 100, "seed": 0, "device_data": True,
          "swag_start_epoch": 1}
MULTIX_CHECK = {"epochs": 1, "subsample": 10 * 128, "test_subsample": 250, "seed": 0, "device_data": True,
                "corrupted_intensities": []}
# the rest of CIFAR: configs/cifar.yaml's rows Rank1, iVON, MultiiVON, SNGP,
# Laplace and MultiLaplace (DEFAULT's lr, weight decay and schedule are the
# port's DEFAULT_CONFIG), each through run_single with device_data at the
# MULTIX cut (1 epoch of 20 steps, three splits of 250 images, S = 50,
# SNGP's row S = 1)
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


# The script runs as two processes on the one card (``main``): the first,
# run with no arguments, builds and times the kernels, then starts the second
# (``--second``), which runs the phases of SECOND_PHASES while the first runs
# the others, and hands its figures back in a JSON file. A timed section
# (``alone``) takes a lock that lets one of the two time at a time and stops
# the other process (SIGSTOP) until it ends, so that its figures are taken on
# a card and host cores that nothing else of the script uses; the other's
# work already queued on the card gets SETTLE_S to drain first.
PEER = {"pid": None, "lock": None, "depth": 0, "child": None}
SETTLE_S = 0.1
SECOND_PHASES = ("bnn-hmc, UCI, the WILDS image, ResNet-50 and poverty phases, the staged weights and the "
                 "running statistics (15, 9, 11-14, 17)")
# each process's CPU threads (torch's intra-op pool): half the host's cores
# each, so that two CPU checks at once do not oversubscribe them
CPU_THREADS = 4
# each process's share of the card's memory (the caching allocator frees its
# cache and retries at its cap), so that neither's cache starves the other:
# the first's largest peak is a text row's, 27.8 GiB, the second's a poverty
# row's, 17.7 GiB; what is left is the two CUDA contexts' and the kernels'
MEMORY_FRACTION = {"first": 0.58, "second": 0.38, "mesh": 0.15}


def _signal_peer(sig):
    child = PEER["child"]
    if child is not None and child.poll() is not None:
        return False  # the second process has ended (and its pid may be another's)
    try:
        os.kill(PEER["pid"], sig)
        return True
    except ProcessLookupError:
        return False


@contextlib.contextmanager
def alone_section():
    """The other process stopped for the length of the block (re-entrant;
    a plain block before the second process starts)."""
    if PEER["pid"] is None or PEER["depth"]:
        PEER["depth"] += 1
        try:
            yield
        finally:
            PEER["depth"] -= 1
        return
    fcntl.flock(PEER["lock"], fcntl.LOCK_EX)
    PEER["depth"] += 1
    stopped = False
    try:
        stopped = _signal_peer(signal.SIGSTOP)
        if stopped:
            time.sleep(SETTLE_S)
        yield
    finally:
        PEER["depth"] -= 1
        if stopped:
            _signal_peer(signal.SIGCONT)
        fcntl.flock(PEER["lock"], fcntl.LOCK_UN)


def alone(fn):
    """``fn`` as a timed section (``alone_section``)."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        with alone_section():
            return fn(*args, **kwargs)
    return timed


def second_failed():
    """In the first process: raise if the second has exited with an error."""
    child = PEER["child"]
    if child is not None and child.poll() not in (None, 0):
        PEER["child"] = PEER["pid"] = None
        with open(second_paths()[0]) as f:
            print(f.read()[-20000:], file=sys.stderr)
        raise RuntimeError(f"the second process ({SECOND_PHASES}) exited with {child.returncode}; the end of its "
                           f"output is above, all of it in {second_paths()[0]}")


def second_paths():
    """The second process's output log and its JSON figures."""
    return os.path.join(BUILD, "chip_smoke_second.log"), os.path.join(BUILD, "chip_smoke_second.json")


def phase(title):
    """A phase's heading, with the seconds since the script started: every
    time printed under it was taken on this card."""
    second_failed()
    print(f"== {title} [{CARD}] (at {time.perf_counter() - T_START:.1f} s)")


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    second_failed()
    print(f"ok: {what}")


@alone
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


@alone
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
        with alone_section():  # the window alone; the trace's parsing after it need not be
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


@alone
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

    steady_steps(torch, step, label, 128, count=TRAIN_STEPS)
    return built, counts, config, step


def per_capture():
    """The host launches of one runner capture in units of the captured work:
    ``multistep._WARMUP`` warm-up calls (one), then the capture itself."""
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    return multistep._WARMUP + 1


def runner_counts_check(label, counts, config):
    """Host launch counts of the runner phase's run_single: the runners'
    warm-ups and captures launch through the wrappers (the warm-up and the
    capture of the step, the same of the eval batch), replays never."""
    captures = per_capture()
    forward = len(bbb_shapes(1))
    if config["model"] == "bbb":
        want = {"k1_gaussian_sample": captures * (config["bbb_mc_samples"] + config["eval_samples"]) * forward,
                "k1_gaussian_sample_backward": captures * config["bbb_mc_samples"] * forward, "k2_svgd_gram": 0}
    else:
        want = {"k1_gaussian_sample": 0, "k1_gaussian_sample_backward": 0, "k2_svgd_gram": captures}
    want.update({"k3a_attention_forward": 0, "k3b_attention_backward": 0})
    check(counts == want, f"{label} runner path: host launch counts {counts} (warm-ups and captures; replays "
          f"launch no wrapper)")


def runner_phase(torch, cifar, kernels, variant, label, ours):
    """``variant`` through ``run_single`` as configs/cifar.yaml writes it
    (DEFAULT's corrupted intensities) with ``device_data``: the epoch runner
    (one epoch of 50 replayed steps) and the eval runner (the test split and
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
    print(f"{label} run_single: {RUNNER['subsample'] // config['batch_size']} replayed steps + 6 splits x "
          f"{RUNNER['test_subsample']} images x S {config['eval_samples']} in {wall:.1f} s "
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
    times = {"eager": steady_steps(torch, eager_step, f"{label} eager", bs, count=TIMED_STEPS // 2),
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
        with alone_section():
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
    test split and MULTIX's two corrupted splits of 250 images, S = 50,
    or the row's own S), every count set to 0 just before each and read just
    after; SWAG's ``updates`` per member read from the run's saved
    ``swag_final``. Returns {label: {"wall_s", "host_counts", "updates"}}."""
    runs = {}
    per_forward = len(bbb_shapes(1))
    splits = ["test"] + [f"corrupted{i}" for i in MULTIX["corrupted_intensities"]]
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
            # host counts: the step graph's warm-up and capture (every
            # member, mc forwards each) and the eval graph's (S forwards)
            train_forwards = per_capture() * members * config["bbb_mc_samples"]
            want["k1_gaussian_sample"] = (train_forwards + per_capture() * config["eval_samples"]) * per_forward
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
              f"steps x {members} member(s) + {len(splits)} splits x {MULTIX['test_subsample']} images x S "
              f"{config['eval_samples']} in {wall:.1f} s [{CARD}]")
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


@alone
def eval_runner_vs_host(torch, cifar, built, config, test, label):
    """The eval runner against the host loop on the same keys, warm (each
    run twice, in the order runner, host, host, runner), on cuDNN's
    deterministic algorithms, so that both paths run the same convolution
    algorithms (and the metrics' bin sums are deterministic,
    ``evals/calibration.py``: they were atomics that moved an ECE by up to
    1.6e-5): metrics within 1e-5 relative, and samples/s of each."""
    x_test, y_test = test
    evals, rates = {}, {}
    n_samples = x_test.shape[0] * config["eval_samples"]
    torch.backends.cudnn.deterministic = True
    for mode, device_eval in (("runner", True), ("host loop", False), ("host loop", False), ("runner", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = cifar.eval_model(built, {**config, "device_eval": device_eval}, x_test, y_test).as_dict()
        torch.cuda.synchronize()
        if mode in evals:
            rates[mode] = n_samples / (time.perf_counter() - t0)
        evals[mode] = result
    torch.backends.cudnn.deterministic = False
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
          f"(10,000), corrupted intensities {MULTIX['corrupted_intensities']} (0-4); widths, batch, eval batch and S as the yaml writes them")
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

        def normal(self, shape, device, train, freeze_on_eval, **kw):
            eps = super().normal(shape, device, train, freeze_on_eval, **kw)
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


@alone
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
        with alone_section():
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
          f"(10,000), corrupted intensities {MULTIX['corrupted_intensities']} (0-4); widths, batch, eval batch and S as the yaml writes them; MultiiVON and MultiLaplace 5 members")
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
# the grid's nine models; cut: the list of eight data sets to energy (768
# rows, 22 steps an epoch at batch 32), epochs 100 -> 1, repetitions 5 -> 1;
# SVGD at 20 particles on energy
# too. The runners, steady steps, evaluate's rate, the card against the CPU
# and K1 and K2 at the MLP's shapes run on naval (the largest: 14 inputs,
# 11,934 rows, 10,741 train and 1,193 test)
UCI_DATASET = "naval"
UCI_CLI_DATASET = "energy"
UCI_CUT_EPOCHS = 1
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
    print(f"cut: list dataset {sweep['list']['dataset']} -> [{UCI_CLI_DATASET!r}], epochs {default['params']['epochs']} "
          f"-> {UCI_CUT_EPOCHS}, repetitions {default['repetitions']} -> 1; grid {sweep['grid']['model']} and "
          f"DEFAULT's other params kept: {default['params']}")
    default = {**default, "repetitions": 1, "params": {**default["params"], "epochs": UCI_CUT_EPOCHS}}
    sweep = {**sweep, "list": {"dataset": [UCI_CLI_DATASET]}}
    with open(path, "w") as f:
        yaml.safe_dump_all([default, sweep], f)
    return default["params"]


def uci_cli_phase(torch, kernels):
    """The CLI's nine runs on UCI_CLI_DATASET on the card, every count set
    to 0 just before ``run.main`` and read just after: K1 on bbb and bbb_fixed_kl
    only (mc 2 x 2 layers a step, forward and backward; S x 2 frozen at
    evaluate), K2 once a svgd step, K3 never. Each run's five metrics finite
    and QCE in [0, 1]; each run's wall time from its log record."""
    import tempfile

    from beyond_deep_ensembles_tpu_torch import run
    from beyond_deep_ensembles_tpu_torch.data.uci import UCI_SHAPES
    from beyond_deep_ensembles_tpu_torch.experiments import uci
    from beyond_deep_ensembles_tpu_torch.utils.config import load_sweep

    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = os.path.join(tmp, "uci_cli.yaml")
        params = uci_sweep_file(path)
        specs = list(load_sweep(path))
        models = [spec["params"]["model"] for spec in specs]
        check(models == list(uci.MODELS) and all(spec["params"]["dataset"] == UCI_CLI_DATASET for spec in specs),
              f"the cut sweep holds the nine models on {UCI_CLI_DATASET}: {models}")
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
                  f"CLI {model} on {UCI_CLI_DATASET}: metrics finite, QCE in [0, 1]: {json.dumps(result)}")
            walls[model] = record["_t"]
    n = UCI_SHAPES[UCI_CLI_DATASET][1]
    n_train = n - n // 10
    steps = UCI_CUT_EPOCHS * -(-n_train // params["batch_size"])
    mc, s = uci.DEFAULT_CONFIG["mc_samples"], params["eval_samples"]
    want = {name: 0 for name in kernels}
    want["k1_gaussian_sample"] = 2 * (steps * mc * 2 + s * 2)  # bbb and bbb_fixed_kl
    want["k1_gaussian_sample_backward"] = 2 * steps * mc * 2
    want["k2_svgd_gram"] = steps
    check(counts == want, f"CLI: launch counts {counts} = {want} ({steps} steps a run, mc {mc}, S {s}, 2 BBB layers)")
    print(f"CLI runs on {UCI_CLI_DATASET}, wall time each (s) [{CARD}]: {json.dumps(walls)}; run.main {wall:.1f} s")
    return {"wall_s": wall, "run_wall_s": walls, "host_counts": counts, "steps_per_run": steps}


def uci_svgd20_and_gap(torch, kernels, params):
    """SVGD at 20 particles through run_single on UCI_CLI_DATASET (K2 at n =
    20, once a step), then ``run`` of map on yacht with the gap splits
    (6)."""
    from beyond_deep_ensembles_tpu_torch.data.uci import UCI_SHAPES
    from beyond_deep_ensembles_tpu_torch.experiments import uci

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = uci.result_dict(uci.run_single({**params, "model": "svgd", "svgd_particles": 20, "dataset": UCI_CLI_DATASET,
                                          "epochs": 1}))
    wall = time.perf_counter() - t0
    n = UCI_SHAPES[UCI_CLI_DATASET][1]
    steps = -(-(n - n // 10) // params["batch_size"])
    check(kernels["k2_svgd_gram"].launches == steps and kernels["k1_gaussian_sample"].launches == 0,
          f"SVGD 20 particles, 1 epoch on {UCI_CLI_DATASET}: K2 launched {kernels['k2_svgd_gram'].launches} times "
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


@alone
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


@alone
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
    """UCI regression (configs/uci.yaml) on the card: the CLI's nine runs
    and SVGD at 20 particles on UCI_CLI_DATASET, a gap run, captured
    against eager for map, bbb and svgd, steady steps of map, bbb, svgd (10 and 20), ivon,
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
    """The four CUDA C++ sources compiled at once, one nvcc each; their
    build time and ptxas report (registers, spills). Triton compiles K1's
    fp32 kernels at first launch."""
    t0 = time.perf_counter()
    _cuda_build.build("svgd_gram.cu", "dropout_attention.cu", "dropout_attention_bf16.cu", "gaussian_sample_bf16.cu")
    print(f"K2, K3, K3 bf16 and K1 bf16 built in {time.perf_counter() - t0:.2f} s (four nvcc processes at once)")
    for source, log in sorted(_cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  nvcc {source}: {line.strip()}")


@alone
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



def device_kernels(torch, fn, reps=10):
    """The kernels one call of ``fn`` launches, from torch.profiler over
    ``reps`` calls after a warm-up, the window padded with idle host time as
    ``profile_steps`` pads it: (their summed device time per call in ms, or
    None where the trace has no device time or lost records, a kernel seen
    less than once a call; {kernel name: launches per call})."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with alone_section():
            prof.step()
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        prof.step()
    kernels = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("ProfilerStep")]
    device_us = sum(e.self_device_time_total for e in kernels)
    whole = device_us > 0 and all(e.count >= reps for e in kernels)
    return (device_us / 1e3 / reps if whole else None), {e.key: e.count / reps for e in kernels}


@alone
def graph_backward_ms(torch, forward, inputs, grad_out, reps=20):
    """Device time of the backward of ``forward(*leaves)`` alone, replayed
    from a CUDA graph: the forward is captured into one graph and its backward
    (``torch.autograd.grad`` to the leaves) into a second on the same capture
    stream, as ``torch.cuda.make_graphed_callables`` captures them, so the
    backward's operations run on the stream that captures them. The leaves
    are fresh copies of ``inputs``: a leaf whose earlier graph lives on
    another stream makes the capture fail."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            torch.autograd.grad(forward(*leaves), leaves, grad_out)
    torch.cuda.current_stream().wait_stream(stream)
    forward_graph, backward_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(forward_graph):
        out = forward(*leaves)
    with torch.cuda.graph(backward_graph, pool=forward_graph.pool()):
        torch.autograd.grad(out, leaves, grad_out)
    forward_graph.replay()
    backward_graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        backward_graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_timer(torch, fn, no_grad=False, graph=None):
    """The yardstick for a library call ``fn`` that stands beside a kernel:
    device time only. A CUDA-graph replay (``graph``, or ``graph_ms`` of
    ``fn``) where the call captures; otherwise the summed device durations of
    the kernels one call launches (``device_kernels``), over the same
    repetitions. Returns {"time": a function that takes one time in ms,
    "method", "kernels": what one call launches (its backend), "profiled_ms":
    their summed device time}."""
    def run():
        if no_grad:
            with torch.no_grad():
                return fn()
        return fn()

    def profiled():  # nan where the trace lost records
        return device_kernels(torch, run, reps=20)[0] or math.nan

    # the capture before any profiling: one that failed after a profile left
    # the caching allocator holding its cache (an out-of-memory error followed)
    graph = graph or (lambda: graph_ms(torch, run))
    try:
        graph()
        timer, method = graph, "CUDA-graph replay"
    except RuntimeError as exc:
        print(f"library call does not capture ({str(exc).splitlines()[0][:160]}): timed by the profiler")
        torch.cuda.synchronize()
        timer, method = profiled, "profiler, summed kernel device time"
    profiled_ms, kernels = device_kernels(torch, run)
    return {"time": timer, "method": method, "kernels": kernels, "profiled_ms": profiled_ms}


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


@alone
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
# and epochs only: one epoch of 4 steps (32 Amazon reviews at batch 8, 64
# comments at batch 16), 32 test examples (2 Amazon eval batches of 16, 1
# CivilComments batch of 32) at the rows' S; SWAG's
# collections in proportion (3 of 5 epochs -> from the cut's first step; 50
# collections over 2 epochs -> 4 over 4 steps); MAP run twice (repetitions
# 2) for the multix phase, every other row once
WILDS_STEPS = 4
WILDS_TEST = 32
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
# a task's yaml under configs/ where its name differs
YAML_NAMES = {"camelyon17": "camelyon"}


def wilds_yaml_docs(task):
    import yaml

    with open(os.path.join(ROOT, "configs", f"{YAML_NAMES.get(task, task)}.yaml")) as f:
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


def wilds_expected_counts(config, layers, steps=WILDS_STEPS):
    """The exact host launch counts of one row's run_single on the card:
    train (one update per call: every forward launches K3a once a layer and
    its backward K3b once a layer; BBB's two head layers K1 forward and
    backward; K2 once an SVGD step), the Laplace fit's one forward pass
    (K3a), and eval through the eval runner, whose host counters see its
    warm-up and its capture, never a replay (S forwards a batch, one for
    SNGP's multisample; BBB's head K1 frozen, twice a forward)."""
    model = config["model"]
    forwards = {"svgd": config["svgd_particles"], "ll_svgd": config["svgd_particles"],
                "ivon": config["ivon_mc_samples"], "ll_ivon": config["ivon_mc_samples"]}.get(model, 1)
    eval_forwards = per_capture() * (1 if model == "sngp" else config["eval_samples"])
    k3a = steps * forwards * layers + (layers if model == "laplace" else 0) + eval_forwards * layers
    bbb = model in ("bbb", "ll_bbb")
    return {
        "k1_gaussian_sample": (steps * 2 + eval_forwards * 2) if bbb else 0,
        "k1_gaussian_sample_backward": steps * 2 if bbb else 0,
        "k2_svgd_gram": steps if model in ("svgd", "ll_svgd") else 0,
        "k3a_attention_forward": k3a,
        "k3b_attention_backward": steps * forwards * layers,
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
    run.main([task, sweep, "--name", "MAP", "--out", out, "--rep", "1"])  # multix's second member
    return rows, results, figures


def wilds_phases(torch, task, rows, results, out):
    """The checkpoint phases through ``run.main`` on what the rows wrote:
    ``eval`` of MAP's ``map_final`` = the MAP run's own eval;
    ``fit_laplace`` of the Laplace row's own saved MAP state (its
    ``laplace_final``, written before the fit, copied to ``map_final`` in
    its run directory, so that the phase takes that row's ``ll_hessian``) =
    the Laplace row's eval (the same state, then the fit: a second MAP
    training would differ where cuDNN's backward is not deterministic);
    ``drop_rates`` of MCD's
    ``mcd_final`` at the MCD row's p = the MCD run's eval; ``multix`` over
    MAP's two repetitions = eval_task of a deep_ensemble of the two restored
    states. Each within 1e-5 relative."""
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
    laplace_dir = os.path.join(out, "Laplace_0", "rep_0")
    shutil.copy(os.path.join(laplace_dir, "laplace_final"), os.path.join(laplace_dir, "map_final"))
    run.main([task, sweep, "--name", "Laplace", "--out", out, "--rep", "0", "--phase", "fit_laplace"])
    fitted = last(os.path.join(out, "Laplace_0", "rep_0", "fit_laplace", "metrics.jsonl"))
    diffs["fit_laplace"] = close(fitted, results["Laplace"])
    run.main([task, sweep, "--name", "MCD", "--out", out, "--rep", "0", "--phase", "drop_rates"])
    rates = last(os.path.join(out, "MCD_0", "rep_0", "drop_rates", "metrics.jsonl"))
    diffs["drop_rates"] = close(rates[f"p={rows['MCD']['dropout_p']}"], results["MCD"])
    run.main([task, sweep, "--name", "MAP", "--out", out, "--phase", "multix"])
    got = last(os.path.join(out, "MAP_0", "multix", "metrics.jsonl"))
    dirs = [os.path.join(out, "MAP_0", f"rep_{r}") for r in range(2)]
    config, built, _, test = wilds_task._rebuild(task, rows["MAP"])
    states = [ckpt.restore_final(d, "map", wilds_task._build_for(task, config, built.device).state) for d in dirs]
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    diffs["multix"] = close(got, wilds_task.eval_task(built, task, config, *test))
    check(all(d <= 1e-5 for d in diffs.values()),
          f"{task} phases through run.main = the runs' own evals (max rel diff {json.dumps(diffs)} <= 1e-5): eval of "
          f"map_final = MAP; fit_laplace of the Laplace row's saved state = Laplace; drop_rates "
          f"p={rows['MCD']['dropout_p']} of mcd_final = MCD; "
          f"multix over MAP's two repetitions = a deep_ensemble of them")
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


def k2_wilds_times(torch, svgd_kernel, shapes=((5, 66_957_317), (5, 592_130))):
    """K2 at the WILDS rows' shapes, by default the text rows', (5,
    66,957,317) (SVGD over distilbert-base + Amazon's head) and (5, 592,130)
    (LL_SVGD's CivilComments heads): against fp64 and gram_plain, then its
    CUDA-graph time beside ``gram_plain``'s and ``torch.mm(x, x.T)``'s (TF32
    off), and the byte bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for n, p in shapes:
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


def wilds_built(torch, wilds_task, task, row, n_batches=WILDS_STEPS, **extra):
    """``row`` of configs/<task>.yaml built at full width on the card, with
    ``n_batches`` batches of its train split there (an image task's NCHW)."""
    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds

    docs = {d["name"]: d.get("params", {}) for d in wilds_yaml_docs(task)}
    bs = docs["DEFAULT"]["batch_size"]
    x, y, _ = load_wilds(task, "train", subsample=n_batches * bs)
    config = {**wilds_task.DEFAULT_CONFIG, **docs["DEFAULT"], **docs[row], "dataset_size": x.shape[0],
              "steps_per_epoch": WILDS_STEPS, "epochs": 1, **extra}
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), WILDS_STEPS)
    xd, yd = wilds_task._to_device(built, wilds_task.task_images(task, config, x), y)
    batches = [(xd[i * bs : (i + 1) * bs].clone(), yd[i * bs : (i + 1) * bs].clone()) for i in range(n_batches)]
    return built, config, batches


@alone
def wilds_step_times(torch, built, batches, label, captured=20, eager=10, k=WILDS_STEPS // 2):
    """Steady steps, ``captured`` replayed from one graph of ``k`` steps and
    ``eager`` one update per call, key mode both, CUDA events: ms a step
    each way."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

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
    del multi  # the graph's memory back to the allocator before the eager steps
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
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

    built, config, batches = wilds_built(torch, wilds_task, "amazon", "MCD")
    captured_vs_eager(torch, built, batches, "DistilBERT MCD (device_data)")
    loss_fn = wilds_task._loss_fn_for(built.model, built.regression)
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
    wilds_runner_vs_host(wilds_task, built, config, "amazon", "DistilBERT MCD")
    return built, batches


def wilds_runner_vs_host(wilds_task, built, config, task, label, n_test=WILDS_TEST):
    """``eval_task`` of ``n_test`` test examples through the eval runner
    against the host loop on the same keys, on cuDNN's deterministic
    algorithms (``eval_runner_vs_host``): metrics within 1e-5 relative."""
    import torch

    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds

    xt, yt, mt = load_wilds(task, "test", subsample=n_test)
    xt = wilds_task.task_images(task, config, xt)
    torch.backends.cudnn.deterministic = True
    evals = {mode: wilds_task.eval_task(built, task, {**config, "device_eval": mode}, xt, yt, mt)
             for mode in (True, False)}
    torch.backends.cudnn.deterministic = False
    diff = max(abs(evals[True][m] - evals[False][m]) / max(abs(evals[False][m]), 1e-30) for m in evals[False]
               if isinstance(evals[False][m], float))
    check(diff <= 1e-5, f"{label}: eval runner = host eval loop on the same keys (metrics max rel diff "
                        f"{diff:.2g} <= 1e-5; equal: {evals[True] == evals[False]})")
    return diff


# parameters whose gradient is zero in exact arithmetic, so that a step
# moves them by rounding alone: DistilBERT's k_lin biases (the softmax is
# blind to a shift of a row of scores) and the DenseNet stem norm's scale
# (every consumer of the stem's channels is a static BN, blind to a
# per-channel scale, behind a ReLU and a max pool)
ZERO_GRADIENT = ("k_lin.bias", "DenseNet_0._BN_0.StaticBatchNorm_0.scale")


def k_lin_layouts(state):
    """The flat layouts of a state's parameter vectors, each as a bool vector
    True on the ZERO_GRADIENT parameters' elements (the parameters' module
    order, the order of the optimizers', SWAG's and iVON's flat vectors)."""
    import torch

    from beyond_deep_ensembles_tpu_torch.methods.last_layer import LastLayerState

    groups = [list(state.backbone.items()), list(state.inner.params.named_parameters())] \
        if isinstance(state, LastLayerState) else [list(state.params.named_parameters())]
    return [torch.cat([torch.full((p.numel(),), n.endswith(ZERO_GRADIENT)) for n, p in group]) for group in groups]


def k_lin_elements(layouts, key, t):
    """True on the elements of state tensor ``key`` that hold a
    ZERO_GRADIENT parameter."""
    import torch

    if key.endswith(ZERO_GRADIENT):
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
    dropout off on both, as K3's Philox and the CPU's stream differ), held by
    ``card_vs_cpu_check`` (the k_lin biases: a gradient of zero in exact
    arithmetic, the softmax being blind to a shift of a row of scores)."""
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
        figures[label] = card_vs_cpu_check(torch, sides, layouts, f"{label} update on the card = CPU path at one "
                                                                     f"layer of distilbert-base")
    return figures


def card_vs_cpu_check(torch, sides, layouts, label):
    """``sides``: {"cpu" | "cuda": (loss, the state before on the CPU's side,
    the state after)} of one update from the same weights and draws. The
    loss within 1e-5 relative, the counters equal, and every tensor of the
    state: at most one element in a thousand (at least one) beyond 1e-4 of
    its tensor's largest change plus two roundings of it (of the mean, for a
    SWAG deviation), none beyond twice that change; the ZERO_GRADIENT
    parameters' elements held to twice the largest step of any parameter
    (Adam's first step is lr times the gradient's sign, which rounding sets
    where the gradient is near zero: a flip moves an element by twice the
    step). Returns the figures."""
    (l_cpu, b_cpu, a_cpu), (l_gpu, _, a_gpu) = sides["cpu"], sides["cuda"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst_share, outliers, flip_share, counters = 0.0, 0.0, 0.0, True
    shares = {}  # each tensor's largest gap over its largest change
    # the largest step of any parameter: the ZERO_GRADIENT parameters' bound
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
        shares[key] = float(gap.max()) / (change + 1e-30)
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
          f"{label} (loss rel err {loss_err:.1e} <= 1e-5; counters equal; state tensors at {worst_share:.3f} of "
          f"1e-4 of their largest change plus two roundings, elements beyond it at {outliers:.2g} of one in a "
          f"thousand (at least one) a tensor, those within {flip_share:.3f} of twice the largest change; "
          f"zero-gradient parameters within {k_lin_gap:.3f} of twice the largest parameter step; largest gaps over "
          f"their tensor's change: {json.dumps({k: round(v, 6) for k, v in sorted(shares.items(), key=lambda kv: -kv[1])[:3]})})")
    return {"loss_rel_err": loss_err, "bound_share": worst_share, "outlier_share": outliers,
            "flip_share": flip_share, "k_lin_share": k_lin_gap}


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
    figures["steps"] = {"MCD": wilds_step_times(torch, built, batches, "Amazon MCD", captured=4, eager=2)}
    del built
    torch.cuda.empty_cache()
    for row, task in (("MAP", "amazon"), ("SVGD", "amazon"), ("LL_SVGD", "civilcomments")):
        built, _, batches = wilds_built(torch, wilds_task, task, row)
        figures["steps"][row] = wilds_step_times(torch, built, batches, f"{task} {row}", captured=4, eager=2)
        del built, batches
        torch.cuda.empty_cache()
    figures["card_vs_cpu"] = wilds_card_vs_cpu(torch, wilds_task, NoiseSource)
    return figures


# the image phase (phase 11): configs/camelyon.yaml and configs/fmow.yaml at
# DenseNet-121's full width (growth 32, blocks (6, 12, 24, 16)), the yamls'
# batch and input sizes, lr, S and conv_remat, synthetic data of the true
# shapes; cut in depth only: IMAGE_STEPS steps a row (one epoch), 32 test
# images, SWAG collecting at every step from the first (its start epoch 0),
# MultiSWAG at its 5 members, MAP twice (multix)
IMAGE_STEPS = {"camelyon17": 8, "fmow": 4, "iwildcam": 4, "rxrx1": 4, "poverty": 3}
IMAGE_ROWS = {
    "camelyon17": ["MAP", "MCD", "SWAG", "MultiSWAG", "BBB", "Rank1", "iVON", "SVGD", "Laplace"],
    "fmow": ["MAP", "MCD", "SWAG", "SWAG_PODS", "SWAG_LL", "BBB", "Rank1", "SVGD", "iVON", "LL_iVON", "Laplace",
             "SNGP"],
}
# K1 launches a forward of each task's BBB row: camelyon17's DenseNet-121 is
# variational throughout (120 convs and the head), fmow's on the head only;
# iwildcam and rxrx1 have no BBB row; poverty's ResNet-18 is variational
# throughout (the stem, 16 block convs, 3 stride-2 shortcuts and the head)
IMAGE_K1_PER_FORWARD = {"camelyon17": 121, "fmow": 1, "iwildcam": 0, "rxrx1": 0, "poverty": 21}
# the sweep's keys beyond the cut: rxrx1's cosine_warmup over its 4 steps
# with one step of warmup (its default, 4 // 20, is none), so that the
# warmup branch (lr 0) and the cosine (lr, then 3/4 and 1/4 of it) both run
# on the card
IMAGE_EXTRA = {"rxrx1": {"warmup_steps": 1}}
# the row of the multi-device phase's world of one NCCL rank (phase 16 a),
# which phase 11 runs with device_data on, unflagged
MESH_ROW = ("fmow", "SWAG_PODS")
# K2's shapes: SVGD's particles x the DenseNet-121 classifier's parameters
K2_IMAGE_SHAPES = {"camelyon17": (3, 6_955_906), "fmow": (5, 7_017_406)}
# the card-against-CPU steps: full width at this batch (at least 2: the
# loaders read a subsample of 1 or less as a fraction of the split)
IMAGE_CPU_BATCH = 2


def image_sweep_file(task, path):
    """configs/<task>.yaml cut as IMAGE_* says, written to ``path``; returns
    {row: its params, DEFAULT's merged under}."""
    import yaml

    docs = wilds_yaml_docs(task)
    default, steps = docs[0], IMAGE_STEPS[task]
    batch = default["params"]["batch_size"]
    cut = {"epochs": 1, "subsample": steps * batch, "test_subsample": WILDS_TEST, **IMAGE_EXTRA.get(task, {})}
    folds = default.pop("list", {}).get("fold")
    if folds:  # poverty's five folds: the first
        cut["fold"] = folds[0]
    swag = {"swag_start_epoch": 0, "swag_updates": steps}
    # the row the multi-device phase runs again under torchrun: its epoch
    # and eval runners captured here as there
    pods = {"device_data": True} if task == MESH_ROW[0] else {}
    print(f"{task} cut: epochs {default['params']['epochs']} -> 1, subsample -> {cut['subsample']} ({steps} steps of "
          f"{batch}), test_subsample -> {WILDS_TEST}, repetitions {default['repetitions']} -> 1 (MAP 2); SWAG {swag}; "
          + (f"folds {folds} -> {folds[0]}; " if folds else "")
          + f"{json.dumps(IMAGE_EXTRA.get(task, {}))}; the rows' other params kept: {json.dumps(default['params'])}")
    out = [{**default, "repetitions": 1, "params": {**default["params"], **cut}}]
    for doc in docs[1:]:
        params = dict(doc["params"])
        if params["model"] in ("swag", "swag_ll"):
            params.update(swag)
        if doc["name"] == MESH_ROW[1]:
            params.update(pods)
        out.append({**doc, "params": params, **({"repetitions": 2} if doc["name"] == "MAP" else {})})
    with open(path, "w") as f:
        yaml.safe_dump_all(out, f)
    return {d["name"]: {**out[0]["params"], **d["params"]} for d in out[1:]}


def image_expected_counts(task, config, steps=None):
    """The exact host launch counts of one image row's run_single on the card:
    K1 in BBB (IMAGE_K1_PER_FORWARD a forward at mc 1; its backward as many
    a step), in training and in the eval runner's warm-up and capture
    (S forwards each, never a replay); K2 once an SVGD or LL_SVGD step; K3
    never."""
    steps, model = steps or IMAGE_STEPS[task], config["model"]
    per = IMAGE_K1_PER_FORWARD[task] if model == "bbb" else 0
    mc = config.get("bbb_mc_samples", 1)
    return {
        "k1_gaussian_sample": steps * mc * per + per_capture() * config["eval_samples"] * per,
        "k1_gaussian_sample_backward": steps * mc * per,
        "k2_svgd_gram": steps if model in ("svgd", "ll_svgd") else 0,
        "k3a_attention_forward": 0,
        "k3b_attention_backward": 0,
    }


def image_cli_rows(torch, task, kernels, out, names=None, sweep_file=image_sweep_file, steps=None, second_map=True):
    """Every row of configs/<task>.yaml through ``run.main`` (``--name`` a
    row at a time), every count set to 0 just before and read just after:
    the counts exact (``image_expected_counts``), the metrics finite and in
    range, the wall time and peak device memory. Each row's checkpoints are
    deleted after it but MAP's, MCD's and Laplace's, which the phases read.
    ``sweep_file(task, path)`` writes the cut sweep (``steps`` steps a
    row); ``second_map`` runs MAP's second repetition (multix's member)."""
    import shutil

    from beyond_deep_ensembles_tpu_torch import run
    from beyond_deep_ensembles_tpu_torch.experiments import wilds_task

    sweep = os.path.join(out, f"{task}.yaml")
    rows = sweep_file(task, sweep)
    figures, results = {}, {}
    for name in names or IMAGE_ROWS[task]:
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
        want = image_expected_counts(task, config, steps)
        check(counts == want, f"{task} {name}: launch counts {counts} = {want}")
        run_dir = os.path.join(out, f"{name}_0", "rep_0")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            result = {k: v for k, v in json.loads(f.read().splitlines()[-1]).items() if not k.startswith("_")}
        finite = all(math.isfinite(v) for v in result.values() if isinstance(v, (int, float)))
        if task == "poverty":  # the regression metrics and the urban/rural Pearson r
            shown = sorted(result)
            in_range = (set(result) == POVERTY_METRICS and result["mse"] >= 0.0 and 0.0 <= result["qce"] <= 0.5
                        and all(-1.0 <= result[k] <= 1.0 for k in ("r_urban", "r_rural", "r_all", "r_worst")))
        else:
            shown = [k for k in ("accuracy", "avg_log_likelihood", "ece", "macro_f1") if k in result]
            in_range = (0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0
                        and 0.0 <= result.get("macro_f1", 0.0) <= 1.0)
        check(finite and in_range,
              f"{task} {name}: metrics finite and in range: {json.dumps({k: result[k] for k in shown})}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        figures[name] = {"wall_s": wall, "peak_gib": peak, "counts": counts}
        results[name] = result
        print(f"{task} {name} through run.main: {wall:.1f} s, peak device memory {peak:.2f} GiB [{CARD}]")
        if name not in ("MAP", "MCD", "Laplace"):
            shutil.rmtree(os.path.join(out, f"{name}_0"), ignore_errors=True)
    if second_map:
        run.main([task, sweep, "--name", "MAP", "--out", out, "--rep", "1"])  # multix's second member
    return rows, results, figures


def recorded_noise(torch, NoiseSource, seed):
    """A given-mode NoiseSource whose draws are made as they are asked for,
    standard normal from a CPU generator, and kept in its given list, so
    that the other device's run can be given the same ones."""
    source, gen = NoiseSource(given=[]), torch.Generator().manual_seed(seed)

    def take(shape, batch_axis=None):  # one process: no rows to cut
        eps = torch.randn(tuple(shape), generator=gen)
        source._given.append(eps)
        source.draws += 1
        return eps

    source._take = take
    return source


def image_card_vs_cpu(torch, wilds_task, NoiseSource, sampling, cases=None, width="DenseNet-121"):
    """One update (two for the epoch boundary) of camelyon17's MAP, BBB and
    Rank1 and fmow's MAP (remat ``layer``), SNGP (the spectral DenseNet) and
    MAP across the schedule's epoch boundary (steps_per_epoch 1: the second
    step's Adam rate is lr x 0.96, read from the device count), from one
    state and the same draws on the card, on the CPU, and on the CPU in
    float64 (the same fp32 start; BBB's epilogue there by K1's plain
    version, which takes any dtype), at DenseNet-121's full width and the
    task's input size at batch IMAGE_CPU_BATCH: BBB's noise given (drawn for
    the CPU side and handed to the card's K1 launches), the rest key mode,
    whose draws are the same on all three. Through 121 layers of static BN
    an fp32 step is ill-conditioned (some BN scales' and biases' steps are
    rounding: the stem norm's scale has no true gradient, and under Adam a
    step near zero takes the rounding's sign), so the card is held to the
    CPU's own fp32 error: the card's state change within three times the
    CPU's distance from the float64 change (relative L2 over the whole
    state), or 1 % where that is smaller (the CPU's error of a step ran from
    0.001 % (a BBB step, its KL gradient exact and dominant) to 0.9 %
    (camelyon17 MAP) and 8 % (fmow's Adam) in this check's runs), the first
    step's loss within three times the CPU's error or 1e-5, the counters
    equal on all three."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data.wilds import load_wilds

    class PlainEpilogue(NoiseSource):
        """Given draws; the BBB epilogue by the plain version, for float64."""

        def gaussian(self, act_mean, act_var, b_mean, b_var, train, freeze_on_eval):
            shape = act_mean.shape[1:] if not train and freeze_on_eval else act_mean.shape
            eps = self._take(shape).to(device=act_mean.device, dtype=act_mean.dtype)
            return sampling.gaussian_sample_plain(act_mean, act_var, b_mean, b_var, eps)

    figures = {}
    cases = cases or [("camelyon17", "MAP", {}, 1), ("camelyon17", "BBB", {}, 1), ("camelyon17", "Rank1", {}, 1),
                      ("fmow", "MAP", {}, 1), ("fmow", "SNGP", {}, 1), ("fmow", "MAP", {"steps_per_epoch": 1}, 2)]
    for task, row, extra, steps in cases:
        docs = {d["name"]: d.get("params", {}) for d in wilds_yaml_docs(task)}
        config = {**wilds_task.DEFAULT_CONFIG, **docs["DEFAULT"], **docs[row], "dataset_size": 64,
                  "steps_per_epoch": 8, **extra}
        x, y, _ = load_wilds(task, "train", subsample=IMAGE_CPU_BATCH)
        x, y = torch.from_numpy(wilds_task.task_images(task, config, x)), torch.from_numpy(y)
        label = f"{task} {row}" + (f" over {steps} steps of the schedule" if steps > 1 else "")
        sides, recorded, before = {}, {}, None
        t0 = time.perf_counter()
        for side, device, dtype in (("cpu", "cpu", torch.float32), ("cuda", "cuda", torch.float32),
                                    ("fp64", "cpu", torch.float64)):
            torch.set_default_dtype(dtype)
            try:
                built = wilds_task.build(task, config, torch.Generator().manual_seed(3), 8, device=device)
            finally:
                torch.set_default_dtype(torch.float32)
            state = built.state
            if before is None:
                before = {k: t.detach().clone().cpu() for k, t in state.state_dict().items()}
            else:
                with torch.no_grad():
                    for k, t in state.state_dict().items():
                        t.copy_(before[k])
            losses = []
            for i in range(steps):
                if row != "BBB":
                    noise = NoiseSource(key=keys.as_key(keys.fold_in(6, i), device))
                elif side == "cpu":
                    noise = recorded[i] = recorded_noise(torch, NoiseSource, 4 + i)
                else:
                    noise = (PlainEpilogue if side == "fp64" else NoiseSource)(given=recorded[i]._given)
                state, metrics = built.method.update(state, noise, (x.to(device, dtype), y.to(device)))
                losses.append(float(metrics["loss"]))
            sides[side] = (losses[0], {k: t.detach().cpu() for k, t in state.state_dict().items()})
            del built, state
            torch.cuda.empty_cache()
        ref_loss, ref = sides["fp64"]
        floats = [k for k, t in before.items() if t.is_floating_point()]
        scale = math.sqrt(sum(float(((ref[k].double() - before[k].double()) ** 2).sum()) for k in floats))

        def error(side):
            got = sides[side][1]
            return math.sqrt(sum(float(((got[k].double() - ref[k].double()) ** 2).sum()) for k in floats)) / scale

        err = {side: error(side) for side in ("cpu", "cuda")}
        loss_err = {side: abs(sides[side][0] - ref_loss) / abs(ref_loss) for side in ("cpu", "cuda")}
        counters = all(torch.equal(sides[side][1][k], ref[k]) for k in before if k not in floats for side in sides)
        check(err["cuda"] <= max(3 * err["cpu"], 1e-2) and loss_err["cuda"] <= max(3 * loss_err["cpu"], 1e-5)
              and counters,
              f"{label}: the update on the card against the float64 step within 3 x the CPU's own fp32 error or 1 %, "
              f"at {width}'s width, batch {IMAGE_CPU_BATCH} (state change rel L2 err card {err['cuda']:.3g}, CPU "
              f"{err['cpu']:.3g}; first loss rel err card {loss_err['cuda']:.3g}, CPU {loss_err['cpu']:.3g}, within "
              f"3 x or 1e-5; counters equal)")
        figures[label] = {"card_rel_err": err["cuda"], "cpu_rel_err": err["cpu"], "card_loss_rel_err": loss_err["cuda"],
                          "cpu_loss_rel_err": loss_err["cpu"], "s": time.perf_counter() - t0}
        print(f"{label} card vs CPU vs float64: {time.perf_counter() - t0:.1f} s")
    return figures


def k1_hold(torch, sampling, planes, what):
    """K1 on each of ``planes`` (``(mean, var, b_mean, b_var)``) against
    ``gaussian_sample_plain`` with one z given (1e-6 of the largest output),
    gradients against the plain autograd (1e-5 relative), a DeviceSeed draw
    and its gradients against the same z given, bit for bit. These launches
    compare, they are not counted."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(35)
    key = torch.full((), 987_654_321, dtype=torch.int64, device=dev)
    worst, grad_worst, bitwise, scale = 0.0, 0.0, True, 1.0
    for i, layer in enumerate(planes):
        leaves = [t.clone().requires_grad_(True) if t is not None else None for t in layer]
        flat = [t for t in leaves if t is not None]
        seed = sampling.DeviceSeed(key, i)
        z = sampling.gaussian_sample(torch.zeros_like(layer[0]), torch.ones_like(layer[0]), seed=seed)
        given = sampling.gaussian_sample(*leaves, eps=z)
        ref = sampling.gaussian_sample_plain(*leaves, z)
        worst = max(worst, float((given - ref).detach().abs().max()))
        scale = max(scale, float(ref.detach().abs().max()))
        g = torch.randn(layer[0].shape, device=dev, generator=gen)
        want = torch.autograd.grad((given * g).sum(), flat)
        plain = torch.autograd.grad((ref * g).sum(), flat)
        for a, b in zip(want, plain):
            grad_worst = max(grad_worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        drawn = sampling.gaussian_sample(*leaves, seed=seed)
        got = torch.autograd.grad((drawn * g).sum(), flat)
        bitwise &= torch.equal(drawn, given) and all(torch.equal(a, b) for a, b in zip(got, want))
    check(worst <= 1e-6 * scale and grad_worst <= 1e-5 and bitwise,
          f"K1 at {what} ({len(planes)} launches) = plain (max abs err {worst:.3g} <= 1e-6 of the largest output, "
          f"{scale:.3g}; gradients rel err {grad_worst:.3g} <= 1e-5); DeviceSeed draws and gradients = the same z "
          f"given, bit for bit")
    return {"launches": len(planes), "max_abs_err": worst, "largest_output": scale, "grad_rel_err": grad_worst}


def recording_source(NoiseSource, planes):
    """A key-mode NoiseSource class that keeps the K1 planes it is handed:
    a BBB layer's activation planes (``gaussian``) and a parameter draw's
    mean and variance (``parameter``, one row for a 1-D parameter)."""

    class Recording(NoiseSource):
        def gaussian(self, act_mean, act_var, b_mean, b_var, train, freeze_on_eval):
            planes.append(tuple(None if t is None else t.detach().clone() for t in (act_mean, act_var, b_mean, b_var)))
            return super().gaussian(act_mean, act_var, b_mean, b_var, train, freeze_on_eval)

        def parameter(self, mean, var):
            shape = (1, -1) if mean.ndim == 1 else mean.shape
            planes.append((mean.detach().reshape(shape).clone(), var.detach().reshape(shape).clone(), None, None))
            return super().parameter(mean, var)

    return Recording


def image_k1_held(torch, sampling, wilds_task, NoiseSource, task="camelyon17", row="BBB", extra=None, planes_want=121,
                  what="camelyon17 BBB", layers="120 convs and the head"):
    """The K1 planes of one ``what`` train forward, recorded from the
    model's own forward on the card (row ``row`` of configs/<task>.yaml
    with ``extra``), their count checked and each held against
    ``gaussian_sample_plain`` (``k1_hold``): (the planes, the batch, the
    hold's figures with the launches, elements and bytes)."""
    from beyond_deep_ensembles_tpu_torch import keys

    planes = []
    built, config, batches = wilds_built(torch, wilds_task, task, row, **(extra or {}))
    with torch.no_grad():
        built.model.apply(built.state.params, {}, recording_source(NoiseSource, planes)(key=keys.as_key(1, "cuda")),
                          batches[0][0], train=True)
    batch = batches[0][0].shape[0]
    del built, batches
    torch.cuda.empty_cache()
    check(len(planes) == planes_want, f"K1: one {what} train forward hands K1 {len(planes)} planes ({layers})")
    n_elem = sum(m.numel() for m, _, _, _ in planes)
    n_bytes = sum(12 * m.numel() + (8 * m.shape[1] if bm is not None else 0) for m, _, bm, _ in planes)
    held = k1_hold(torch, sampling, planes, f"one {what} forward's planes ([{batch}, C, H, W], {n_elem} elements)")
    figures = {"launches_per_forward": len(planes), "elements": n_elem, "bytes": n_bytes,
               "max_abs_err": held["max_abs_err"], "largest_output": held["largest_output"],
               "grad_rel_err": held["grad_rel_err"]}
    return planes, batch, figures


def image_k1_checks(torch, sampling, wilds_task, NoiseSource, task="camelyon17", row="BBB", extra=None, planes_want=121,
                    what="camelyon17 BBB", layers="120 convs and the head"):
    """K1 at the planes of one ``what`` train forward (by default camelyon17's
    BBB: DenseNet-121, batch 32, 96x96: 120 convs and the head, 121
    launches; the planes recorded from the model's own forward on the card,
    row ``row`` of configs/<task>.yaml with ``extra``): outputs against
    ``gaussian_sample_plain`` with given noise (1e-6 absolute), gradients
    against the plain autograd (1e-5 relative), a DeviceSeed draw against
    the same z given, bit for bit; then the 121 forward launches and the 121
    backward launches, each in a CUDA graph, against the plain forward and
    the byte bound (act_mean and act_var read, the output written: 12 B an
    element; the backward reads g and act_var and writes d act_var)."""
    planes, batch, figures = image_k1_held(torch, sampling, wilds_task, NoiseSource, task, row, extra, planes_want, what,
                                           layers)
    n_elem, n_bytes = figures["elements"], figures["bytes"]
    dev = torch.device("cuda")
    key = torch.full((), 123_456_789, dtype=torch.int64, device=dev)
    gs = [torch.randn_like(m) for m, _, _, _ in planes]

    def kernel_forward():
        for j, (m, v, bm, bv) in enumerate(planes):
            sampling.gaussian_sample(m, v, bm, bv, seed=sampling.DeviceSeed(key, j))

    def plain_forward():
        for m, v, bm, bv in planes:
            sampling.gaussian_sample_plain(m, v, bm, bv, torch.randn(m.shape, device=dev))

    def kernel_backward():
        for (_, v, _, bv), g in zip(planes, gs):
            sampling.gaussian_sample_backward(g, v, bv, seed=5)

    with torch.no_grad():
        times = in_turns({"kernel": lambda: graph_ms(torch, kernel_forward, reps=10),
                          "plain": lambda: graph_ms(torch, plain_forward, reps=10),
                          "backward": lambda: graph_ms(torch, kernel_backward, reps=10)}, rounds=1)
    bound = k1_bound_ms(n_elem, n_bytes)
    ms, plain_ms, back_ms = times["kernel"][0], times["plain"][0], times["backward"][0]
    print(f"K1 one {what} train forward at batch {batch} ({len(planes)} launches, {n_elem} elements, {n_bytes} "
          f"bytes): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, backward kernels {back_ms:.4f} ms, bound "
          f"{bound:.4f} ms (forward at {100 * bound / ms:.0f}% of it, backward {100 * bound / back_ms:.0f}%) [{CARD}]")
    return {**figures, "ms": ms, "plain_ms": plain_ms, "backward_ms": back_ms, "bound_ms": bound,
            "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_elem * K1_FLOPS_PER_ELEMENT / FP32_FLOPS_PER_S
            else "operations"}


def image_k2_shapes(torch, wilds_task):
    """K2's image shapes: SVGD's particles x the parameters of the port's
    DenseNet-121 classifier, counted from the model (2 and 62 classes)."""
    from beyond_deep_ensembles_tpu_torch.data.wilds import TASKS
    from beyond_deep_ensembles_tpu_torch.models.densenet import DenseNetClassifier

    for task, (n, p) in K2_IMAGE_SHAPES.items():
        got = sum(q.numel() for q in DenseNetClassifier(TASKS[task].classes, generator=torch.Generator()).parameters())
        check(got == p, f"{task}: the DenseNet-121 classifier has {got} parameters = K2's P {p}")
    return list(K2_IMAGE_SHAPES.values())


def image_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource):
    """Both image yamls through run.main at DenseNet-121's full width with
    exact launch counts, the checkpoint phases, captured steps against eager
    ones (camelyon17 MAP and BBB, fmow MCD with remat), the eval runner
    against the host loop, steady steps (camelyon17 MAP and BBB; fmow MAP
    with remat ``layer`` and ``none``, and SVGD), K1 and K2 at the image
    shapes, and one step of six rows against the CPU."""
    import gc
    import shutil

    def release():
        """Frees what the last part left: graphs and states held in
        reference cycles go at a collection, their memory at empty_cache."""
        gc.collect()
        torch.cuda.empty_cache()
        print(f"(at {time.perf_counter() - T_START:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held)")

    out = os.path.join(BUILD, "image_cli")
    figures = {"rows": {}, "phases": {}, "steps": {}}
    release()
    for task in IMAGE_ROWS:
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        t0 = time.perf_counter()
        rows, results, row_figures = image_cli_rows(torch, task, kernels, out)
        figures["rows"][task] = row_figures
        if task == MESH_ROW[0]:  # for the multi-device phase
            figures["mesh_row"] = {"params": rows[MESH_ROW[1]], "result": results[MESH_ROW[1]],
                                   "wall_s": row_figures[MESH_ROW[1]]["wall_s"]}
        figures["phases"][task] = wilds_phases(torch, task, rows, results, out)
        print(f"{task} rows and phases: {time.perf_counter() - t0:.1f} s [{CARD}]")
        release()
    shutil.rmtree(out, ignore_errors=True)
    figures["runner_vs_host"] = {}
    for task, row, extra in (("camelyon17", "MAP", {}), ("camelyon17", "BBB", {}), ("fmow", "MCD", {}),
                             ("fmow", "MAP", {}), ("fmow", "MAP", {"conv_remat": "none"}), ("fmow", "SVGD", {})):
        label = f"{task} {row}" + (" remat none" if extra else (" remat layer" if task == "fmow" else ""))
        torch.cuda.reset_peak_memory_stats()
        # the rows' train split (IMAGE_STEPS batches), which the loader keeps
        built, config, batches = wilds_built(torch, wilds_task, task, row, n_batches=IMAGE_STEPS[task], **extra)
        if (task, row) in (("camelyon17", "MAP"), ("camelyon17", "BBB"), ("fmow", "MCD")):
            captured_vs_eager(torch, built, batches, f"{label} (DenseNet-121)")
        if (task, row) in (("camelyon17", "BBB"), ("fmow", "MCD")):
            figures["runner_vs_host"][label] = wilds_runner_vs_host(wilds_task, built, config, task, label)
        if row != "MCD":
            figures["steps"][label] = wilds_step_times(torch, built, batches, label, captured=4, eager=2, k=2)
            figures["steps"][label]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del built, batches
        release()
    figures["k1"] = image_k1_checks(torch, sampling, wilds_task, NoiseSource)
    release()
    figures["k2"] = k2_wilds_times(torch, svgd_kernel, image_k2_shapes(torch, wilds_task))
    release()
    figures["card_vs_cpu"] = image_card_vs_cpu(torch, wilds_task, NoiseSource, sampling)
    return figures


# the ResNet-50 phase (phase 12): configs/iwildcam.yaml and configs/rxrx1.yaml
# at ResNet-50's full width (stage sizes (3, 4, 6, 3)), the yamls' batch
# (16 / 75) and input (448x448 / 256x256), eval batch, lr, S and schedule,
# synthetic data of the true shapes; cut in depth only (IMAGE_STEPS steps a
# row, one epoch, 32 test images, SWAG_LL collecting from the first step, MAP
# twice, rxrx1's warmup_steps 1: IMAGE_EXTRA)
RESNET_ROWS = {
    "iwildcam": ["MAP", "MCD", "SWAG_LL", "SWAG_LL_PODS", "LL_SVGD", "LL_iVON", "SNGP", "Laplace"],
    "rxrx1": ["MAP", "MCD", "SWAG_LL", "LL_iVON", "SNGP", "Laplace"],
}
# K1 on one iwildcam BBB train forward with every layer variational (the
# engine's all_layers_bbb, which no yaml row sets): 53 convs and the head
RESNET_K1_PER_FORWARD = 54
# K2's shape in iwildcam's LL_SVGD: 5 head particles x ResNet-50's Dense_0
# (2048 -> 182)
K2_RESNET_SHAPE = (5, 372_918)


def resnet_k2_shapes(torch):
    """K2's ResNet-50 shape, its P counted from the port's iwildcam head."""
    from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet50

    head = ResNet50(182, stage_sizes=(1, 1), generator=torch.Generator()).Dense_0
    p = sum(q.numel() for q in head.parameters()) - 182 * 512 + 182 * 2048
    check(p == K2_RESNET_SHAPE[1], f"iwildcam LL_SVGD: a head particle is ResNet-50's Dense_0, {p} parameters = "
                                   f"K2's P {K2_RESNET_SHAPE[1]}")
    return [K2_RESNET_SHAPE]


def keys_card_check(torch):
    """``keys.bits`` on the card (its int32 hash: the dropout
    masks of the MCD rows) against its int64 form on the card and against
    the CPU's values, for a device key and a host key with their high bits
    set and a stream past 2^31: bit for bit."""
    from beyond_deep_ensembles_tpu_torch import keys

    key, stream, n = keys.fold_in(keys.MASK, 5), (1 << 31) + 7, 10_000_019
    lo, hi = key & keys._M32, (key >> 32) ^ keys._mix32(stream & keys._M32)
    want = keys._mix32(keys._mix32(torch.arange(n, dtype=torch.int64, device="cuda") ^ lo) ^ hi)
    got = [keys.bits(keys.as_key(key, "cuda"), stream, n), keys.bits(key, stream, n, device="cuda")]
    cpu = keys.bits(key, stream, n)
    check(all(torch.equal(g, want) for g in got) and torch.equal(got[0].cpu(), cpu),
          f"keys.bits on the card (int32 hash) = its int64 form and = the CPU's, bit for bit ({n} values)")


def resnet_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource):
    """Both ResNet-50 yamls through run.main at full width with exact launch
    counts, the checkpoint phases on rxrx1, captured steps against eager
    ones (iwildcam MAP), the eval runner against the host loop (rxrx1 MAP:
    one padded batch of 75), steady steps (iwildcam MAP, rxrx1 MAP), K1 at
    one all-layers-BBB iwildcam forward's planes, K2 at iwildcam LL_SVGD's
    shape, and one step of iwildcam MAP, rxrx1 MAP under its schedule and
    iwildcam SNGP against the CPU and float64."""
    import gc
    import shutil

    def release():
        gc.collect()
        torch.cuda.empty_cache()
        print(f"(at {time.perf_counter() - T_START:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held)")

    out = os.path.join(BUILD, "resnet_cli")
    figures = {"rows": {}, "phases": {}, "steps": {}, "runner_vs_host": {}}
    keys_card_check(torch)
    release()
    for task, names in RESNET_ROWS.items():
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        t0 = time.perf_counter()
        rows, results, row_figures = image_cli_rows(torch, task, kernels, out, names)
        figures["rows"][task] = row_figures
        if task == "rxrx1":  # the smaller images (iwildcam's 448x448 MCD evals cost 43 s at drop_rates)
            figures["phases"][task] = wilds_phases(torch, task, rows, results, out)
        print(f"{task} rows{' and phases' if task == 'rxrx1' else ''}: {time.perf_counter() - t0:.1f} s [{CARD}]")
        release()
    shutil.rmtree(out, ignore_errors=True)
    for task in RESNET_ROWS:
        label = f"{task} MAP"
        torch.cuda.reset_peak_memory_stats()
        built, config, batches = wilds_built(torch, wilds_task, task, "MAP", n_batches=IMAGE_STEPS[task])
        if task == "iwildcam":
            captured_vs_eager(torch, built, batches, f"{label} (ResNet-50)")
        else:
            figures["runner_vs_host"][label] = wilds_runner_vs_host(wilds_task, built, config, task, label)
        figures["steps"][label] = wilds_step_times(torch, built, batches, label, captured=4, eager=2, k=2)
        figures["steps"][label]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del built, batches
        release()
    figures["k1"] = image_k1_checks(torch, sampling, wilds_task, NoiseSource, task="iwildcam", row="MAP",
                                    extra={"model": "bbb", "all_layers_bbb": True, "n_batches": IMAGE_STEPS["iwildcam"]}, planes_want=RESNET_K1_PER_FORWARD,
                                    what="iwildcam all-layers BBB", layers="53 convs and the head")
    release()
    figures["k2"] = k2_wilds_times(torch, svgd_kernel, resnet_k2_shapes(torch))
    release()
    figures["card_vs_cpu"] = image_card_vs_cpu(
        torch, wilds_task, NoiseSource, sampling, width="ResNet-50",
        cases=[("iwildcam", "MAP", {}, 1), ("iwildcam", "SNGP", {}, 1),
               ("rxrx1", "MAP", {"steps_per_epoch": 1, "epochs": 2, "warmup_steps": 1}, 2)])
    return figures


# the PovertyMap phase (phase 13): configs/poverty.yaml at ResNet-18's full
# width (224x224x8, batch 64, eval batch 64, Adam at 1e-3 under the
# exponential schedule, S = 10), synthetic data of the true shape; cut in
# depth only (fold A of the yaml's five, IMAGE_STEPS steps a row, one epoch,
# 32 test images, SWAG collecting from the first step, MAP twice)
POVERTY_ROWS = ["MAP", "MCD", "SWAG", "BBB", "Rank1", "SVGD", "iVON", "Laplace"]
POVERTY_METRICS = {"avg_lml", "avg_ll", "mse", "qce", "sqce", "r_urban", "r_rural", "r_all", "r_worst"}
# the eval runner against the host loop on a padded batch: 80 test images at
# eval batch 64, the second batch 16 images and 48 copies of the last
POVERTY_PADDED_TEST = 80


def poverty_k2_shapes(torch, wilds_task):
    """K2's poverty shape: SVGD's 5 particles x PovertyNet's parameters
    (ResNet-18's and GaussLayer's ``rho__mle``), counted from the port's
    model."""
    net = wilds_task._make_backbone("poverty", wilds_task.DEFAULT_CONFIG, torch.Generator())
    p = sum(q.numel() for q in net.parameters())
    check(p == 11_174_210, f"poverty SVGD: a particle is PovertyNet, {p} parameters (ResNet-18's 11,174,209 and "
                           f"rho__mle) = K2's P")
    return [(5, p)]


def poverty_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource):
    """configs/poverty.yaml through run.main at full width on fold A with
    exact launch counts (K1 21 a forward in BBB only, K2 once a step in SVGD
    only, K3 never), the regression metrics finite and every Pearson r in
    [-1, 1], the four checkpoint phases, 4 captured MAP steps against 4 eager
    ones, the eval runner against the host loop on a padded batch, steady
    captured and eager MAP steps with the peak memory, K1 at one BBB
    forward's 21 planes, K2 at SVGD's shape beside torch.mm, and one MAP step
    against the CPU and float64."""
    import gc
    import shutil

    def release():
        gc.collect()
        torch.cuda.empty_cache()
        print(f"(at {time.perf_counter() - T_START:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB held)")

    task, out = "poverty", os.path.join(BUILD, "poverty_cli")
    figures = {}
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    rows, results, figures["rows"] = image_cli_rows(torch, task, kernels, out, POVERTY_ROWS)
    figures["phases"] = wilds_phases(torch, task, rows, results, out)
    print(f"poverty rows and phases: {time.perf_counter() - t0:.1f} s [{CARD}]")
    shutil.rmtree(out, ignore_errors=True)
    release()
    label = "poverty MAP"
    torch.cuda.reset_peak_memory_stats()
    built, config, batches = wilds_built(torch, wilds_task, task, "MAP", n_batches=COMPARE_STEPS)
    captured_vs_eager(torch, built, batches, f"{label} (ResNet-18)")
    figures["runner_vs_host"] = wilds_runner_vs_host(wilds_task, built, config, task, f"{label} (padded batch)",
                                                     n_test=POVERTY_PADDED_TEST)
    figures["steps"] = wilds_step_times(torch, built, batches, label, captured=4, eager=2, k=2)
    figures["steps"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del built, batches
    release()
    figures["k1"] = image_k1_checks(torch, sampling, wilds_task, NoiseSource, task=task, row="BBB",
                                    extra={"n_batches": 1}, planes_want=IMAGE_K1_PER_FORWARD[task],
                                    what="poverty BBB", layers="the stem, 16 block convs, 3 shortcuts and the head")
    release()
    figures["k2"] = k2_wilds_times(torch, svgd_kernel, poverty_k2_shapes(torch, wilds_task))
    release()
    figures["card_vs_cpu"] = image_card_vs_cpu(torch, wilds_task, NoiseSource, sampling, width="ResNet-18",
                                               cases=[(task, "MAP", {}, 1)])
    return figures


def bert_remat_check(torch, wilds_task, NoiseSource, kernels):
    """Amazon's MAP at distilbert-base's width, one update with ``bert_remat``
    against the same update without it, from one state, key and batch, K3
    live (attention dropout in training): every written tensor and the loss
    bit for bit (the recompute in the backward replays K3's forward under
    the forward's seeds); K3a runs twice a layer under remat (the forward
    and its recompute), K3b once."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    runs = {}
    for remat in (False, True):
        built, _, batches = wilds_built(torch, wilds_task, "amazon", "MAP", n_batches=1, bert_remat=remat)
        for fn in kernels.values():
            fn.launches = 0
        state, metrics = built.method.update(built.state, NoiseSource(key=keys.as_key(17, "cuda")), batches[0])
        torch.cuda.synchronize()
        runs[remat] = ([t.detach().clone() for t in multistep._written_tensors(state)], metrics["loss"].clone(),
                       {k: fn.launches for k, fn in kernels.items()}, state.params.bert.config.remat)
        del built, state, batches
        torch.cuda.empty_cache()
    (plain, loss0, c0, r0), (remat, loss1, c1, r1) = runs[False], runs[True]
    layers = wilds_task._bert_config({}).n_layers
    equal = len(plain) == len(remat) and all(torch.equal(a, b) for a, b in zip(plain, remat))
    check(equal and torch.equal(loss0, loss1) and (r0, r1) == (False, True)
          and c0["k3a_attention_forward"] == layers and c1["k3a_attention_forward"] == 2 * layers
          and c0["k3b_attention_backward"] == c1["k3b_attention_backward"] == layers,
          f"amazon MAP with bert_remat = without it, one update at distilbert-base's width, bit for bit (all "
          f"{len(plain)} written tensors and the loss {float(loss0):.6f}); K3a {c0['k3a_attention_forward']} -> "
          f"{c1['k3a_attention_forward']} launches (the recompute), K3b {c0['k3b_attention_backward']} -> "
          f"{c1['k3b_attention_backward']}")
    return {"bitwise": equal, "k3a_launches": [c0["k3a_attention_forward"], c1["k3a_attention_forward"]]}


def _torchvision_densenet121(torch, gen):
    """Random tensors under torchvision ``densenet121``'s keys and shapes."""
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = 0.05 * torch.randn(cout, cin, k, k, generator=gen)

    def bn(key, c):
        sd.update({key + ".weight": 1 + 0.1 * torch.randn(c, generator=gen), key + ".bias": torch.zeros(c),
                   key + ".running_mean": torch.zeros(c), key + ".running_var": torch.ones(c),
                   key + ".num_batches_tracked": torch.tensor(0)})

    conv("features.conv0", 64, 3, 7)
    bn("features.norm0", 64)
    c = 64
    for b, layers in enumerate((6, 12, 24, 16)):
        for i in range(layers):
            key = f"features.denseblock{b + 1}.denselayer{i + 1}"
            bn(key + ".norm1", c)
            conv(key + ".conv1", 128, c, 1)
            bn(key + ".norm2", 128)
            conv(key + ".conv2", 32, 128, 3)
            c += 32
        if b < 3:
            bn(f"features.transition{b + 1}.norm", c)
            conv(f"features.transition{b + 1}.conv", c // 2, c, 1)
            c //= 2
    bn("features.norm5", c)
    sd.update({"classifier.weight": torch.zeros(1000, c), "classifier.bias": torch.zeros(1000)})
    return sd


def _hf_distilbert(torch, gen, cfg):
    """Random tensors under HuggingFace DistilBERT's keys and shapes (a
    sequence-classification file: ``distilbert.``-prefixed, with its head)
    and the port encoder's name for each."""
    sd, names = {}, {}

    def put(ours, theirs, value):
        sd["distilbert." + theirs], names[ours] = value, "distilbert." + theirs

    put("word_embeddings.embedding", "embeddings.word_embeddings.weight",
        0.02 * torch.randn(cfg.vocab_size, cfg.dim, generator=gen))
    put("position_embeddings.embedding", "embeddings.position_embeddings.weight",
        0.02 * torch.randn(cfg.max_position_embeddings, cfg.dim, generator=gen))
    put("embed_layer_norm.scale", "embeddings.LayerNorm.weight", 1 + 0.01 * torch.randn(cfg.dim, generator=gen))
    put("embed_layer_norm.bias", "embeddings.LayerNorm.bias", 0.01 * torch.randn(cfg.dim, generator=gen))
    shapes = {"q_lin": (cfg.dim, cfg.dim), "k_lin": (cfg.dim, cfg.dim), "v_lin": (cfg.dim, cfg.dim),
              "out_lin": (cfg.dim, cfg.dim), "lin1": (cfg.hidden_dim, cfg.dim), "lin2": (cfg.dim, cfg.hidden_dim)}
    for i in range(cfg.n_layers):
        for ours, theirs in (("q_lin", "attention.q_lin"), ("k_lin", "attention.k_lin"), ("v_lin", "attention.v_lin"),
                             ("out_lin", "attention.out_lin"), ("lin1", "ffn.lin1"), ("lin2", "ffn.lin2")):
            o, n = shapes[ours]
            put(f"layer_{i}.{ours}.kernel", f"transformer.layer.{i}.{theirs}.weight",
                0.02 * torch.randn(o, n, generator=gen))
            put(f"layer_{i}.{ours}.bias", f"transformer.layer.{i}.{theirs}.bias", 0.01 * torch.randn(o, generator=gen))
        for norm in ("sa_layer_norm", "output_layer_norm"):
            put(f"layer_{i}.{norm}.scale", f"transformer.layer.{i}.{norm}.weight",
                1 + 0.01 * torch.randn(cfg.dim, generator=gen))
            put(f"layer_{i}.{norm}.bias", f"transformer.layer.{i}.{norm}.bias",
                0.01 * torch.randn(cfg.dim, generator=gen))
    sd.update({"pre_classifier.weight": torch.zeros(cfg.dim, cfg.dim), "classifier.weight": torch.zeros(2, cfg.dim)})
    return sd, names


def staged_weights_check(torch, wilds_task):
    """The staged weights the port reads, written into ``build/staged`` at
    full width (random values under their files' layouts) and loaded through
    ``build`` on the card from ``$BDE_DATA_DIR``: fmow's torchvision
    ``pretrained/densenet121.pth`` (every conv of DenseNet-121 filled, in
    order; the 62-class head at its init) and the text tasks'
    HuggingFace ``distilbert-base-uncased/pytorch_model.bin`` (every encoder
    tensor from the file; the head at its init): each equal to its file's
    tensor, bit for bit."""
    import shutil

    staged, gen = os.path.join(BUILD, "staged"), torch.Generator().manual_seed(21)
    dense = _torchvision_densenet121(torch, gen)
    hf, names = _hf_distilbert(torch, gen, wilds_task._bert_config({}))
    os.makedirs(os.path.join(staged, "pretrained"), exist_ok=True)
    os.makedirs(os.path.join(staged, "distilbert-base-uncased"), exist_ok=True)
    torch.save(dense, os.path.join(staged, "pretrained", "densenet121.pth"))
    torch.save(hf, os.path.join(staged, "distilbert-base-uncased", "pytorch_model.bin"))
    before = os.environ.get("BDE_DATA_DIR")
    os.environ["BDE_DATA_DIR"] = staged
    try:
        config = {**wilds_task.DEFAULT_CONFIG, "model": "map", "dataset_size": 64, "steps_per_epoch": 1}
        fmow = wilds_task.build("fmow", config, torch.Generator().manual_seed(0), 1)
        convs = [p for p in fmow.state.params.parameters() if p.ndim == 4]
        want = [v for k, v in dense.items() if v.ndim == 4]
        dense_ok = (len(convs) == len(want) == 120 and convs[0].is_cuda
                    and all(torch.equal(p.detach().cpu(), w) for p, w in zip(convs, want)))
        check(dense_ok, f"fmow MAP built on the card from the staged densenet121.pth: its {len(convs)} convs = the "
                        f"file's, in order, bit for bit")
        del fmow
        amazon = wilds_task.build("amazon", config, torch.Generator().manual_seed(0), 1)
        enc = dict(amazon.state.params.bert.named_parameters())
        text_ok = (enc.keys() == names.keys() and enc["word_embeddings.embedding"].is_cuda
                   and all(torch.equal(p.detach().cpu(), hf[names[n]]) for n, p in enc.items()))
        check(text_ok, f"amazon MAP built on the card from the staged pytorch_model.bin: its {len(enc)} encoder "
                       f"tensors = the file's, bit for bit")
        del amazon
    finally:
        if before is None:
            os.environ.pop("BDE_DATA_DIR", None)
        else:
            os.environ["BDE_DATA_DIR"] = before
        shutil.rmtree(staged, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"densenet121": dense_ok, "distilbert": text_ok}


# the bf16 compute phase: one row per backbone at ``compute_dtype: bf16``
# (CIFAR: ``bf16: true``) through run.main, cut to BF16_STEPS updates and
# BF16_TEST test examples; (task, row, yaml's batch)
BF16_ROWS = (("amazon", "MCD"), ("camelyon17", "BBB"), ("iwildcam", "MAP"), ("poverty", "BBB"), ("cifar", "BBB"))
BF16_STEPS = 2
BF16_TEST = 32
# K3 at bf16: DistilBERT's Amazon train shape and CivilComments' eval shape
BF16_K3_SHAPES = [(8, 12, 512, 64), (16, 12, 300, 64)]
BF16_PEAK_FLOPS_PER_S = 989e12  # tensor cores, bf16 dense


def bf16_ulps(torch, got, want, terms=None, where=False):
    """|got - want| in bf16 spacings of ``want``, less what the fp32 sums
    before the one rounding may differ by (the kernel's fused multiply-add
    against the plain version's rounded product: 2^-22 of ``terms``, the
    magnitudes summed); with ``where``, also the flat index of the largest.
    The spacing is 2^(e - 8) for |want| = m 2^e, m in [0.5, 1), from
    ``frexp``: log2 on the card reads a power of two as just below it."""
    got, want = got.detach().double(), want.detach().double()
    spacing = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs().clamp_min(2.0**-126))[1] - 8)
    err = (got - want).abs()
    if terms is not None:
        err = (err - 2.0**-22 * terms.detach().double()).clamp_min(0.0)
    ulps = (err / spacing).flatten()
    at = int(ulps.argmax())
    return (float(ulps[at]), at) if where else float(ulps[at])


# K1 on bf16 planes (csrc/gaussian_sample_bf16.cu): the device key of its
# holds, the kernel draws of its distribution check, the frozen-eval batch
K1_BF16_KEY = 987_654_321
K1_BF16_DRAWS = 1 << 24
BF16_FROZEN_BATCH = 500
# the largest |z| the bf16 draw reaches: r at the smallest radial uniform, 2^-21
K1_BF16_Z_CAP = math.sqrt(42.0 * math.log(2.0))


def normal_draw_stats(torch, z):
    """Distribution statistics of the draws ``z`` against N(0, 1), each with
    its bound: the mean and the variance within 5 standard errors, the
    Kolmogorov-Smirnov distance below its 1 % critical value (1.628 /
    sqrt(n)), the counts beyond 3 and 4 sigma within 5 binomial standard
    deviations of n p; and the largest |z|. Returns (figures, all held)."""
    zd = z.detach().double().flatten()
    n = zd.numel()
    mean, var = float(zd.mean()), float(zd.var())
    s = torch.sort(zd).values
    cdf = 0.5 * torch.erfc(-s / math.sqrt(2.0))
    i = torch.arange(1, n + 1, dtype=torch.float64, device=zd.device)
    ks = float(torch.maximum(i / n - cdf, cdf - (i - 1) / n).max())
    figures = {"n": n, "mean": mean, "mean_bound": 5.0 / math.sqrt(n), "var": var,
               "var_bound": 5.0 * math.sqrt(2.0 / (n - 1)), "ks": ks, "ks_bound": 1.628 / math.sqrt(n),
               "max_abs": float(zd.abs().max())}
    held = abs(mean) <= figures["mean_bound"] and abs(var - 1.0) <= figures["var_bound"] and ks < figures["ks_bound"]
    for t in (3, 4):
        p = math.erfc(t / math.sqrt(2.0))
        k = int((zd.abs() > t).sum())
        bound = 5.0 * math.sqrt(n * p * (1.0 - p))
        figures[f"beyond_{t}"], figures[f"beyond_{t}_expected"], figures[f"beyond_{t}_bound"] = k, n * p, bound
        held &= abs(k - n * p) <= bound
    return figures, held


def k1_bf16_draw_checks(torch, sampling):
    """The bf16 kernels' draw over K1_BF16_DRAWS elements (one [1, n] plane,
    a DeviceSeed): its Philox words the twin's (``philox4x32_plain``) bit
    for bit, its z within ``noise_bf16_tolerance`` of ``normals_bf16_plain``,
    and the distribution statistics of ``normal_draw_stats``, |z| at most
    the cap sqrt(42 ln 2) = 5.396 that its smallest radial uniform gives."""
    dev = torch.device("cuda")
    seed = sampling.DeviceSeed(torch.full((), K1_BF16_KEY, dtype=torch.int64, device=dev), 7)
    like = torch.empty((1, K1_BF16_DRAWS), dtype=torch.bfloat16, device=dev)
    words = sampling.noise_bf16(like, seed, words=True)
    value = sampling._seed_value(seed)
    counters = torch.arange(words.shape[0], dtype=torch.int64, device=dev)
    want = torch.stack(sampling.philox4x32_plain(counters, 0, 0, 0, value & 0xFFFFFFFF, value >> 32), dim=-1)
    words_equal = torch.equal(words, want)
    z = sampling.noise_bf16(like, seed)[0]
    twin, radius = sampling.normals_bf16_plain(seed, K1_BF16_DRAWS, device=dev, with_radius=True)
    gap = (z.double() - twin.double()).abs()
    tolerance = sampling.noise_bf16_tolerance(radius)
    within = bool((gap <= tolerance).all())
    stats, held = normal_draw_stats(torch, z)
    stats["max_gap_to_twin"] = float(gap.max())
    stats["max_gap_over_tolerance"] = float((gap / tolerance).max())
    check(words_equal and within and held and stats["max_abs"] <= K1_BF16_Z_CAP,
          f"K1 bf16 draw over {K1_BF16_DRAWS} elements: Philox words = the twin's bit for bit; z within "
          f"2^-21 / r + 2^-18 r of the twin (largest gap {stats['max_gap_to_twin']:.3g}, "
          f"{stats['max_gap_over_tolerance']:.3f} of its bound); mean {stats['mean']:.2e} (bound "
          f"{stats['mean_bound']:.2e}), variance {stats['var']:.6f} (1 +- {stats['var_bound']:.2e}), KS "
          f"{stats['ks']:.2e} < {stats['ks_bound']:.2e}, beyond 3 sigma {stats['beyond_3']} (expected "
          f"{stats['beyond_3_expected']:.0f} +- {stats['beyond_3_bound']:.0f}), beyond 4 sigma {stats['beyond_4']} "
          f"(expected {stats['beyond_4_expected']:.0f} +- {stats['beyond_4_bound']:.0f}), largest |z| "
          f"{stats['max_abs']:.4f} <= {K1_BF16_Z_CAP:.4f} [{CARD}]")
    del words, want, z, twin, radius, gap, tolerance
    torch.cuda.empty_cache()
    return stats


def k1_bf16_hold(torch, sampling, planes, what):
    """K1 on ``planes`` (``(act_mean, act_var, b_mean, b_var)``, bf16; an
    fp32 head goes through the Triton kernel). On each bf16 plane, with a
    DeviceSeed: the kernel's own z (``noise_bf16``) within
    ``noise_bf16_tolerance`` of the twin and its Philox words the twin's bit
    for bit; the sample given that z within one bf16 ulp of the plain
    version beyond the fp32 sums' 2^-22 margin, d act_var within one ulp of
    the plain backward's; the seeded draw and d act_var = the same z given,
    bit for bit; the frozen row = example 0's train draw and the frozen
    forward and backward = that row given, bit for bit; the rows [1, B) and
    [B // 2, B) launched at their offset = those rows of the whole draw, bit
    for bit. Comparisons, not counted."""
    dev = torch.device("cuda")
    key = torch.full((), K1_BF16_KEY, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(34)
    worst, worst_back, worst_z, max_abs, bitwise = 0.0, 0.0, 0.0, 0.0, True
    worst_at = worst_back_at = ""

    def describe(i, m, at, got, want, a, std, z):
        """The element where a plane's largest gap lies, for the message."""
        return (f"plane {i} {tuple(m.shape)} element {at}: got {float(got.flatten()[at]):.9g}, plain "
                f"{float(want.flatten()[at]):.9g}, a {float(a.flatten()[at]):.9g}, std "
                f"{float(std.flatten()[at]):.9g}, z {float(z.flatten()[at % z.numel()]):.9g}")

    for i, (m, v, bm, bv) in enumerate(planes):
        seed = sampling.DeviceSeed(key, i)
        g = torch.randn(m.shape, device=dev, generator=gen).to(m.dtype)
        if m.dtype == torch.bfloat16:
            z = sampling.noise_bf16(m, seed)
            twin, radius = sampling.normals_bf16_plain(seed, m.numel(), device=dev, with_radius=True)
            worst_z = max(worst_z, float(((z.flatten() - twin).abs() / sampling.noise_bf16_tolerance(radius)).max()))
            words = sampling.noise_bf16(m, seed, words=True)
            value = sampling._seed_value(seed)
            counters = torch.arange(words.shape[0], dtype=torch.int64, device=dev)
            bitwise &= torch.equal(words, torch.stack(
                sampling.philox4x32_plain(counters, 0, 0, 0, value & 0xFFFFFFFF, value >> 32), dim=-1))
            del twin, radius, words, counters
        else:  # the fp32 head: its z read back from the Triton kernel at mean 0, variance 1
            zeros = torch.zeros(m.shape, device=dev)
            z = sampling.gaussian_sample(zeros, torch.ones_like(zeros), seed=seed)
        given = sampling.gaussian_sample(m, v, bm, bv, eps=z)
        ref = sampling.gaussian_sample_plain(m, v, bm, bv, z)
        a = sampling._add_bias(m.float(), None if bm is None else bm.float())
        std = torch.sqrt(sampling._add_bias(v.float(), None if bv is None else bv.float()))
        max_abs = max(max_abs, float((given.double() - ref.double()).abs().max()))
        ulps, at = bf16_ulps(torch, given, ref, a.abs() + (std * z).abs(), where=True)
        if ulps > worst:
            worst, worst_at = ulps, describe(i, m, at, given, ref, a, std, z)
        d_given = sampling.gaussian_sample_backward(g, v, bv, eps=z)
        ref_var = (g.float() * z * 0.5 / std).to(m.dtype)
        ulps, at = bf16_ulps(torch, d_given, ref_var, where=True)
        if ulps > worst_back:
            worst_back, worst_back_at = ulps, describe(i, m, at, d_given, ref_var, g, std, z)
        bitwise &= torch.equal(sampling.gaussian_sample(m, v, bm, bv, seed=seed), given)
        bitwise &= torch.equal(sampling.gaussian_sample_backward(g, v, bv, seed=seed), d_given)
        del a, std, ref, ref_var
        if m.dtype == torch.bfloat16:
            row = sampling.noise_bf16(m, seed, frozen=True)
            bitwise &= torch.equal(row, sampling.noise_bf16(m[:1], seed)[0])
            bitwise &= torch.equal(sampling.gaussian_sample(m, v, bm, bv, seed=seed, frozen=True),
                                   sampling.gaussian_sample(m, v, bm, bv, eps=row))
            bitwise &= torch.equal(sampling.gaussian_sample_backward(g, v, bv, seed=seed, frozen=True),
                                   sampling.gaussian_sample_backward(g, v, bv, eps=row))
            b = m.shape[0]
            for first in sorted({1 % b, b // 2}):
                rows = (first, b)
                part = sampling.gaussian_sample(m[first:].contiguous(), v[first:].contiguous(), bm, bv, seed=seed,
                                                rows=rows)
                bitwise &= torch.equal(part, given[first:])
                part = sampling.gaussian_sample_backward(g[first:].contiguous(), v[first:].contiguous(), bv,
                                                         seed=seed, rows=rows)
                bitwise &= torch.equal(part, d_given[first:])
        del z, given, d_given, g
    torch.cuda.empty_cache()
    check(worst <= 1.0 and worst_back <= 1.0 and worst_z <= 1.0 and bitwise,
          f"K1 bf16 at {what}'s {len(planes)} planes: the kernel's z within the twin's tolerance (largest gap "
          f"{worst_z:.3f} of it) and its Philox words the twin's bit for bit; = plain given that z within one bf16 "
          f"ulp (forward {worst:.2f} ulp beyond the fp32 sums' 2^-22 margin, at {worst_at}; backward "
          f"{worst_back:.2f} ulp, at {worst_back_at}); "
          f"DeviceSeed draws and d act_var = the same z given, the frozen row = example 0's train draw, frozen "
          f"= that row given, rows at an offset = the whole draw's, all bit for bit")
    return {"max_ulp": worst, "backward_max_ulp": worst_back, "max_z_gap_over_tolerance": worst_z,
            "max_abs_err": max_abs}


def k1_bf16_times(torch, sampling, planes, what, frozen=False, sass=None):
    """One forward's launches over ``planes`` in CUDA graphs, in turns: the
    port's kernels (the CUDA ones on bf16 planes, a DeviceSeed each), the
    Triton kernel on the same bf16 planes (the earlier bf16 path, through
    ``_launch_triton``), the plain forward; then, unless ``frozen``, the
    backward's launches both ways. Against the byte bound (6 B an element,
    the fp32 head's 12) and, from ``sass`` (``benchmarks_torch/k1_sass.py``'s
    counts), the issue-rate floor of the port's bf16 kernels: instructions
    over 4 schedulers x 132 SMs x 32 lanes at the card's largest SM clock."""
    dev = torch.device("cuda")
    key = torch.full((), K1_BF16_KEY, dtype=torch.int64, device=dev)
    seeds = [sampling.DeviceSeed(key, j) for j in range(len(planes))]
    gs = [torch.randn_like(m) for m, _, _, _ in planes]
    n_elem = sum(m.numel() for m, _, _, _ in planes)
    n_bytes = sum(3 * m.element_size() * m.numel() + (2 * bm.element_size() * m.shape[1] if bm is not None else 0)
                  for m, _, bm, _ in planes)

    def ours():
        for (m, v, bm, bv), seed in zip(planes, seeds):
            sampling.gaussian_sample(m, v, bm, bv, seed=seed, frozen=frozen)

    def triton():
        for (m, v, bm, bv), seed in zip(planes, seeds):
            sampling._launch_triton(m, v, bm, bv, None, seed, frozen, False)

    def plain():
        for m, v, bm, bv in planes:
            sampling.gaussian_sample_plain(m, v, bm, bv, torch.randn(m.shape[1:] if frozen else m.shape, device=dev))

    def ours_backward():
        for (_, v, _, bv), g, seed in zip(planes, gs, seeds):
            sampling.gaussian_sample_backward(g, v, bv, seed=seed)

    def triton_backward():
        for (_, v, _, bv), g, seed in zip(planes, gs, seeds):
            sampling._launch_triton(g, v, None, bv, None, seed, False, True)

    timers = {"kernel": lambda: graph_ms(torch, ours, reps=10), "triton": lambda: graph_ms(torch, triton, reps=10),
              "plain": lambda: graph_ms(torch, plain, reps=5)}
    if not frozen:
        timers.update({"backward": lambda: graph_ms(torch, ours_backward, reps=10),
                       "triton_backward": lambda: graph_ms(torch, triton_backward, reps=10)})
    with torch.no_grad():
        times = in_turns(timers, rounds=1)
    bound = k1_bound_ms(n_elem, n_bytes)
    fig = {"launches": len(planes), "elements": n_elem, "bytes": n_bytes, "bound_ms": bound,
           "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S >= n_elem * K1_FLOPS_PER_ELEMENT / FP32_FLOPS_PER_S
           else "operations",
           **{f"{name}_ms": t[0] for name, t in times.items()}, **{f"{name}_max_ms": t[-1] for name, t in times.items()}}
    fig["fixed_us_per_launch"] = 1e3 * (fig["kernel_ms"] - bound) / len(planes)
    line = (f"K1 bf16, {what} ({len(planes)} launches, {n_elem} elements, {n_bytes} bytes): kernel "
            f"{fig['kernel_ms']:.4f} ms ({100 * bound / fig['kernel_ms']:.0f}% of the {bound:.4f} ms bound), the "
            f"Triton kernel on the same planes {fig['triton_ms']:.4f} ms, plain {fig['plain_ms']:.4f} ms")
    if not frozen:
        line += (f"; backward {fig['backward_ms']:.4f} ms ({100 * bound / fig['backward_ms']:.0f}%), Triton "
                 f"{fig['triton_backward_ms']:.4f} ms")
    line += f"; {fig['fixed_us_per_launch']:.2f} us a launch above the bound"
    if sass:
        clock_hz = SM_CLOCK_MHZ * 1e6
        bf16_elem = sum(m.numel() for m, _, _, _ in planes if m.dtype == torch.bfloat16)
        for label in ("forward",) if frozen else ("forward", "backward"):
            counts = sass["after"][label]
            fig[f"{label}_issue_floor_ms"] = 1e3 * counts["total"] * bf16_elem / (32 * 4 * SM_COUNT * clock_hz)
            fig[f"{label}_special_function_floor_ms"] = (1e3 * counts["special_function"] * bf16_elem
                                                        / (16 * SM_COUNT * clock_hz))
            line += (f"; {label} issue floor {fig[f'{label}_issue_floor_ms']:.4f} ms ({counts['total']:.1f} "
                     f"instructions an element at {SM_CLOCK_MHZ} MHz), special-function floor "
                     f"{fig[f'{label}_special_function_floor_ms']:.4f} ms")
    print(line + f" [{CARD}]")
    return fig


def record_planes(torch, NoiseSource, model, params, x, train):
    """The K1 planes one forward of ``model`` hands its noise source (a
    key-mode source), cloned."""
    from beyond_deep_ensembles_tpu_torch import keys

    planes = []
    with torch.no_grad():
        model.apply(params, {}, recording_source(NoiseSource, planes)(key=keys.as_key(1, "cuda")), x, train=train)
    return planes


def bf16_k1_checks(torch, sampling, wilds_task, NoiseSource, task, row, planes_want, what, sass=None):
    """K1 on the bf16 planes of one ``what`` train forward at
    ``compute_dtype: bf16`` (recorded from the model's own forward on the
    card): ``k1_bf16_hold``, then ``k1_bf16_times``."""
    built, config, batches = wilds_built(torch, wilds_task, task, row, n_batches=1, compute_dtype="bf16")
    planes = record_planes(torch, NoiseSource, built.model, built.state.params, batches[0][0], True)
    batch = batches[0][0].shape[0]
    del built, batches
    torch.cuda.empty_cache()
    # the head computes in fp32, as the JAX package's (a dense layer of no dtype)
    check(len(planes) == planes_want and all(m.dtype == torch.bfloat16 for m, _, _, _ in planes[:-1])
          and planes[-1][0].dtype == torch.float32,
          f"K1 bf16: one {what} train forward hands K1 {len(planes) - 1} bf16 planes and the fp32 head's")
    held = k1_bf16_hold(torch, sampling, planes, f"one {what} train forward ([{batch}, C, H, W])")
    return {"launches_per_forward": len(planes), **held,
            **k1_bf16_times(torch, sampling, planes, f"one {what} train forward at batch {batch}", sass=sass)}


def bf16_k1_cifar(torch, sampling, cifar, NoiseSource, sass=None):
    """K1 on the planes of configs/cifar.yaml's BBB ResNet-20 at ``bf16:
    true`` (the main path's configuration at bf16): one train forward at
    batch 128 (21 bf16 planes and the fp32 head) held and timed as
    ``bf16_k1_checks`` does, then one frozen-eval forward at batch 500 (the
    eval batch: one noise row a plane for the whole batch) timed against the
    Triton kernel and its bound."""
    built, config, batches, (x_test, y_test) = _built(torch, cifar, BBB_VARIANT, steps=1, bf16=True)
    train = record_planes(torch, NoiseSource, built.model, built.state.params, batches[0][0], True)
    x_eval, _ = cifar._to_device(built, x_test[:BF16_FROZEN_BATCH], y_test[:BF16_FROZEN_BATCH])
    frozen = record_planes(torch, NoiseSource, built.model, built.state.params, x_eval, False)
    del built, batches, x_eval
    torch.cuda.empty_cache()
    per = len(bbb_shapes(1))
    check(len(train) == per == len(frozen) and all(m.dtype == torch.bfloat16 for m, _, _, _ in train[:-1])
          and train[-1][0].dtype == torch.float32,
          f"K1 bf16: one CIFAR BBB ResNet-20 forward at bf16 hands K1 {per - 1} bf16 planes and the fp32 head's, "
          f"train and eval")
    held = k1_bf16_hold(torch, sampling, train, "one CIFAR BBB ResNet-20 bf16 train forward ([128, C, H, W])")
    figures = {"launches_per_forward": per, **held,
               **k1_bf16_times(torch, sampling, train, "one CIFAR BBB ResNet-20 bf16 train forward at batch 128",
                               sass=sass)}
    figures["frozen_eval"] = k1_bf16_times(
        torch, sampling, frozen, f"one CIFAR BBB ResNet-20 bf16 frozen-eval forward at batch {BF16_FROZEN_BATCH}",
        frozen=True, sass=sass)
    return figures


def bf16_k1_phase(torch, sampling, wilds_task, cifar, NoiseSource):
    """K1 on bf16 planes: the SASS counts of its kernels before and after
    (``benchmarks_torch/k1_sass.py``), the draw's checks over
    K1_BF16_DRAWS elements, then poverty's, camelyon17's and CIFAR's planes
    held and timed."""
    import importlib.util

    global SM_CLOCK_MHZ
    SM_CLOCK_MHZ = int(float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()))
    spec = importlib.util.spec_from_file_location("k1_sass", os.path.join(ROOT, "benchmarks_torch", "k1_sass.py"))
    k1_sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k1_sass)
    sass = k1_sass.k1_counts(torch, sampling)
    k1_sass.print_counts(sass, CARD)
    figures = {"sass": sass, "draw": k1_bf16_draw_checks(torch, sampling)}
    figures["poverty"] = bf16_k1_checks(torch, sampling, wilds_task, NoiseSource, "poverty", "BBB", 21,
                                        "poverty BBB (ResNet-18, 224x224x8)", sass=sass)
    figures["camelyon17"] = bf16_k1_checks(torch, sampling, wilds_task, NoiseSource, "camelyon17", "BBB", 121,
                                           "camelyon17 BBB (DenseNet-121, 96x96)", sass=sass)
    figures["cifar"] = bf16_k1_cifar(torch, sampling, cifar, NoiseSource, sass=sass)
    return figures


def bf16_k3(torch, att, shape):
    """K3a and K3b on bf16 operands at ``shape`` against the plain version
    (output within 2^-7 of its scale, dQ, dK, dV within 2^-6 of theirs) at
    p = 0, with a given mask, and with Philox (the mask the fp32 kernel
    realizes with the same seed fed to the plain version; repeats bit for
    bit); then K3a, K3b as training runs it (from the keep bits K3a left),
    the plain version (its mask drawn; its backward
    by autograd, between events) and SDPA at bf16 with the key mask and
    dropout (``library_timer``: device time only, a CUDA-graph replay of its
    forward and of its backward alone where they capture, else the
    profiler's summed kernel time; its kernels printed), p = 0.1, in one
    timed section, in turns two rounds over (minimum and spread), against
    the bf16 bound (989 TFLOP/s, 3.35 TB/s)."""
    import torch.nn.functional as F

    b, h, l, d = shape
    q, k, v, do, mask = (t.bfloat16() if t.is_floating_point() else t for t in k3_inputs(torch, shape, seed=b + l + 1))
    gen = torch.Generator(device="cuda").manual_seed(5)
    given = torch.rand(b, h, l, l, device="cuda", generator=gen) >= K3_P
    _, probs = att.fused_dropout_attention_debug(q.float(), k.float(), v.float(), mask, dropout_p=K3_P, seed=4321)
    realized = probs > 0
    del probs
    worst = (0.0, 0.0)
    for p, kw, keep, label in ((0.0, {}, None, "p = 0"), (K3_P, {"keep": given}, given, f"given mask, p = {K3_P}"),
                               (K3_P, {"seed": 4321}, realized, f"Philox, p = {K3_P}")):
        out, grads = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw), q, k, v, do)
        ref, ref_grads = with_grads(torch, lambda *t: att.dropout_attention_plain(*t, mask, keep, dropout_p=p),
                                    q, k, v, do)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        gerr = max(float((g.float() - r.float()).abs().max()) / float(r.float().abs().max())
                   for g, r in zip(grads, ref_grads))
        check(out.dtype == torch.bfloat16 and err <= 2.0**-7 * scale and gerr <= 2.0**-6,
              f"K3 bf16 {shape} {label}: output = plain within 2^-7 of its scale (err {err:.3g}, scale "
              f"{scale:.3g}); dQ, dK, dV within 2^-6 of theirs (worst {gerr:.3g} of the scale)")
        if "seed" in kw:
            again, grads2 = with_grads(torch, lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw),
                                       q, k, v, do)
            check(torch.equal(out, again) and all(torch.equal(a, c) for a, c in zip(grads, grads2)),
                  f"K3 bf16 {shape} Philox: repeat runs equal bit for bit")
            # K3b alone draws the keep bits itself (its first launch); training reads K3a's
            with torch.no_grad():
                bias = att.key_bias(mask)
                o, lse, _ = att.attention_forward(q, k, v, bias, p, 4321, None)
                alone = att.attention_backward(q, k, v, bias, p, 4321, None, o, lse, do)
            check(torch.equal(o, out) and all(torch.equal(a, c) for a, c in zip(alone, grads)),
                  f"K3 bf16 {shape} Philox: K3b called alone (drawing the mask) = the training path bit for bit")
        worst = (max(worst[0], err), max(worst[1], gerr))
        del out, grads, ref, ref_grads
    del given, realized

    bias = att.key_bias(mask)
    # the training path: K3a leaves its keep bits, K3b reads them (``_Attend``)
    o, lse, _, drawn = att._forward(q, k, v, bias, K3_P, 5, None, False, keep_draws=True)
    drop_mask = (mask > 0)[:, None, None, :]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa(*t):
        return F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in t), attn_mask=drop_mask,
                                              dropout_p=K3_P).transpose(1, 2)

    sdpa_out = sdpa(*leaves)
    keep = torch.rand(b, h, l, l, device="cuda") >= K3_P
    plain_out = att.dropout_attention_plain(*leaves, mask, keep, dropout_p=K3_P)
    library = {"forward": library_timer(torch, lambda: sdpa(q, k, v), no_grad=True),
               "backward": library_timer(torch, lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True),
                                         graph=lambda: graph_backward_ms(torch, sdpa, (q, k, v), do))}
    for which, lib in library.items():
        lost = "" if lib["profiled_ms"] else " (the trace lost records here: benchmarks_torch/bf16_probe.py lists " \
                                             "them in a process of its own)"
        print(f"SDPA bf16 {shape} {which}, p = {K3_P}: timed by {lib['method']}; its kernels a call (profiler, "
              f"{lib['profiled_ms']} ms of device time{lost}): " + "; ".join(f"{n:g} x {name[:100]}"
                                                                            for name, n in lib["kernels"].items()))
    with alone_section():  # K3, SDPA and the plain version in turns, the other process stopped throughout
        with torch.no_grad():
            forward = in_turns({
                "kernel": lambda: graph_ms(torch, lambda: att.attention_forward(q, k, v, bias, K3_P, 5, None), reps=20),
                "library": library["forward"]["time"],
                "plain": lambda: graph_ms(torch, lambda: att.dropout_attention_plain(
                    q, k, v, mask, torch.rand(b, h, l, l, device="cuda") >= K3_P, dropout_p=K3_P), reps=10),
            })
        backward = in_turns({
            "kernel": lambda: graph_ms(torch, lambda: att._backward(q, k, v, bias, K3_P, 5, None, o, lse, do, drawn),
                                       reps=20),
            "library": library["backward"]["time"],
            "plain": lambda: events_ms(torch, lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True)),
        })
        with torch.no_grad():  # K3a as training runs it (leaving its bits), K3b called alone (drawing them)
            side = {"forward_drawing_ms": graph_ms(torch, lambda: att._forward(q, k, v, bias, K3_P, 5, None, False,
                                                                                 keep_draws=True), reps=20),
                    "backward_alone_ms": graph_ms(torch, lambda: att.attention_backward(q, k, v, bias, K3_P, 5, None,
                                                                                      o, lse, do), reps=20)}
    del sdpa_out, plain_out, keep, leaves
    panel = 2 * b * l * h * d  # bytes of one bf16 [B, L, H, D] tensor
    rows = {}
    for label, which, times, n_bytes, ops, err in (
        ("K3a", "forward", forward, 4 * panel + 4 * b * l + 4 * b * h * l, 4 * b * h * l * l * d, worst[0]),
        ("K3b", "backward", backward, 8 * panel + 4 * b * l + 4 * b * h * l, 10 * b * h * l * l * d, worst[1]),
    ):
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_PEAK_FLOPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        t, lib_t = times["kernel"][0], times["library"][0]
        measured = math.isfinite(lib_t)  # the profiler's stand-in may have lost records
        rows[label] = {"ms": t, "ms_spread": times["kernel"][-1] - t, "plain_ms": times["plain"][0],
                       **({"drawing_ms": side["forward_drawing_ms"]} if label == "K3a"
                          else {"alone_ms": side["backward_alone_ms"]}),
                       "library_ms": lib_t if measured else None,
                       "library_spread_ms": times["library"][-1] - lib_t if measured else None, "library_p": K3_P,
                       "library_method": library[which]["method"],
                       "bound_ms": bound, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "max_err": err}
        print(f"{label} bf16 {shape}, p = {K3_P}, {len(times['kernel'])} turns: kernel {t:.4f} ms (spread "
              f"{rows[label]['ms_spread']:.4f}), plain {times['plain'][0]:.4f} ms, SDPA bf16 {lib_t:.4f} ms (spread "
              f"{rows[label]['library_spread_ms']:.4f}, {library[which]['method']}), bound "
              f"{bound:.4f} ms by {rows[label]['bound_by']} (bf16 tensor cores 989 TFLOP/s: {ops_ms:.4f} ms; "
              f"bytes {bytes_ms:.4f} ms); kernel at {100 * bound / t:.0f}% of its bound, kernel / SDPA "
              f"{t / lib_t:.2f} [{CARD}]")
    print(f"K3 bf16 {shape}: K3a leaving its keep bits for K3b (training) {side['forward_drawing_ms']:.4f} ms; K3b "
          f"called alone, drawing the bits itself, {side['backward_alone_ms']:.4f} ms [{CARD}]")
    del q, k, v, do, o, lse, bias, drawn
    torch.cuda.empty_cache()
    return rows


def bf16_sweep_file(task, name, path):
    """Row ``name`` of configs/<task>.yaml with the bf16 key in DEFAULT, cut
    to BF16_STEPS updates of the yaml's batch and BF16_TEST test examples
    (CIFAR: one eval batch of 500, no corrupted split; poverty: fold A),
    written to ``path``; returns the row's params, DEFAULT's merged under."""
    import yaml

    docs = wilds_yaml_docs(task)
    default = dict(docs[0])
    batch = default["params"]["batch_size"]
    key = {"bf16": True} if task == "cifar" else {"compute_dtype": "bf16"}
    cut = {"epochs": 1, "subsample": BF16_STEPS * batch, "test_subsample": BF16_TEST, **key}
    if task == "cifar":
        cut["corrupted_intensities"] = []
    folds = default.pop("list", {}).get("fold")
    if folds:
        cut["fold"] = folds[0]
    print(f"bf16 {task} {name}: {json.dumps(cut)}; the row's other params kept")
    row = next(d for d in docs[1:] if d["name"] == name)
    with open(path, "w") as f:
        yaml.safe_dump_all([{**default, "repetitions": 1, "params": {**default["params"], **cut}}, row], f)
    return {**default["params"], **cut, **row["params"]}


def bf16_expected_counts(task, config):
    """The exact host launch counts of one bf16 row through run.main on the
    card (one update per call, then the eval runner's warm-up and capture of
    S forwards, never a replay): the fp32 rows' counts at BF16_STEPS."""
    if task in ("amazon", "civilcomments"):
        from beyond_deep_ensembles_tpu_torch.experiments import wilds_task

        return wilds_expected_counts(config, wilds_task._bert_config({}).n_layers, steps=BF16_STEPS)
    if task == "cifar":
        per, mc = len(bbb_shapes(1)), config["bbb_mc_samples"]
        k1 = per if config["model"] == "bbb" else 0
        return {"k1_gaussian_sample": k1 * (BF16_STEPS * mc + per_capture() * config["eval_samples"]),
                "k1_gaussian_sample_backward": k1 * BF16_STEPS * mc, "k2_svgd_gram": 0,
                "k3a_attention_forward": 0, "k3b_attention_backward": 0}
    return image_expected_counts(task, config, steps=BF16_STEPS)


def bf16_rows(torch, kernels, out):
    """BF16_ROWS through ``run.main`` a row at a time, every count set to 0
    just before and read just after: exact (``bf16_expected_counts``), the
    metrics finite, the wall time."""
    from beyond_deep_ensembles_tpu_torch import run
    from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task

    figures = {}
    for task, name in BF16_ROWS:
        sweep = os.path.join(out, f"bf16_{task}.yaml")
        row = bf16_sweep_file(task, name, sweep)
        config = {**(cifar.DEFAULT_CONFIG if task == "cifar" else wilds_task.DEFAULT_CONFIG), **row}
        k1, k1_back = kernels["k1_gaussian_sample"], kernels["k1_gaussian_sample_backward"]
        for fn in kernels.values():
            fn.launches = 0
        k1.bf16_launches = k1_back.bf16_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.main([task, sweep, "--name", name, "--out", os.path.join(out, f"bf16_{task}"), "--rep", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}
        bf16_counts = {"k1_gaussian_sample": k1.bf16_launches, "k1_gaussian_sample_backward": k1_back.bf16_launches}
        want = bf16_expected_counts(task, config)
        check(counts == want, f"bf16 {task} {name}: launch counts {counts} = {want}")
        # a BBB model's layers but its fp32 head go through the bf16 kernels
        per = (len(bbb_shapes(1)) if task == "cifar" else IMAGE_K1_PER_FORWARD.get(task, 0)) * (
            config["model"] == "bbb")
        want_bf16 = {k: counts[k] * (per - 1) // per if per else 0 for k in bf16_counts}
        check(bf16_counts == want_bf16, f"bf16 {task} {name}: launches of K1's bf16 kernels {bf16_counts} = "
              f"{want_bf16} (every K1 launch but the fp32 head's)")
        with open(os.path.join(out, f"bf16_{task}", f"{name}_0", "rep_0", "metrics.jsonl")) as f:
            record = {k: v for k, v in json.loads(f.read().splitlines()[-1]).items() if not k.startswith("_")}
        values = [x for v in record.values() for x in (v.values() if isinstance(v, dict) else [v])
                  if isinstance(x, (int, float))]
        check(values and all(math.isfinite(x) for x in values), f"bf16 {task} {name}: metrics finite")
        figures[f"{task} {name}"] = {"wall_s": wall, "counts": counts, "bf16_counts": bf16_counts}
        print(f"bf16 {task} {name} through run.main: {wall:.1f} s [{CARD}]")
    return figures


def bf16_card_vs_cpu(torch, cifar, NoiseSource):
    """One BBB ResNet-20 update (SGD, batch 16, given noise) from one state
    at bf16 on the card, at bf16 on the CPU and at fp32 on the CPU: the
    card's parameter change no farther from the CPU fp32 one than three
    times the CPU's own bf16 change is (L2 over all parameters)."""
    config = {**cifar.DEFAULT_CONFIG, **YAML_DEFAULT, **BBB_VARIANT, "dataset_size": 1280, "augment": False}
    gen = torch.Generator().manual_seed(3)
    x, y = torch.randn(16, 3, 32, 32, generator=gen), torch.randint(0, 10, (16,), generator=gen)
    start = cifar.build(config, torch.Generator().manual_seed(0), 10, device="cpu").state.params.state_dict()
    source = recorded_noise(torch, NoiseSource, seed=9)
    deltas, losses = {}, {}
    for label, bf16, device in (("cpu32", False, "cpu"), ("cpu16", True, "cpu"), ("card16", True, "cuda")):
        built = cifar.build({**config, "bf16": bf16}, torch.Generator().manual_seed(0), 10, device=device)
        built.state.params.load_state_dict(start)
        noise = source if label == "cpu32" else NoiseSource(given=list(source._given))
        built.state, m = built.method.update(built.state, noise, (x.to(device), y.to(device)))
        losses[label] = float(m["loss"])
        deltas[label] = torch.cat([(p.detach().cpu().double() - start[k].double()).reshape(-1)
                                   for k, p in built.state.params.named_parameters()])
    cpu_err = float((deltas["cpu16"] - deltas["cpu32"]).norm())
    card_err = float((deltas["card16"] - deltas["cpu32"]).norm())
    check(card_err <= 3 * cpu_err,
          f"bf16 BBB ResNet-20 update on the card against the CPU's fp32 update: parameter change off by "
          f"{card_err:.3g} (L2) <= 3 x the CPU's own bf16 error {cpu_err:.3g} (change {float(deltas['cpu32'].norm()):.3g}; losses "
          f"{losses})")
    return {"card_err": card_err, "cpu_err": cpu_err, "losses": losses}


def bf16_phase(torch, kernels, att, sampling, wilds_task, cifar, NoiseSource):
    """bf16 compute: K1 on bf16 planes (``bf16_k1_phase``: its SASS counts,
    its draw, poverty's, camelyon17's and CIFAR's planes), K3 on bf16
    operands (against their plain versions and bounds, K3 beside SDPA at
    bf16), one row per backbone through run.main with exact counts, a
    captured amazon MCD bf16 step against an eager one bit for bit and its
    eval runner against the host loop, a bf16 update on the card against the
    CPU, and captured steady steps at bf16 (amazon MAP, iwildcam MAP, CIFAR
    BBB; CIFAR BBB at fp32 too: the other two rows' fp32 steps are timed in
    their own phases)."""
    import tempfile

    def part(name):
        print(f"bf16 phase: {name} (at {time.perf_counter() - T_START:.1f} s)")

    part("K1")
    figures = {"k1": bf16_k1_phase(torch, sampling, wilds_task, cifar, NoiseSource)}
    part("K3")
    figures["k3"] = {str(shape): bf16_k3(torch, att, shape) for shape in BF16_K3_SHAPES}
    part("rows through run.main")
    with tempfile.TemporaryDirectory(dir=BUILD) as out:
        figures["rows"] = bf16_rows(torch, kernels, out)
    part("runners")
    built, config, batches = wilds_built(torch, wilds_task, "amazon", "MCD", compute_dtype="bf16")
    figures["captured_equals_eager"] = captured_vs_eager(torch, built, batches, "DistilBERT MCD bf16")
    figures["runner_vs_host"] = wilds_runner_vs_host(wilds_task, built, config, "amazon", "DistilBERT MCD bf16")
    del built, batches
    part("card against CPU")
    figures["card_vs_cpu"] = bf16_card_vs_cpu(torch, cifar, NoiseSource)
    part("steady steps")
    # amazon MAP's and iwildcam MAP's fp32 steps are timed the same way in
    # their own phases of this run (``wilds_phase``, ``resnet_phase``)
    steps = {}
    for task, row in (("amazon", "MAP"), ("iwildcam", "MAP")):
        built, _, batches = wilds_built(torch, wilds_task, task, row, compute_dtype="bf16")
        steps[f"{task} {row} bf16"] = wilds_step_times(torch, built, batches, f"{task} {row} bf16", captured=4, eager=2)
        del built, batches
        torch.cuda.empty_cache()
    for bf16 in (False, True):
        built, _, batches, _ = _built(torch, cifar, BBB_VARIANT, steps=WILDS_STEPS, bf16=bf16)
        label = f"CIFAR BBB {'bf16' if bf16 else 'fp32'}"
        steps[label] = wilds_step_times(torch, built, batches, label, captured=4, eager=2)
        del built, batches
        torch.cuda.empty_cache()
    figures["steps"] = steps
    return figures


# the bnn-hmc phase (second process): full-batch HMC on the smooth CNN-LSTM
# (synthetic IMDB's 2048 x 100-token train split, 512 test reviews) and on
# WilsonResNet20 (1024 CIFAR images), the minibatch entries on LeNet-5 over
# synthetic MNIST (8192 images, batch 128, one epoch), the card against the
# CPU and float64, a resumed chain, and the Wilson HMC baseline through
# pickles written here; the paper's full batches (20,000 reviews, 50,000
# images) and chain lengths are cut to these
BNN_LSTM = {"n_iterations": 4, "burn_in": 1, "n_leapfrog": 10, "step_size": 1e-4, "seed": 0}
BNN_RESNET = {"n_iterations": 2, "burn_in": 1, "n_leapfrog": 5, "step_size": 1e-4, "seed": 0}
BNN_RESUME = {"n_iterations": 3, "burn_in": 1, "n_leapfrog": 5, "step_size": 1e-4, "seed": 3}
BNN_MINIBATCH = {"n_epochs": 1, "batch_size": 128, "seed": 0}
BNN_CPU_EXAMPLES = 64
BNN_CPU_LEAPFROG = 5
WILSON_FILES, WILSON_CHAINS = 2, 3
WILSON_EVAL = 500
WILSON_RUN = {"model": "map", "members": 1, "epochs": 1, "subsample": 20 * 128, "test_subsample": 250, "seed": 0,
              "device_data": True, "corrupted_intensities": [], "use_hmc_baseline": True}


class _Stop(Exception):
    """Stops a chain at an iteration's log line, before its checkpoint."""


class _StopAt:
    def __init__(self, prefix):
        self.prefix = prefix

    def info(self, line):
        print(line)
        if line.startswith(self.prefix):
            raise _Stop(line)


class _Print:
    def info(self, line):
        print(line)


def _zero(kernels):
    for fn in kernels.values():
        fn.launches = 0


def _no_launch(kernels, label):
    counts = {name: fn.launches for name, fn in kernels.items()}
    check(all(v == 0 for v in counts.values()), f"{label}: K1, K2 and K3 launched 0 times ({counts})")
    return counts


def _haiku_tree(state):
    """A port WilsonResNet20 state dict as the haiku tree of the published
    samples (``conv2_d{,_i}`` w HWIO and b, ``frn{,_i}`` (1, 1, 1, C),
    ``linear`` w [in, out] and b), numpy."""
    out = {}
    for name, value in state.items():
        scope, leaf = name.rsplit(".", 1)
        a = value.detach().cpu().numpy()
        if scope == "linear":
            module = "linear"
        else:
            kind, idx = scope.rsplit("_", 1)
            module = {"conv": "conv2_d", "frn": "frn"}[kind] + ("" if idx == "0" else f"_{idx}")
        if leaf == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        elif scope.startswith("frn_"):
            a = a.reshape(1, 1, 1, -1)
        out.setdefault(module, {})[{"kernel": "w", "bias": "b"}.get(leaf, leaf)] = a
    return out


def _write_wilson(torch, root):
    """WILSON_FILES pickles in the published layout, each WILSON_CHAINS
    seeded WilsonResNet20 trees stacked on a leading chain axis."""
    import pickle

    import numpy as np

    from beyond_deep_ensembles_tpu_torch.models.resnet import WilsonResNet20

    d = os.path.join(root, "wilson_hmc", "cifar10")
    os.makedirs(d, exist_ok=True)
    for i in range(WILSON_FILES):
        chains = [_haiku_tree(WilsonResNet20(10, generator=torch.Generator().manual_seed(100 * i + c)).state_dict())
                  for c in range(WILSON_CHAINS)]
        stacked = {m: {k: np.stack([c[m][k] for c in chains]) for k in chains[0][m]} for m in chains[0]}
        with open(os.path.join(d, f"state-{i}.pkl"), "wb") as f:
            pickle.dump({"params": stacked, "net_state": {}, "iteration": i}, f)


def _rel_err(torch, got, want):
    """max |got - want| over max |want| (want float64)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def bnn_card_vs_cpu(torch, bnn_hmc, hmc, zoo, label, make, batch):
    """One leapfrog trajectory (BNN_CPU_LEAPFROG steps from the same
    parameters and momentum, BNN_CPU_EXAMPLES examples) on the card, on the
    CPU in fp32 and on the CPU in float64: the card's parameters, momentum
    and end log-likelihood within 3 x the CPU fp32's own error from float64
    plus 1e-6 of their scale (fp32's rounding), and the energy difference
    within 3 x the CPU's error plus 1e-6 of its terms' scale. No accept
    decision is compared."""
    import copy

    from beyond_deep_ensembles_tpu_torch import tree
    from beyond_deep_ensembles_tpu_torch.nn.base import Model

    model = make()
    x, y = batch
    gen = torch.Generator().manual_seed(7)
    flat0 = tree.ravel(tree.sorted_named(model.module))
    momentum = torch.randn(flat0.shape, generator=gen)
    runs = {}
    for side, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("float64", "cpu", torch.float64)):
        module = copy.deepcopy(model.module).to(device=device, dtype=dtype)
        xb = x.to(device=device, dtype=dtype) if x.is_floating_point() else x.to(device)
        fn = hmc.make_grad_fn(bnn_hmc.xent_loss_fn(Model(module)), x.shape[0], 1.0, module, {}, (xb, y.to(device)))
        p0 = flat0.to(device=device, dtype=dtype)
        m0 = momentum.to(device=device, dtype=dtype)
        loglik0, grad0 = fn(p0)
        step = torch.tensor(BNN_RESNET["step_size"], dtype=dtype, device=device)
        p1, m1, _, loglik1 = hmc.leapfrog(fn, p0, m0, grad0, loglik0, step, BNN_CPU_LEAPFROG)
        terms = [0.5 * m0.square().sum(), 0.5 * m1.square().sum(), loglik0, loglik1, 0.5 * p1.square().sum(),
                 0.5 * p0.square().sum()]
        energy = (terms[0] - terms[1]) - (terms[2] - terms[3]) - (terms[4] - terms[5])
        runs[side] = {"params": p1, "momentum": m1, "loglik": loglik1, "energy": energy,
                      "scale": sum(abs(float(t)) for t in terms)}
    ref = runs["float64"]
    errs = {}
    for what in ("params", "momentum", "loglik"):
        card, cpu = (_rel_err(torch, runs[s][what], ref[what]) for s in ("card", "cpu"))
        errs[what] = {"card": card, "cpu": cpu}
        check(card <= 3 * cpu + 1e-6, f"{label} leapfrog on the card against the CPU: {what} error from float64 "
                                      f"{card:.3g}, the CPU fp32's {cpu:.3g} (bound 3 x it + 1e-6)")
    diff = {s: float(runs[s]["energy"]) for s in runs}
    accept = {s: min(1.0, math.exp(min(v, 0.0))) for s, v in diff.items()}
    card_err, cpu_err = abs(diff["card"] - diff["float64"]), abs(diff["cpu"] - diff["float64"])
    # the energy difference is a difference of sums near ``scale``, each
    # known in fp32 to about its last bits: 1e-6 of the scale is 8 ulp
    scale = ref["scale"]
    check(card_err <= 3 * cpu_err + 1e-6 * scale,
          f"{label} energy difference on the card {diff['card']:.6g}, CPU {diff['cpu']:.6g}, float64 "
          f"{diff['float64']:.6g}, its terms' scale {scale:.4g} (bound 3 x the CPU's error + 1e-6 of the scale; "
          f"accept probabilities {accept['card']:.4g}, {accept['cpu']:.4g}, {accept['float64']:.4g})")
    return {"errors": errs, "energy_diff": diff, "accept_prob": accept, "energy_scale": scale}


def _hmc_figures(torch, bnn_hmc, hmc, model, batch, config, label):
    """Device time of one full-batch gradient and of one HMC iteration
    (CUDA events, taken alone) for ``model`` on ``batch``."""
    import copy

    from beyond_deep_ensembles_tpu_torch import tree
    from beyond_deep_ensembles_tpu_torch.nn.base import Model

    module = copy.deepcopy(model.module).cuda()
    m = Model(module)
    method = hmc.hmc_method(bnn_hmc.xent_loss_fn(m), dataset_size=batch[0].shape[0], step_size=config["step_size"],
                            n_leapfrog=config["n_leapfrog"], step_size_adaptation_speed=0.05)
    state = method.init(module, {})
    fn = hmc.make_grad_fn(bnn_hmc.xent_loss_fn(m), batch[0].shape[0], 1.0, module, {}, batch)
    flat = tree.ravel(tree.sorted_named(module))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed(call, reps):
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    with alone_section():
        grad_ms = timed(lambda: fn(flat), 5)
        iter_ms = timed(lambda: method.update(state, gen, batch), 2)
    print(f"{label}: one full-batch gradient {grad_ms:.2f} ms, one HMC iteration ({config['n_leapfrog']} leapfrog "
          f"steps) {iter_ms:.2f} ms, over {batch[0].shape[0]} examples, CUDA events [{CARD}]")
    return {"grad_ms": grad_ms, "iteration_ms": iter_ms, "examples": int(batch[0].shape[0]),
            "n_leapfrog": config["n_leapfrog"]}


def _chain_checks(torch, bnn_hmc, result, config, label):
    """The chain's counts: one metrics entry an iteration, the ring's
    n_samples the accepted draws (at most 20), the predictive average the
    softmax mean over the accepted draws after burn-in (rebuilt from the
    ring, within 1e-5)."""
    metrics, state = result["metrics"], result["state"]
    accepted = [bool(m["accepted"]) for m in metrics]
    check(len(metrics) == config["n_iterations"], f"{label}: {len(metrics)} metrics entries, one an iteration")
    check(int(state.n_samples) == min(sum(accepted), 20),
          f"{label}: the ring holds {int(state.n_samples)} draws = the {sum(accepted)} accepted")
    after = sum(accepted[config["burn_in"]:])
    check(("predictive" in result) == (after > 0), f"{label}: {after} accepted draws after burn-in averaged")
    return {"accepted": accepted, "after_burn_in": after, "accept_prob": [m["accept_prob"] for m in metrics],
            "step_size": [m["step_size"] for m in metrics]}


def _average_check(torch, state, model, x_test, after, want, label):
    import torch.nn.functional as F

    from beyond_deep_ensembles_tpu_torch import tree
    from beyond_deep_ensembles_tpu_torch.methods import rings

    unravel = tree.make_unravel(tree.sorted_named(state.params))
    with torch.no_grad():
        probs = [F.softmax(model.apply(unravel(rings.read(state.samples, state.n_samples, i, state.flat)), {}, None,
                                       x_test, train=False)[0], -1)
                 for i in range(after)]
    mean = torch.stack(probs).mean(0).cpu().numpy()
    err = float(abs(mean - want).max())
    check(err <= 1e-5, f"{label}: the predictive average = the mean of the {after} accepted draws' predictives "
                       f"after burn-in, rebuilt from the ring (max abs err {err:.3g})")


def bnn_hmc_phase(torch, kernels):
    """Phase 15 (second process): the bnn-hmc entries on the card with
    exact counts, the card against the CPU, a resumed chain and the Wilson
    baseline. Returns its figures."""
    import shutil

    import numpy as np

    from beyond_deep_ensembles_tpu_torch.data import cifar as cifar_data
    from beyond_deep_ensembles_tpu_torch.data import imdb, mnist, wilson
    from beyond_deep_ensembles_tpu_torch.experiments import bnn_hmc, cifar
    from beyond_deep_ensembles_tpu_torch.methods import hmc
    from beyond_deep_ensembles_tpu_torch.models import zoo
    from beyond_deep_ensembles_tpu_torch.nn.base import Model

    t0 = time.perf_counter()
    root = os.path.join(BUILD, "bnn_hmc")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    before = os.environ.get("BDE_DATA_DIR")
    os.environ["BDE_DATA_DIR"] = os.path.join(root, "data")  # the synthetic sets, then the pickles
    figures = {}
    try:
        tokens, labels = imdb.load_imdb("train")
        test = imdb.load_imdb("test")
        check(tokens.shape == (2048, 100) and test[0].shape == (512, 100),
              f"synthetic IMDB: train {tokens.shape}, test {test[0].shape}")
        lstm = lambda: zoo.get_model("smooth_cnn_lstm", 2, generator=torch.Generator().manual_seed(0))  # noqa: E731
        images, targets = cifar_data.load_cifar10(True, subsample=1024)
        test_images = cifar_data.load_cifar10(False, subsample=256)
        wilson_net = lambda: zoo.get_model("resnet20_frn_swish", 10,  # noqa: E731
                                          generator=torch.Generator().manual_seed(0))

        # HMC on the smooth CNN-LSTM (vocabulary 20000, embedding 128, 64
        # filters, cell 128) over the full batch
        model = lstm()
        check(sum(p.numel() for p in model.module.parameters()) == 20000 * 128 + 64 * 128 * 5 + 64 + 4 * 128 * (64 + 128 + 1)
              + 128 * 2 + 2, "smooth CNN-LSTM at full width")
        _zero(kernels)
        t = time.perf_counter()
        res = bnn_hmc.run_hmc(model, (tokens, labels), test, step_size_adaptation_speed=0.05, log=_Print(),
                              **BNN_LSTM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _no_launch(kernels, "run_hmc, CNN-LSTM")
        chain = _chain_checks(torch, bnn_hmc, res, BNN_LSTM, "run_hmc CNN-LSTM")
        run_model = Model(res["state"].params)
        x_test = torch.from_numpy(test[0]).long().cuda()
        if chain["after_burn_in"]:
            _average_check(torch, res["state"], run_model, x_test, chain["after_burn_in"], res["predictive"],
                           "run_hmc CNN-LSTM")
            check(all(math.isfinite(v) for v in res["eval"].values()), f"CNN-LSTM eval {json.dumps(res['eval'])}")
        print(f"run_hmc CNN-LSTM: {BNN_LSTM['n_iterations']} iterations of {BNN_LSTM['n_leapfrog']} leapfrog steps "
              f"over 2048 reviews in {wall:.2f} s [{CARD}]")
        figures["cnn_lstm"] = {**chain, "wall_s": wall, "counts": counts, "eval": res.get("eval"),
                               **_hmc_figures(torch, bnn_hmc, hmc, model,
                                              (torch.from_numpy(tokens).long().cuda(),
                                               torch.from_numpy(labels).cuda()), BNN_LSTM, "CNN-LSTM")}
        del res, run_model

        # HMC on WilsonResNet20 over 1024 images
        model = wilson_net()
        _zero(kernels)
        t = time.perf_counter()
        res = bnn_hmc.run_hmc(model, (images, targets), test_images, step_size_adaptation_speed=0.05, log=_Print(),
                              **BNN_RESNET)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _no_launch(kernels, "run_hmc, WilsonResNet20")
        chain = _chain_checks(torch, bnn_hmc, res, BNN_RESNET, "run_hmc WilsonResNet20")
        batch = (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().cuda(), torch.from_numpy(targets).cuda())
        figures["wilson_resnet20"] = {**chain, "wall_s": wall, "counts": counts,
                                      **_hmc_figures(torch, bnn_hmc, hmc, model, batch, BNN_RESNET, "WilsonResNet20")}
        del res

        # a chain stopped in its third iteration (checkpoint_1 on disk) and
        # resumed, against the uninterrupted chain, on deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            kw = dict(log=_Print(), **BNN_RESUME)
            whole = bnn_hmc.run_hmc(model, (images, targets), test_images, run_dir=os.path.join(root, "a"), **kw)
            try:
                bnn_hmc.run_hmc(model, (images, targets), test_images, run_dir=os.path.join(root, "b"),
                                **{**kw, "log": _StopAt("iter 2")})
            except _Stop:
                pass
            from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

            check(ckpt.latest_checkpoint_step(os.path.join(root, "b")) == 1, "resume: stopped in iteration 2")
            resumed = bnn_hmc.run_hmc(model, (images, targets), test_images, run_dir=os.path.join(root, "b"), **kw)
        finally:
            torch.backends.cudnn.deterministic = False
        a, b = whole["state"].state_dict(), resumed["state"].state_dict()
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        same = same and resumed["metrics"] == whole["metrics"][2:]
        check(same, f"resume: a WilsonResNet20 chain stopped after 2 of 3 iterations and resumed = the "
                    f"uninterrupted chain, bit for bit ({len(a)} tensors, the last iteration's metrics; cuDNN "
                    f"deterministic)")
        figures["resume_bitwise"] = same
        del whole, resumed, a, b

        # the card against the CPU and float64: one leapfrog trajectory
        figures["card_vs_cpu"] = {
            "cnn_lstm": bnn_card_vs_cpu(torch, bnn_hmc, hmc, zoo, "CNN-LSTM", lstm,
                                        (torch.from_numpy(tokens[:BNN_CPU_EXAMPLES]).long(),
                                         torch.from_numpy(labels[:BNN_CPU_EXAMPLES]))),
            "wilson_resnet20": bnn_card_vs_cpu(torch, bnn_hmc, hmc, zoo, "WilsonResNet20", wilson_net,
                                               (batch[0][:BNN_CPU_EXAMPLES].cpu(), batch[1][:BNN_CPU_EXAMPLES].cpu())),
        }

        # the minibatch entries on LeNet-5 over synthetic MNIST
        x, y = mnist.load_mnist(True)
        check(x.shape == (8192, 28, 28, 1), f"synthetic MNIST: {x.shape}")
        steps = x.shape[0] // BNN_MINIBATCH["batch_size"]
        lenet = zoo.get_model("lenet", 10, generator=torch.Generator().manual_seed(0))
        minibatch = {}
        for name, run in (
            ("run_sgmcmc", lambda: bnn_hmc.run_sgmcmc(lenet, (x, y), step_size=1e-6, momentum_decay=0.9,
                                                      preconditioner="rmsprop", sample_interval=16,
                                                      log=_Print(), **BNN_MINIBATCH)),
            ("run_vi", lambda: bnn_hmc.run_vi(lenet, (x, y), lr=1e-3, log=_Print(), **BNN_MINIBATCH)),
            ("run_sgd", lambda: bnn_hmc.run_sgd(lenet, (x, y), lr=1e-2, log=_Print(), **BNN_MINIBATCH)),
        ):
            _zero(kernels)
            t = time.perf_counter()
            method, state = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = _no_launch(kernels, name)
            params, _ = method.sample(state, torch.Generator(device="cuda").manual_seed(1), 0)
            with torch.no_grad():
                xb = torch.from_numpy(x[:512]).permute(0, 3, 1, 2).cuda()
                out, _, _ = Model(state.params).apply(params, {}, None, xb, train=False)
                acc = float((out.argmax(-1).cpu() == torch.from_numpy(y[:512])).float().mean())
            check(state.step == steps and bool(torch.isfinite(out).all()),
                  f"{name} on LeNet-5: {state.step} steps of {BNN_MINIBATCH['batch_size']}, a posterior draw's "
                  f"logits finite, train accuracy {acc:.3f}, {wall:.2f} s [{CARD}]")
            minibatch[name] = {"steps": state.step, "wall_s": wall, "train_accuracy": acc, "counts": counts}
        figures["minibatch"] = minibatch

        # the Wilson baseline through pickles in the published layout
        _write_wilson(torch, os.environ["BDE_DATA_DIR"])
        _zero(kernels)
        on_card = wilson.WilsonHMC(device="cuda")
        check(on_card.n_samples == WILSON_FILES * WILSON_CHAINS, f"WilsonHMC: {on_card.n_samples} samples "
                                                                 f"({WILSON_FILES} files x {WILSON_CHAINS} chains)")
        x8 = test_images[0][:8]
        card_lp = on_card.infer(x8).cpu()
        cpu_lp = wilson.WilsonHMC(device="cpu").infer(x8)
        err = float((card_lp - cpu_lp).abs().max())
        check(err <= 1e-4, f"WilsonHMC log-probs on the card against the CPU on 8 images: max abs err {err:.3g} "
                           f"(bound 1e-4)")
        hmc_eval = cifar.eval_hmc({"test_subsample": WILSON_EVAL, "eval_batch_size": WILSON_EVAL})
        check(hmc_eval["hmc_agreement"] == 1.0 and hmc_eval["hmc_total_variation"] == 0.0
              and all(math.isfinite(v) for v in hmc_eval.values()),
              f"eval_hmc on {WILSON_EVAL} images: {json.dumps(hmc_eval)}")
        t = time.perf_counter()
        row = cifar.run_single({**cifar.DEFAULT_CONFIG, **YAML_DEFAULT, **WILSON_RUN}, log=print)["test"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _no_launch(kernels, "WilsonHMC, eval_hmc and the MAP run with use_hmc_baseline")
        check(0.0 <= row["hmc_agreement"] <= 1.0 and 0.0 <= row["hmc_total_variation"] <= 1.0
              and all(math.isfinite(v) for v in row.values()),
              f"CIFAR MAP run_single with use_hmc_baseline (1 epoch of 20 steps, 250 images): agreement "
              f"{row['hmc_agreement']:.4f}, total variation {row['hmc_total_variation']:.4f}, {wall:.1f} s [{CARD}]")
        figures["wilson"] = {"card_vs_cpu_max_abs_err": err, "eval_hmc": hmc_eval, "map_run_single": row,
                             "map_run_single_wall_s": wall, "counts": counts}
    finally:
        if before is None:
            os.environ.pop("BDE_DATA_DIR", None)
        else:
            os.environ["BDE_DATA_DIR"] = before
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    figures["phase_s"] = time.perf_counter() - t0
    print(f"bnn-hmc phase: {figures['phase_s']:.1f} s [{CARD}]")
    return figures


# The multi-device phase (phase 16), in the first process once the second
# has ended: (a) a world of one NCCL rank through torchrun on MESH_ROW; (b) a
# world of MESH_WORLD gloo ranks on the one card (``--mesh-rank``). NCCL
# refuses two ranks on one card, so the ranks of (b) talk over gloo, which
# stages card tensors through the host (``parallel/mesh.py``).
MESH_WORLD = 2
MESH_TIMEOUT_S = 300  # each spawned group's limit
MESH_K1_SHAPES = ((128, 16, 32, 32), True), ((128, 32, 16, 16), False), ((128, 10), True)
MESH_K3_SHAPE = K3_CIVIL_SHAPE
MESH_K3_P = 0.1
# a step's gradient (SGD's trace, Adam's first moment, after one update from
# the same state and batch) or HMC's point: max |ranks - one rank| over max
# |one rank|, and the loss's relative gap. The ranks sum a batch's rows in
# another order (each its rows, then the mean of the ranks' means): a few
# ulps of fp32 at the gradient's scale, far inside these
MESH_STEP_BOUND = 1e-4
MESH_LOSS_BOUND = 1e-5
# (a): the flagged row's metrics against the unflagged row's. The arithmetic
# is the same (a mean over one rank is a sum divided by one) but for cuDNN's
# backward algorithms, which sum in an order of their own: equal up to that
MESH_ROW_BOUND = {"rtol": 1e-3, "atol": 1e-5}
MESH_HMC = {"n_iterations": 1, "burn_in": 0, "n_leapfrog": 5, "step_size": 1e-4, "seed": 0}
MESH_HMC_EXAMPLES = 512


def mesh_steps(torch, kernels, distributed):
    """One update of each of the four main-path steps from a seeded state and
    batch, through ``ParallelTrainer`` on this rank's mesh when
    ``distributed`` (each rank its rows), else the method alone: the loss,
    the tensor the comparison reads (CPU) and the kernels' launches."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data import cifar as cifar_data
    from beyond_deep_ensembles_tpu_torch.experiments import bnn_hmc, cifar, wilds_task
    from beyond_deep_ensembles_tpu_torch.models import zoo
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.parallel import mesh
    from beyond_deep_ensembles_tpu_torch.parallel.pipelines import ParallelTrainer

    def run(built, n_members, batch, read):
        update = built.method.update
        if distributed:
            grid = mesh.make_mesh(member_parallel=mesh.member_axis_size(mesh.world_size(), n_members))
            trainer = ParallelTrainer(built.method, grid, n_members=n_members)
            built.state = trainer.place_state(built.state)
            update = trainer.update
        _zero(kernels)
        noise = NoiseSource(key=keys.as_key(keys.fold_in(0, 1), "cuda"))
        built.state, metrics = update(built.state, noise, batch)
        torch.cuda.synchronize()
        return {"loss": float(metrics["loss"]), "tensor": read(built.state).detach().cpu(),
                "launches": {k: fn.launches for k, fn in kernels.items()}}

    gen = torch.Generator().manual_seed(1)
    images = (torch.randn(128, 3, 32, 32, generator=gen).cuda(), torch.randint(0, 10, (128,), generator=gen).cuda())
    out = {}
    config = {**cifar.DEFAULT_CONFIG, **BBB_VARIANT, "dataset_size": 50_000}
    built = cifar.build(config, torch.Generator().manual_seed(0), 390)
    out["bbb"] = run(built, 1, images, lambda state: state.opt_state[0].trace)
    del built
    config = {**cifar.DEFAULT_CONFIG, **SVGD_VARIANT, "svgd_particles": MESH_WORLD, "dataset_size": 50_000}
    built = cifar.build(config, torch.Generator().manual_seed(0), 390)
    out["svgd"] = run(built, MESH_WORLD, images, lambda state: state.opt_state[0].trace)
    del built
    config = {**wilds_task.DEFAULT_CONFIG, **AMAZON_DEFAULT, **MCD_VARIANT, **BERT_SMOKE}
    x, y, _, _, _ = wilds_task._load_task_data("amazon", config)
    bs = config["batch_size"]
    built = wilds_task.build("amazon", config, torch.Generator().manual_seed(config["seed"]))
    reviews = (torch.from_numpy(x[:bs]).cuda(), torch.from_numpy(y[:bs]).cuda())
    out["mcd"] = run(built, 1, reviews, lambda state: state.opt_state[0].mu)
    del built
    torch.cuda.empty_cache()
    train = cifar_data.load_cifar10(True, subsample=MESH_HMC_EXAMPLES)
    test = cifar_data.load_cifar10(False, subsample=64)
    model = zoo.get_model("resnet20_frn_swish", 10, generator=torch.Generator().manual_seed(0))
    _zero(kernels)
    res = bnn_hmc.run_hmc(model, train, test, step_size_adaptation_speed=0.05, **MESH_HMC)
    torch.cuda.synchronize()
    m = res["metrics"][0]
    out["hmc"] = {"loss": m["log_likelihood"], "tensor": res["state"].flat.detach().cpu(), "accepted": m["accepted"],
                  "launches": {k: fn.launches for k, fn in kernels.items()}}
    return out


def mesh_offsets(torch, sampling, att, rank, world):
    """K1 (fp32 and bf16 planes, forward and backward, a device seed) at
    ResNet-20's layer shapes at batch 128, and K3a/K3b (fp32 and bf16,
    p = 0.1, a device seed) at CivilComments' train shape: this rank's rows
    launched at their offset against the same rows of the whole launch, bit
    for bit (the largest gap printed; a gap above 0 fails)."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.ops.sampling import DeviceSeed

    gaps = {}

    def gap(a, b):
        return float((a.detach().float() - b.detach().float()).abs().max()) if a.numel() else 0.0

    seed = DeviceSeed(keys.as_key(123456789, "cuda"), 3)
    for dtype in (torch.float32, torch.bfloat16):
        for shape, bias in MESH_K1_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(11)
            planes = [t.to(dtype) for t in layer_planes(torch, gen, shape, bias, -3.0)]
            n = shape[0] // world
            rows = slice(rank * n, (rank + 1) * n)
            whole = [t.clone().requires_grad_(True) for t in planes[:2]]
            g = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            out = sampling.gaussian_sample(*whole, *planes[2:], seed=seed)
            out.backward(g)
            part = [t[rows].clone().requires_grad_(True) for t in planes[:2]]
            got = sampling.gaussian_sample(*part, *planes[2:], seed=seed, rows=(rank * n, shape[0]))
            got.backward(g[rows])
            label = f"K1 {str(dtype)[6:]} {shape}"
            gaps[f"{label} forward"] = gap(got, out[rows])
            gaps[f"{label} backward"] = gap(part[1].grad, whole[1].grad[rows])
    b, h, l, d = MESH_K3_SHAPE
    n = b // world
    rows = slice(rank * n, (rank + 1) * n)
    k3_seed = DeviceSeed(keys.as_key(4242, "cuda"), 1 << 20)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, mask = k3_inputs(torch, MESH_K3_SHAPE, 5)
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = att.fused_dropout_attention(*whole, mask, dropout_p=MESH_K3_P, seed=k3_seed)
        out.backward(do)
        part = [t[rows].clone().requires_grad_(True) for t in (q, k, v)]
        got = att.fused_dropout_attention(*part, mask[rows], dropout_p=MESH_K3_P, seed=k3_seed, rows=(rank * n, b))
        got.backward(do[rows])
        label = f"K3 {str(dtype)[6:]} {MESH_K3_SHAPE}"
        gaps[f"{label} output"] = gap(got, out[rows])
        for name, gp, gw in zip(("dq", "dk", "dv"), part, whole):
            gaps[f"{label} {name}"] = gap(gp.grad, gw.grad[rows])
        with torch.no_grad():
            if dtype == torch.float32:  # the kept probabilities K3a writes
                _, probs = att.fused_dropout_attention_debug(*part, mask[rows], dropout_p=MESH_K3_P, seed=k3_seed,
                                                            rows=(rank * n, b))
                _, want = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=MESH_K3_P, seed=k3_seed)
                gaps[f"{label} kept probabilities"] = gap(probs, want[rows])
            else:  # the keep bits K3a leaves for K3b
                bias = att.key_bias(mask)
                drawn = att._forward(q, k, v, bias, MESH_K3_P, k3_seed, None, False, True)[3]
                mine = att._forward(q[rows], k[rows], v[rows], bias[rows], MESH_K3_P,
                                    att._shifted(k3_seed, rank * n * h), None, False, True)[3]
                gaps[f"{label} keep bits"] = float((drawn.view(b, -1)[rows] != mine.view(n, -1)).sum())
    return gaps


def mesh_rank(torch, rank, world, ref_path):
    """One rank of phase 16 b: the offsets, then the steps against the
    one-rank references."""
    from beyond_deep_ensembles_tpu_torch.ops import attention as att
    from beyond_deep_ensembles_tpu_torch.ops import sampling, svgd_kernel

    kernels = kernel_registry(sampling, svgd_kernel, att)
    t0 = time.perf_counter()
    offsets = mesh_offsets(torch, sampling, att, rank, world)
    t1 = time.perf_counter()
    steps = mesh_steps(torch, kernels, distributed=True)
    t2 = time.perf_counter()
    refs = torch.load(ref_path, weights_only=True)
    gaps = {}
    for name, got in steps.items():
        want = refs[name]
        scale = float(want["tensor"].abs().max())
        gaps[name] = {"gap": float((got["tensor"] - want["tensor"]).abs().max()) / scale,
                      "loss_gap": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                      "launches": got["launches"]}
        if name == "hmc":
            gaps[name]["accepted"] = [got["accepted"], want["accepted"]]
    return {"rank": rank, "world": world, "backend": torch.distributed.get_backend(), "offsets": offsets, "steps": gaps,
            "offsets_s": t1 - t0, "steps_s": t2 - t1}


def mesh_rank_main(rank, world, store, out, ref_path, card) -> int:
    """A rank of phase 16 b (this file with ``--mesh-rank``): joins the gloo
    group through the file store, runs ``mesh_rank`` on the card and writes
    its figures to ``<out>/rank<r>.json``."""
    global CARD
    import datetime

    CARD = card
    threading.Thread(target=_exit_with_parent, args=(os.getppid(),), daemon=True).start()
    torch = setup("mesh")
    if torch is None:
        return 1
    import torch.distributed as dist

    from beyond_deep_ensembles_tpu_torch.utils.device import resolve_device

    resolve_device("cuda:0")  # both ranks on the one card, fp32 math pinned
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S // 2))
    try:
        figures = mesh_rank(torch, int(rank), int(world), ref_path)
    finally:
        dist.destroy_process_group()
    path = os.path.join(out, f"rank{rank}.json")
    with open(f"{path}.tmp", "w") as f:
        json.dump(figures, f)
    os.replace(f"{path}.tmp", path)
    return 0


def _wait_group(procs, logs, label, timeout=MESH_TIMEOUT_S):
    """Waits for every process of a spawned group within ``timeout``; kills
    them all and raises, the logs printed, when one fails or time runs
    out."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for path in logs:
        with open(path) as f:
            text = f.read()
        print(f"-- {label}: {os.path.relpath(path, ROOT)}\n{text[-6000:]}", end="" if text.endswith("\n") else "\n")
    codes = [p.returncode for p in procs]
    check(all(c == 0 for c in codes), f"{label}: every process exited 0 within {timeout} s (exit codes {codes})")


def start_nccl_row(mesh_row, out):
    """Phase 16 a: MESH_ROW's row, cut as phase 11 ran it, through
    ``run.main`` under torchrun in a world of one NCCL rank, started in the
    background; returns the process and its log."""
    import yaml

    sweep = os.path.join(out, "row.yaml")
    with open(sweep, "w") as f:
        yaml.safe_dump_all([{"name": "DEFAULT", "repetitions": 1, "params": mesh_row["params"]},
                            {"name": MESH_ROW[1], "params": {}}], f)
    log = os.path.join(out, "nccl_row.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "beyond_deep_ensembles_tpu_torch.run", MESH_ROW[0], sweep, "--name", MESH_ROW[1],
           "--out", os.path.join(out, "nccl"), "--rep", "0"]
    print("phase 16 a: " + " ".join(os.path.relpath(c, ROOT) if c.startswith(ROOT) else c for c in cmd[1:]))
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, log


def mesh_phase(torch, kernels, mesh_row):
    """Phase 16: (a) in the background, the one-rank references, (b), then
    (a)'s result; every check's gap printed with the world, the backend and
    the card. Returns its figures."""
    import gc
    import shutil

    t0 = time.perf_counter()
    out = os.path.join(BUILD, "mesh")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    gc.collect()
    torch.cuda.empty_cache()
    nccl, nccl_log = start_nccl_row(mesh_row, out)
    t_a = time.perf_counter()

    # (b): the one-rank references, then the world of two
    refs = mesh_steps(torch, kernels, distributed=False)
    ref_path = os.path.join(out, "references.pt")
    torch.save(refs, ref_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    store = os.path.join(out, "store")
    procs, logs = [], []
    for r in range(MESH_WORLD):
        logs.append(os.path.join(out, f"rank{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__), "--mesh-rank", str(r), str(MESH_WORLD), store, out,
                 ref_path, CARD], stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
    _wait_group(procs, logs, f"phase 16 b, a world of {MESH_WORLD} gloo ranks on cuda:0")
    t_b = time.perf_counter()
    ranks = []
    for r in range(MESH_WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for fig in ranks:
        where = f"rank {fig['rank']} of {fig['world']}, {fig['backend']}"
        worst = max(fig["offsets"].values())
        check(worst == 0.0, f"{where}: K1 and K3 at the rank's row offset = the rows of the whole launch, bit for "
                            f"bit ({len(fig['offsets'])} checks, largest gap {worst}) [{CARD}]")
        for name, got in fig["steps"].items():
            check(got["gap"] <= MESH_STEP_BOUND and got["loss_gap"] <= MESH_LOSS_BOUND,
                  f"{where}: {name} step = the one-rank step (gap {got['gap']:.2e} <= {MESH_STEP_BOUND} of its "
                  f"largest element, loss {got['loss_gap']:.2e} <= {MESH_LOSS_BOUND})")
        hmc = fig["steps"]["hmc"]
        check(hmc["accepted"][0] == hmc["accepted"][1], f"{where}: HMC's accept decision = the one-rank chain's")
        print(f"{where}: offsets {fig['offsets_s']:.1f} s, steps {fig['steps_s']:.1f} s [{CARD}]")
    steps = ranks[0]["steps"]
    check(steps["bbb"]["launches"]["k1_gaussian_sample"] > 0 and steps["mcd"]["launches"]["k3a_attention_forward"] > 0
          and steps["mcd"]["launches"]["k3b_attention_backward"] > 0 and steps["svgd"]["launches"]["k2_svgd_gram"] == 1,
          f"the ranks' steps went through the kernels: {json.dumps({n: s['launches'] for n, s in steps.items()})}")

    # (a): the flagged row in a world of one NCCL rank against the unflagged
    _wait_group([nccl], [nccl_log], "phase 16 a, torchrun, a world of one NCCL rank")
    t_end = time.perf_counter()
    with open(os.path.join(out, "nccl", f"{MESH_ROW[1]}_0", "rep_0", "metrics.jsonl")) as f:
        got = {k: v for k, v in json.loads(f.read().splitlines()[-1]).items() if not k.startswith("_")}
    want = mesh_row["result"]
    floats = [k for k, v in want.items() if isinstance(v, float)]
    equal = got == want
    worst = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in floats)
    check(got.keys() == want.keys() and all(
        abs(got[k] - want[k]) <= MESH_ROW_BOUND["atol"] + MESH_ROW_BOUND["rtol"] * abs(want[k]) for k in floats)
        and all(got[k] == want[k] for k in want if k not in floats),
          f"{MESH_ROW[0]} {MESH_ROW[1]} flagged through torchrun (one NCCL rank, runners captured) = the unflagged "
          f"row of phase 11 (bit for bit: {equal}; largest relative gap {worst:.2e}, bound {MESH_ROW_BOUND})")
    seconds = {"phase_s": t_end - t0, "references_s": t_ref - t_a, "world_of_2_s": t_b - t_ref,
               "nccl_row_s": t_end - t_a, "unflagged_row_s": mesh_row["wall_s"]}
    print(f"multi-device phase: {seconds['phase_s']:.1f} s (references {seconds['references_s']:.1f} s, world of "
          f"{MESH_WORLD} {seconds['world_of_2_s']:.1f} s, the NCCL row {seconds['nccl_row_s']:.1f} s beside them; "
          f"the unflagged row took {mesh_row['wall_s']:.1f} s in phase 11) [{CARD}]")
    launches = {k: sum(fig["steps"][s]["launches"][k] for fig in ranks for s in fig["steps"]) for k in kernels}
    return {"world": MESH_WORLD, "backend": ranks[0]["backend"], "ranks": ranks, "references": {
        n: {"loss": r["loss"], "launches": r["launches"]} for n, r in refs.items()},
            "row": {"bit_for_bit": equal, "largest_rel_gap": worst, "flagged": got, "unflagged": want},
            "launches": launches, "seconds": seconds}


# phase 17: running-statistics BatchNorm (static_bn: false) on
# camelyon17's DenseNet-121 through the CLI, then the last models. The rows
# of configs/camelyon.yaml that carry K1 (BBB) and K2 (SVGD) and the state
# of every member and particle, at full width and the yaml's batch 32, cut
# to RUNNING_BN_STEPS steps and RUNNING_BN_TEST test images, one repetition
RUNNING_BN_ROWS = ["MAP", "MultiSWAG", "BBB", "SVGD", "Laplace"]
RUNNING_BN_STEPS = 4
RUNNING_BN_TEST = 32
# DenseNet-121's norms: the stem's, two in each of the 58 dense layers, three
# transitions' and the last
DENSENET121_NORMS = 1 + 2 * 58 + 3 + 1
PRERESNET_BATCH = 128
# MidasTiramisu at its default width: a timed forward at TIRAMISU_SIZE, and
# card against CPU at TIRAMISU_CPU_SIZE (both multiples of 16)
TIRAMISU_FEATURES, TIRAMISU_BATCH, TIRAMISU_SIZE, TIRAMISU_CPU_SIZE = 256, 2, 384, 32


def running_bn_sweep_file(task, path):
    """configs/camelyon.yaml's RUNNING_BN_ROWS with ``static_bn: false``, cut
    to RUNNING_BN_STEPS steps of the yaml's batch and RUNNING_BN_TEST test
    images, one repetition, SWAG collecting from the first step; written to
    ``path``. Returns {row: its params, DEFAULT's merged under}."""
    import yaml

    docs = wilds_yaml_docs(task)
    default = docs[0]
    batch = default["params"]["batch_size"]
    cut = {"epochs": 1, "subsample": RUNNING_BN_STEPS * batch, "test_subsample": RUNNING_BN_TEST, "static_bn": False}
    swag = {"swag_start_epoch": 0, "swag_updates": RUNNING_BN_STEPS}
    print(f"{task} running statistics: rows {RUNNING_BN_ROWS}, static_bn true -> false, epochs "
          f"{default['params']['epochs']} -> 1, subsample -> {cut['subsample']} ({RUNNING_BN_STEPS} steps of {batch}), "
          f"test_subsample -> {RUNNING_BN_TEST}, repetitions {default['repetitions']} -> 1; SWAG {swag}")
    out = [{**default, "repetitions": 1, "params": {**default["params"], **cut}}]
    for doc in docs[1:]:
        if doc["name"] in RUNNING_BN_ROWS:
            params = dict(doc["params"])
            if params["model"] == "swag":
                params.update(swag)
            out.append({**doc, "params": params})
    with open(path, "w") as f:
        yaml.safe_dump_all(out, f)
    return {d["name"]: {**out[0]["params"], **d["params"]} for d in out[1:]}


def running_stats_steps(torch, wilds_task):
    """camelyon17 MAP and BBB with ``static_bn: false`` at full width: every
    one of DenseNet-121's 121 norms holds its running ``mean`` and ``var``,
    which the update writes (``written_tensors``); COMPARE_STEPS captured
    steps = as many eager ones, bit for bit, the statistics among the
    tensors compared (``captured_vs_eager``), and the statistics moved."""
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    out = {}
    for row in ("MAP", "BBB"):
        built, config, batches = wilds_built(torch, wilds_task, "camelyon17", row, static_bn=False)
        buffers = [b for _, b in built.state.params.named_buffers()]
        written = {t.data_ptr() for t in multistep._written_tensors(built.state)}
        check(len(buffers) == 2 * DENSENET121_NORMS and all(b.data_ptr() in written for b in buffers),
              f"camelyon17 {row} static_bn false: {len(buffers)} running-statistics buffers (mean and var of "
              f"{DENSENET121_NORMS} norms), every one among the tensors the update writes")
        before = [b.clone() for b in buffers]
        bitwise = captured_vs_eager(torch, built, batches, f"camelyon17 {row} static_bn false (running statistics)")
        moved = sum(not torch.equal(a, b) for a, b in zip(before, buffers))
        check(moved == len(buffers), f"camelyon17 {row}: {moved} of {len(buffers)} running statistics stepped")
        out[row] = {"bitwise": bitwise, "buffers": len(buffers)}
        del built, batches
        torch.cuda.empty_cache()
    return out


def remat_against_none(torch, built, batch, modes, set_mode, label):
    """One eager update from one state and key under each remat mode of
    ``modes`` and under ``none`` (``set_mode(mode)``), on deterministic
    cuDNN: every tensor the update writes (running statistics included)
    within 1e-5 of ``none``'s, relative to each tensor's largest entry, the
    loss equal; the peak device memory of each."""
    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    torch.backends.cudnn.deterministic = True
    written = multistep._written_tensors(built.state)
    with torch.no_grad():
        saved = [t.clone() for t in written]
    step, runs = built.state.step, {}
    for mode in ("none",) + tuple(modes):
        with torch.no_grad():
            for t, v in zip(written, saved):
                t.copy_(v)
        built.state.step = step
        set_mode(mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        built.state, metrics = built.method.update(built.state, NoiseSource(key=keys.as_key(11, "cuda")), batch)
        torch.cuda.synchronize()
        runs[mode] = {"tensors": [t.clone() for t in written], "loss": float(metrics["loss"]),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": time.perf_counter() - t0}
    torch.backends.cudnn.deterministic = False
    set_mode("none")
    ref, figures = runs["none"], {"none": {"peak_gib": runs["none"]["peak_gib"]}}
    for mode in modes:
        got = runs[mode]
        err = max(float((a.double() - b.double()).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(got["tensors"], ref["tensors"]) if b.numel())
        bitwise = all(torch.equal(a, b) for a, b in zip(got["tensors"], ref["tensors"]))
        check(err <= 1e-5 and got["loss"] == ref["loss"] and math.isfinite(got["loss"]),
              f"{label}: one update under remat {mode} = under none ({len(written)} written tensors, max rel err "
              f"{err:.3g} <= 1e-5, bit for bit: {bitwise}; loss {got['loss']:.6g} equal)")
        figures[mode] = {"max_rel_err": err, "bitwise": bitwise, "peak_gib": got["peak_gib"]}
        print(f"{label} remat {mode}: peak {got['peak_gib']:.2f} GiB against none's {ref['peak_gib']:.2f} GiB [{CARD}]")
    for run in runs.values():
        del run["tensors"]
    return figures


def last_models_steps(torch, kernels, sampling, NoiseSource):
    """A full-width PreResNet-20 BBB step (CIFAR, batch 128) and the same
    net with every BBB layer on ``sampling="parameters"``: K1's host counts
    exact (22 launches a forward and as many backward; a parameter draw per
    kernel and bias), the loss finite, and K1 held against its plain twin at
    each step's planes (``k1_hold``)."""
    import torch.nn.functional as F

    from beyond_deep_ensembles_tpu_torch import keys
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10
    from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior, LossOutput
    from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
    from beyond_deep_ensembles_tpu_torch.models.resnet import PreResNet20
    from beyond_deep_ensembles_tpu_torch.nn.base import Model
    from beyond_deep_ensembles_tpu_torch.nn.bbb import BBBConv, BBBDense
    from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

    x, y = load_cifar10(True, subsample=PRERESNET_BATCH)
    batch = (torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous(), torch.from_numpy(y).cuda())
    figures = {}
    for sampling_mode in ("activations", "parameters"):
        net = PreResNet20(10, conv_kind="bbb", generator=torch.Generator().manual_seed(0)).cuda()
        layers = [m for m in net.modules() if isinstance(m, (BBBConv, BBBDense))]
        for m in layers:
            m.sampling = sampling_mode
        model = Model(net)

        def loss_fn(params, model_state, noise, b, model=model):
            out, kl, new_state = model.apply(params, model_state, noise, b[0], train=True)
            return LossOutput(loss=F.cross_entropy(out, b[1]), kl=kl, model_state=new_state)

        method = bbb_method(loss_fn, lambda ps: (SGD(ps, lr=0.05, momentum=0.9), None), GaussianPrior(0.0, 1.0),
                            dataset_size=50_000)
        state = method.init(net, {})
        per_forward = len(layers) if sampling_mode == "activations" else sum(1 + m.use_bias for m in layers)
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = method.update(state, NoiseSource(key=keys.as_key(21, "cuda")), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}
        want = {name: 0 for name in kernels}
        want.update(k1_gaussian_sample=per_forward, k1_gaussian_sample_backward=per_forward)
        label = f"PreResNet-20 BBB, sampling={sampling_mode}"
        check(counts == want and math.isfinite(float(metrics["loss"])),
              f"{label}: one update at batch {PRERESNET_BATCH}: launch counts {counts} = {want} ({len(layers)} BBB "
              f"layers), loss {float(metrics['loss']):.5g} finite, {wall:.2f} s [{CARD}]")
        planes = []
        with torch.no_grad():
            model.apply(net, {}, recording_source(NoiseSource, planes)(key=keys.as_key(22, "cuda")), batch[0],
                        train=True)
        figures[sampling_mode] = {"counts": counts, "wall_s": wall, "loss": float(metrics["loss"]),
                                  **k1_hold(torch, sampling, planes, f"{label}'s planes")}
        del net, state, method, model
        torch.cuda.empty_cache()
    return figures


def tiramisu_check(torch):
    """MidasTiramisu at ``features=256``: the card's depth map against the
    CPU's on the same weights at TIRAMISU_CPU_SIZE (1e-4 of its largest
    value, TF32 off), then a forward at TIRAMISU_BATCH x TIRAMISU_SIZE^2
    timed alone (``alone_section``), finite and of the expected shape."""
    from beyond_deep_ensembles_tpu_torch.models.tiramisu import MidasTiramisu
    from beyond_deep_ensembles_tpu_torch.utils.device import resolve_device

    resolve_device(None)  # TF32 off, as every entry point sets it
    net = MidasTiramisu(features=TIRAMISU_FEATURES, generator=torch.Generator().manual_seed(0))
    small = torch.randn(1, 3, TIRAMISU_CPU_SIZE, TIRAMISU_CPU_SIZE, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(small)
        net = net.cuda()
        got = net(small.cuda()).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(got.shape == (1, 1, TIRAMISU_CPU_SIZE, TIRAMISU_CPU_SIZE) and err <= 1e-4 * max(scale, 1e-30) and scale > 0,
          f"MidasTiramisu(features={TIRAMISU_FEATURES}): card = CPU at 1x3x{TIRAMISU_CPU_SIZE}x{TIRAMISU_CPU_SIZE} "
          f"(max abs err {err:.3g} <= 1e-4 of the largest depth {scale:.3g})")
    x = torch.randn(TIRAMISU_BATCH, 3, TIRAMISU_SIZE, TIRAMISU_SIZE, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad(), alone_section():
        net(x)
        start.record()
        out = net(x)
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end)
    check(out.shape == (TIRAMISU_BATCH, 1, TIRAMISU_SIZE, TIRAMISU_SIZE) and bool(torch.isfinite(out).all()),
          f"MidasTiramisu forward at {TIRAMISU_BATCH}x3x{TIRAMISU_SIZE}x{TIRAMISU_SIZE}: finite depth maps "
          f"{tuple(out.shape)}, {ms:.2f} ms (CUDA events, warm, the other process stopped) [{CARD}]")
    return {"max_abs_err": err, "largest": scale, "forward_ms": ms}


def running_bn_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource):
    """Phase 17: camelyon17's MAP, MultiSWAG, BBB, SVGD and Laplace rows with
    running-statistics BatchNorm through ``run.main`` at DenseNet-121's full
    width (exact launch counts: K1 121 a BBB forward, K2 once an SVGD step),
    K1 and K2 held against their plain twins at those shapes (their times
    there are phase 11's: the same planes and the same P), captured steps
    against eager ones with the statistics among the tensors compared, a
    remat step against a plain one (the statistics stepped once); one
    iwildcam ResNet-50 MAP step under ``conv_remat`` ``block`` and
    ``stage`` against ``none``; the last models' steps (PreResNet-20 BBB,
    parameter sampling) and MidasTiramisu. Prints each part's wall time."""
    import gc
    import shutil

    from beyond_deep_ensembles_tpu_torch.data.wilds import TASKS
    from beyond_deep_ensembles_tpu_torch.models.densenet import DenseNetClassifier

    figures, t_phase = {}, time.perf_counter()

    def part(name, fn):
        t0 = time.perf_counter()
        figures[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 17 {name}: {time.perf_counter() - t0:.1f} s [{CARD}]")

    out = os.path.join(BUILD, "running_bn_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    part("rows", lambda: image_cli_rows(torch, "camelyon17", kernels, out, RUNNING_BN_ROWS,
                                        sweep_file=running_bn_sweep_file, steps=RUNNING_BN_STEPS,
                                        second_map=False)[2])
    shutil.rmtree(out, ignore_errors=True)
    figures["counts"] = {name: sum(row["counts"][name] for row in figures["rows"].values()) for name in kernels}
    part("steps", lambda: running_stats_steps(torch, wilds_task))

    def densenet_remat():
        built, _, batches = wilds_built(torch, wilds_task, "camelyon17", "MAP", n_batches=1, static_bn=False)
        net = built.state.params.DenseNet_0
        return remat_against_none(torch, built, batches[0], ("layer", "block"), lambda m: setattr(net, "remat", m),
                                  "camelyon17 MAP static_bn false (DenseNet-121)")

    part("densenet_remat", densenet_remat)

    def resnet_remat():
        built, _, batches = wilds_built(torch, wilds_task, "iwildcam", "MAP", n_batches=1)
        net = built.state.params
        return remat_against_none(torch, built, batches[0], ("block", "stage"), lambda m: setattr(net, "remat", m),
                                  "iwildcam MAP (ResNet-50, batch 16, 448x448)")

    part("resnet_remat", resnet_remat)
    part("k1", lambda: image_k1_held(torch, sampling, wilds_task, NoiseSource, extra={"static_bn": False},
                                     what="camelyon17 BBB static_bn false")[2])

    def k2():
        net = DenseNetClassifier(TASKS["camelyon17"].classes, track_running_stats=True, generator=torch.Generator())
        p = sum(q.numel() for q in net.parameters())
        stats = sum(b.numel() for b in net.buffers())
        check(p == K2_IMAGE_SHAPES["camelyon17"][1] and stats > 0,
              f"camelyon17 SVGD with running statistics: K2's P is the {p} parameters of a particle, none of its "
              f"{stats} running-statistics elements")
        n = K2_IMAGE_SHAPES["camelyon17"][0]
        gen = torch.Generator(device="cuda").manual_seed(9)
        x = torch.randn(n, p, device="cuda", generator=gen) + torch.randn(1, p, device="cuda", generator=gen)
        torch.backends.cuda.matmul.allow_tf32 = False
        err, share = k2_check(torch, svgd_kernel, x)
        return {"shape": [n, p], "running_stats_elements": stats, "max_abs_err": err, "bound_share": share}

    part("k2", k2)
    part("last_models", lambda: last_models_steps(torch, kernels, sampling, NoiseSource))
    part("tiramisu", lambda: tiramisu_check(torch))
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s [{CARD}]")
    return figures


def kernel_registry(sampling, svgd_kernel, att):
    """Every kernel wrapper of the port by the name its figures carry; each
    counts its own launches (``.launches``)."""
    return {
        "k1_gaussian_sample": sampling.gaussian_sample, "k1_gaussian_sample_backward": sampling.gaussian_sample_backward,
        "k2_svgd_gram": svgd_kernel.gram,
        "k3a_attention_forward": att.attention_forward, "k3b_attention_backward": att.attention_backward,
    }


def second_phases(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource):
    """Phases 15, 9, 11-14 and 17, in the second process: their figures by
    phase."""
    phase("bnn-hmc: HMC on the CNN-LSTM and WilsonResNet20, SG-MCMC, MFVI and SGD on LeNet-5, the Wilson baseline")
    bnn = bnn_hmc_phase(torch, kernels)
    print(json.dumps({"card": CARD, "bnn_hmc": bnn}))

    phase("UCI regression: configs/uci.yaml through the CLI")
    uci = uci_phase(torch, kernels)
    print(json.dumps({"card": CARD, "uci": uci}))

    phase("WILDS image tasks: configs/camelyon.yaml and configs/fmow.yaml through the CLI")
    image = image_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource)
    print(json.dumps({"card": CARD, "image": image}))
    image_counts = {name: sum(row["counts"][name] for rows in image["rows"].values() for row in rows.values())
                    for name in kernels}
    check(image_counts["k3a_attention_forward"] == image_counts["k3b_attention_backward"] == 0,
          "K3 never launched on the image rows")

    phase("WILDS ResNet-50 tasks: configs/iwildcam.yaml and configs/rxrx1.yaml through the CLI")
    resnet = resnet_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource)
    print(json.dumps({"card": CARD, "resnet": resnet}))
    resnet_counts = {name: sum(row["counts"][name] for rows in resnet["rows"].values() for row in rows.values())
                     for name in kernels}
    check(resnet_counts["k3a_attention_forward"] == resnet_counts["k3b_attention_backward"] == 0
          and resnet_counts["k1_gaussian_sample"] == resnet_counts["k1_gaussian_sample_backward"] == 0,
          "K1 and K3 never launched on the ResNet-50 rows (no row is BBB)")

    phase("WILDS poverty: configs/poverty.yaml through the CLI")
    poverty = poverty_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource)
    print(json.dumps({"card": CARD, "poverty": poverty}))
    poverty_counts = {name: sum(row["counts"][name] for row in poverty["rows"].values()) for name in kernels}
    check(poverty_counts["k3a_attention_forward"] == poverty_counts["k3b_attention_backward"] == 0,
          "K3 never launched on the poverty rows")

    phase("Staged weights and DistilBERT remat")
    staged = {"remat": bert_remat_check(torch, wilds_task, NoiseSource, kernels),
              "weights": staged_weights_check(torch, wilds_task)}
    print(json.dumps({"card": CARD, "staged": staged}))

    phase("Running-statistics BatchNorm (static_bn: false) on camelyon17 through the CLI; ResNet-50 remat; "
          "PreResNet-20, parameter sampling, MidasTiramisu")
    running_bn = running_bn_phase(torch, kernels, sampling, svgd_kernel, wilds_task, NoiseSource)
    print(json.dumps({"card": CARD, "running_bn": running_bn}))
    running_counts = running_bn["counts"]
    check(running_counts["k3a_attention_forward"] == running_counts["k3b_attention_backward"] == 0
          and running_counts["k1_gaussian_sample"] > 0 and running_counts["k2_svgd_gram"] > 0,
          "phase 17's rows launched K1 (BBB) and K2 (SVGD), never K3")
    return {"bnn_hmc": bnn, "uci": uci, "image": image, "resnet": resnet, "poverty": poverty, "staged": staged,
            "running_bn": running_bn,
            "counts": {"image": image_counts, "resnet": resnet_counts, "poverty": poverty_counts,
                       "running_bn": running_counts}}


def start_second():
    """Start the second process (this file with ``--second``), its output
    into its log; it reads the card's name and the start time from its
    arguments, so that its phase headings count from this script's start."""
    log_path, json_path = second_paths()
    for path in (log_path, json_path):
        if os.path.exists(path):
            os.remove(path)
    with open(log_path, "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--second", CARD, repr(time.time() - (time.perf_counter() - T_START))],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        )
    PEER["child"], PEER["pid"] = child, child.pid
    print(f"second process {child.pid} started: {SECOND_PHASES}, its output in {os.path.relpath(log_path, ROOT)}")


def finish_second():
    """Wait for the second process, print its output, and return its
    figures; raises if it failed."""
    child = PEER["child"]
    rc = child.wait()
    log_path, json_path = second_paths()
    with open(log_path) as f:
        out = f.read()
    print(f"== the second process's output ({SECOND_PHASES}), exit code {rc}")
    print(out, end="" if out.endswith("\n") else "\n")
    PEER["pid"] = PEER["child"] = None
    if rc != 0:
        print(out[-20000:], file=sys.stderr)
        raise RuntimeError(f"the second process ({SECOND_PHASES}) exited with {rc}")
    with open(json_path) as f:
        return json.load(f)


def stop_second():
    """Stop the second process if it still runs (after a failure here)."""
    child = PEER["child"]
    if child is not None and child.poll() is None:
        _signal_peer(signal.SIGCONT)
        child.kill()
        child.wait()


def _exit_with_parent(parent):
    """A process of this script ends, with every process of its group, when
    the one that started it is gone."""
    while True:
        time.sleep(2)
        if os.getppid() != parent:
            try:
                os.killpg(os.getpgrp(), signal.SIGKILL)
            finally:
                os._exit(3)


def _t_start(t0_epoch):
    """``time.perf_counter()``'s reading at the wall-clock time ``t0_epoch``."""
    return time.perf_counter() - (time.time() - float(t0_epoch))


def _hangup(signum, frame):
    """SIGHUP noted and survived (see ``supervise``)."""
    print(f"chip_smoke: process {os.getpid()} received SIGHUP at {time.perf_counter() - T_START:.1f} s; going on",
          file=sys.stderr, flush=True)


def setup(which):
    """torch on the card with this script's settings for the ``which``
    process, or None without CUDA."""
    signal.signal(signal.SIGHUP, _hangup)  # see supervise
    os.makedirs(BUILD, exist_ok=True)
    # keep Triton's cache and CUDA's JIT cache inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton_cache")
    os.environ["TRITON_HOME"] = os.path.join(BUILD, "triton_home")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return None
    sys.path.insert(0, ROOT)
    torch.set_num_threads(CPU_THREADS)
    torch.cuda.set_per_process_memory_fraction(MEMORY_FRACTION[which], 0)
    PEER["lock"] = open(os.path.join(BUILD, "chip_smoke_timing.lock"), "a+")
    return torch


def second_main(card, t0_epoch) -> int:
    """The second process: phases 15, 9 and 11-14, their figures into its JSON
    file."""
    global CARD, T_START
    CARD, T_START = card, _t_start(t0_epoch)
    PEER["pid"] = os.getppid()
    threading.Thread(target=_exit_with_parent, args=(PEER["pid"],), daemon=True).start()
    torch = setup("second")
    if torch is None:
        return 1
    from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import sampling, svgd_kernel
    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    figures = second_phases(torch, kernel_registry(sampling, svgd_kernel, att), sampling, svgd_kernel, wilds_task,
                            NoiseSource)
    json_path = second_paths()[1]
    with open(f"{json_path}.tmp", "w") as f:
        json.dump(figures, f)
    os.replace(f"{json_path}.tmp", json_path)
    print(f"second process: done at {time.perf_counter() - T_START:.1f} s")
    return 0


def first_process(t0_epoch) -> int:
    """The first process: everything but SECOND_PHASES, and the result."""
    global T_START
    T_START = _t_start(t0_epoch)
    threading.Thread(target=_exit_with_parent, args=(os.getppid(),), daemon=True).start()
    torch = setup("first")
    if torch is None:
        return 1
    try:
        return first_main(torch, T_START)
    finally:
        stop_second()


def supervise() -> int:
    """This script as run: the first process in a process group of its own
    (the second joins it) in this one's session, waited for; both ended
    with the group on SIGTERM or SIGINT, and whatever is left of the group
    ended at the end. Only the two processes below are ever stopped
    (``alone``), never this one, which its caller waits for. Both note a
    SIGHUP and go on: a group with a stopped member that loses its last
    parent outside it in its session is sent SIGHUP by the kernel, and one
    run lost the first process to a SIGHUP whose sender it could not
    name."""
    first = subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), "--first", repr(time.time())],
                             cwd=ROOT, process_group=0)

    def end_group(signum, frame):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(first.pid, signal.SIGKILL)
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, end_group)
    signal.signal(signal.SIGINT, end_group)
    signal.signal(signal.SIGHUP, _hangup)
    rc = first.wait()
    with contextlib.suppress(ProcessLookupError):
        os.killpg(first.pid, signal.SIGKILL)
    if rc < 0:
        print(f"chip_smoke: the first process was ended by signal {-rc}", file=sys.stderr)
        return 128 - rc
    return rc


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "beyond_deep_ensembles_tpu_torch")):
        print("chip_smoke: the beyond_deep_ensembles_tpu_torch package is not beside this file", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--second"]:
        return second_main(*sys.argv[2:4])
    if sys.argv[1:2] == ["--first"]:
        return first_process(sys.argv[2])
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_main(*sys.argv[2:8])
    return supervise()


def first_main(torch, t_start) -> int:
    """The first process: the kernels, then phases 6-8 and 10 beside the
    second process, then the figures and the result."""
    global CARD
    from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task
    from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import _cuda_build, sampling, svgd_kernel
    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    CARD = smi
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} card(s): {name}")

    phase("build")
    build_phase(torch, _cuda_build)
    # the second process starts as soon as the CUDA C++ kernels are built:
    # the timings of phases 3-5 are timed sections, which stop it while
    # they run, and its first phase launches none of the port's kernels
    start_second()
    phase("K1")
    k1 = kernel_phase(torch, sampling)
    phase("K2")
    k2 = k2_phase(torch, svgd_kernel)
    phase("K3a, K3b")
    k3 = k3_phase(torch, att)
    kernels = kernel_registry(sampling, svgd_kernel, att)
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
            steady_steps(torch, step, label, config["batch_size"], count=TRAIN_STEPS)
            profile_steps(torch, step, ours=("attn_forward", "attn_backward"))
        del built, step
        torch.cuda.empty_cache()
    bert_card_vs_cpu(torch, wilds_task, NoiseSource)

    phase("WILDS text tasks: configs/amazon.yaml and configs/civilcomments.yaml through the CLI")
    wilds = wilds_phase(torch, kernels, att, sampling, svgd_kernel, wilds_task, NoiseSource)
    print(json.dumps({"card": CARD, "wilds": wilds}))
    wilds_counts = {name: sum(row["counts"][name] for rows in wilds["rows"].values() for row in rows.values())
                    for name in kernels}

    phase("bf16 compute: K1 and K3 on bf16, a row per backbone through the CLI, runners, card against CPU")
    bf16 = bf16_phase(torch, kernels, att, sampling, wilds_task, cifar, NoiseSource)
    print(json.dumps({"card": CARD, "bf16": bf16}))
    bf16_counts = {name: sum(row["counts"][name] for row in bf16["rows"].values()) for name in kernels}
    bf16_k1_counts = {name: sum(row["bf16_counts"][name] for row in bf16["rows"].values())
                      for name in ("k1_gaussian_sample", "k1_gaussian_sample_backward")}
    check(all(bf16_k1_counts.values()), f"K1's bf16 kernels launched on the bf16 rows' path: {bf16_k1_counts}")

    second = finish_second()
    uci, image, resnet, poverty, staged, running_bn = (
        second[key] for key in ("uci", "image", "resnet", "poverty", "staged", "running_bn"))
    image_counts, resnet_counts, poverty_counts, running_counts = (
        second["counts"][key] for key in ("image", "resnet", "poverty", "running_bn"))

    phase(f"Multi-device: {MESH_ROW[0]} {MESH_ROW[1]} under torchrun (one NCCL rank); K1, K3 and four steps in a "
          f"world of {MESH_WORLD} gloo ranks")
    mesh = mesh_phase(torch, kernels, image["mesh_row"])
    print(json.dumps({"card": CARD, "mesh": {k: v for k, v in mesh.items() if k != "ranks"}}))

    fp32_steps = {"amazon MAP fp32": wilds["steps"]["MAP"], "iwildcam MAP fp32": resnet["steps"]["iwildcam MAP"],
                  "CIFAR BBB fp32": bf16["steps"]["CIFAR BBB fp32"]}
    for label, fp32 in fp32_steps.items():
        half = bf16["steps"][label.replace("fp32", "bf16")]
        print(f"{label[:-5]} captured step: bf16 {half['captured_ms']:.2f} ms against fp32 {fp32['captured_ms']:.2f} ms "
              f"({fp32['captured_ms'] / half['captured_ms']:.2f} x) [{CARD}]")
    print(json.dumps({"card": CARD, "bf16_steps": {**fp32_steps, **bf16["steps"]}}))
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
            # the multi-device phase: launches of its ranks' four steps (the
            # BBB step's at each rank's row offset, forward and backward)
            "mesh_launches": mesh["launches"]["k1_gaussian_sample"],
            "mesh_backward_launches": mesh["launches"]["k1_gaussian_sample_backward"],
            # the runner phase: host counts (warm-ups and captures) and, from
            # a profile, K1 launches per replayed BBB step (forward and backward)
            "runner_launches": runners["BBB"]["host_counts"]["k1_gaussian_sample"],
            "replay_launches_per_step": runners["BBB"]["profiles"]["captured"]["launches"]["_flat_kernel"],
            # MultiBBB (5 members): host counts of its run_single, and K1
            # launches per replayed step from a profile (forward and backward)
            "multibbb_run_single_launches": multix["runs"]["MultiBBB"]["host_counts"]["k1_gaussian_sample"],
            "multibbb_replay_launches_per_step":
                multix["MultiBBB"]["profiles"]["captured"]["launches"]["_flat_kernel"],
            # the UCI phase: the CLI's nine energy runs (bbb and bbb_fixed_kl),
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
            # the image phase: host counts over both image yamls' rows
            # through run.main (camelyon17 BBB: 121 a forward, 121 backward a
            # step, 121 a forward of the eval runner's warm-ups and capture;
            # fmow BBB: 1), and one camelyon17 BBB train forward's 121
            # launches (batch 32, 96x96) against the plain version and the
            # byte bound, forward and backward
            "image_launches": image_counts["k1_gaussian_sample"],
            "image_backward_launches": image_counts["k1_gaussian_sample_backward"],
            "image_forward": image["k1"],
            # the ResNet-50 phase: no yaml row is BBB (0 launches over both
            # yamls' rows); one iwildcam train forward with every layer
            # variational (all_layers_bbb: 53 convs and the head, batch 16,
            # 448x448) against the plain version and the byte bound
            "resnet_launches": resnet_counts["k1_gaussian_sample"],
            "resnet_forward": resnet["k1"],
            # the poverty phase: host counts over the yaml's rows through
            # run.main (BBB, every layer variational: 21 a forward, 21
            # backward a step, 21 a forward of the eval runner's warm-up and
            # capture), and one BBB train forward's 21 launches (batch 64,
            # 224x224x8) against the plain version and the byte bound
            "poverty_launches": poverty_counts["k1_gaussian_sample"],
            "poverty_backward_launches": poverty_counts["k1_gaussian_sample_backward"],
            "poverty_forward": poverty["k1"],
            # the bf16 phase: host counts over its rows through run.main
            # (camelyon17, poverty and CIFAR BBB at compute_dtype bf16), of
            # which the bf16 planes' go through k1_gaussian_sample_bf16 below
            # and the fp32 heads' through this kernel
            "bf16": {"launches": bf16_counts["k1_gaussian_sample"],
                     "backward_launches": bf16_counts["k1_gaussian_sample_backward"]},
            # phase 17: host counts over camelyon17's static_bn false rows
            # through run.main (BBB: 121 a forward, 121 backward a step, 121
            # a forward of the eval runner's warm-up and capture), one BBB
            # train forward's 121 planes there against the plain version and
            # the byte bound, and the PreResNet-20 BBB and parameter-sampling
            # updates (launches and their planes held against the plain twin)
            "running_bn": {"launches": running_counts["k1_gaussian_sample"],
                           "backward_launches": running_counts["k1_gaussian_sample_backward"],
                           "forward": running_bn["k1"], "preresnet20": running_bn["last_models"]["activations"],
                           "parameter_sampling": running_bn["last_models"]["parameters"]},
        },
        {
            # K1 on bf16 planes: the same wrapper (gaussian_sample, its
            # backward) launching the CUDA kernels; launches are the bf16
            # phase's rows through run.main (their bf16 planes, not the fp32
            # heads), the figures one CIFAR BBB ResNet-20 train forward at
            # bf16: 21 bf16 planes and the fp32 head, batch 128
            "name": "k1_gaussian_sample_bf16",
            "route": "cuda",
            "source": "beyond_deep_ensembles_tpu_torch/csrc/gaussian_sample_bf16.cu",
            "replaces": "beyond_deep_ensembles_tpu/ops/sampling.py:46",
            "launches": bf16_k1_counts["k1_gaussian_sample"],
            "max_abs_err": bf16["k1"]["cifar"]["max_abs_err"],
            "ms": bf16["k1"]["cifar"]["kernel_ms"],
            "plain_ms": bf16["k1"]["cifar"]["plain_ms"],
            "bound_ms": bf16["k1"]["cifar"]["bound_ms"],
            "bound_by": bf16["k1"]["cifar"]["bound_by"],
            "library_ms": None,
            "backward_launches": bf16_k1_counts["k1_gaussian_sample_backward"],
            # every figure of the phase: SASS counts before and after, the
            # draw's checks, poverty's, camelyon17's and CIFAR's planes (with
            # the Triton kernel on the same planes, in turns, and CIFAR's
            # frozen eval at batch 500)
            **bf16["k1"],
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
            # the multi-device phase: its ranks' SVGD step, K2 on the
            # particles gathered over the member axis
            "mesh_launches": mesh["launches"]["k2_svgd_gram"],
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
            # the image phase: camelyon17's and fmow's SVGD rows (3 and 5
            # particles of DenseNet-121, once a step) and K2 at their shapes
            # beside torch.mm
            "image_launches": image_counts["k2_svgd_gram"],
            "image_shapes": image["k2"],
            # the ResNet-50 phase: iwildcam's LL_SVGD (5 head particles of
            # Dense_0, once a step) and K2 at its shape beside torch.mm
            "resnet_launches": resnet_counts["k2_svgd_gram"],
            "resnet_shapes": resnet["k2"],
            # the poverty phase: its SVGD row (5 particles of PovertyNet, once
            # a step) and K2 at its shape beside torch.mm
            "poverty_launches": poverty_counts["k2_svgd_gram"],
            "poverty_shapes": poverty["k2"],
            # phase 17: camelyon17's SVGD row with running statistics (3
            # particles, once a step; each particle's statistics its own,
            # outside K2's P) and K2 at its shape beside torch.mm
            "running_bn_launches": running_counts["k2_svgd_gram"],
            "running_bn_shapes": running_bn["k2"],
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
                # the multi-device phase: its ranks' MCD step at their row
                # offset
                "mesh_launches": mesh["launches"][name],
                "civilcomments_shape": wilds["k3_civil"][key],
                "key_mode_ms": wilds["k3_key_mode"]["forward_ms" if key == "K3a" else "backward_ms"],
                # the remat check: launches in one amazon MAP update without
                # and with bert_remat (the recompute runs K3a again)
                "remat_launches": staged["remat"]["k3a_launches"] if key == "K3a" else None,
                # the bf16 phase (csrc/dropout_attention_bf16.cu): host counts
                # over its rows (amazon MCD at compute_dtype bf16), and K3 on
                # bf16 operands at the two shapes against the bf16 bound and
                # SDPA at bf16
                "bf16": {"source": "beyond_deep_ensembles_tpu_torch/csrc/dropout_attention_bf16.cu",
                         "launches": bf16_counts[name],
                         **{shape: rows[key] for shape, rows in bf16["k3"].items()}},
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
