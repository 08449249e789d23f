#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``beyond_deep_ensembles_tpu_torch``) on one
CUDA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failed check raises and exits non-zero; nothing is caught):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. K1 (``ops/sampling.py``, Triton, built at first use into ``build/``)
     against its plain PyTorch version at the main path's layer shapes:
     given noise, Philox moments, seeds, frozen rows, gradients (the
     Philox mode's, whose backward recovers z from the output, against the
     true draw given back, on layer planes at rho -3 and -6); then its time
     and the plain version's, replayed in CUDA graphs, for one forward's 22
     launches, and for the largest layer (Philox and given noise) and the
     head alone;
  3. the slice: BBB ResNet-20 (the ``BBB`` variant of configs/cifar.yaml)
     through ``experiments/cifar.py`` ``build`` -> ``train`` (10 steps at
     batch 128 on synthetic CIFAR-10) -> ``eval_model`` (50 posterior
     samples, eval batch 500), with K1's launch count read around it; a
     profile of steady train steps (device busy share, top kernels, the
     host's wait in the NaN guard's sync); the card's logits held against the CPU
     path's on a small input with the same weights and noise;
  4. one JSON line of kernel figures, then the result line
     ``{"ok": true, "device": {...}}``.
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

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
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
# cut to size: one epoch of 1280 synthetic images = 10 steps at batch 128
SMOKE = {"epochs": 1, "subsample": 1280, "test_subsample": 1000, "seed": 0}
TRAIN_STEPS = 10


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


def recovery_bound(out, mean, std, z, g):
    """Per element, how far d act_var from the z that the Philox-mode
    backward recovers as (out - mean) / std may lie from g*z/(2*std) at the
    true z: the output, the subtraction and the division each round once
    (2**-23 relative), and the gradient's product and quotient round on
    each side."""
    u = 2.0**-23
    dz = u * (out.abs() + mean.abs() + (std * z).abs()) / std + u * z.abs()
    return (g * dz / (2 * std)).abs() + 2 * u * (g * z / (2 * std)).abs()


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

    zeros = torch.zeros(1024, 16, 32, 32, device=dev)
    z = sampling.gaussian_sample(zeros, torch.ones_like(zeros), seed=11)
    mean, std = float(z.mean()), float(z.std())
    check(abs(mean) < 2e-3 and abs(std - 1.0) < 2e-3,
          f"K1 Philox over {z.numel()} draws: mean {mean:.2e}, std {std:.6f}")
    other = sampling.gaussian_sample(zeros, torch.ones_like(zeros), seed=12)
    check(float((z == other).float().mean()) < 1e-3, "K1 seeds 11 and 12 draw different noise")
    rows = sampling.gaussian_sample(zeros[:128], torch.ones_like(zeros[:128]), seed=13, frozen=True)
    check(bool((rows == rows[:1]).all()) and float(rows[0].std()) > 0.5, "K1 frozen mode: one row for the batch")

    # gradients: given noise against the plain version; the Philox mode,
    # whose backward recovers z from the output, against given noise at the
    # true draw, on planes a BBB layer computes at init (rho -3) and after
    # rho has shrunk (rho -6, the weight variance then at the 1e-4 clamp)
    for shape, bias in ((128, 16, 32, 32), True), ((128, 32, 16, 16), False), ((128, 10), True):
        for rho in (-3.0, -6.0):
            leaves = [t.requires_grad_(True) for t in layer_planes(torch, gen, shape, bias, rho)]
            args = leaves if bias else leaves + [None, None]
            g = torch.randn(shape, device=dev, generator=gen)
            z = sampling.gaussian_sample(torch.zeros(shape, device=dev), torch.ones(shape, device=dev), seed=21)
            given = sampling.gaussian_sample(*args, eps=z)
            want = torch.autograd.grad((given * g).sum(), leaves)
            ref = sampling.gaussian_sample_plain(*args, z)
            plain = torch.autograd.grad((ref * g).sum(), leaves)
            for a, b in zip(want, plain):
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                check(err <= 1e-5, f"K1 given-noise gradient {tuple(a.shape)}, rho {rho:g} = plain (rel err {err:.2e} <= 1e-5)")
            out = sampling.gaussian_sample(*args, seed=21)
            check(torch.equal(out, given), f"K1 Philox draw at seed 21 = the same z given, {shape}")
            got = torch.autograd.grad((out * g).sum(), leaves)
            with torch.no_grad():
                mean = sampling._add_bias(args[0], args[2])
                std = torch.sqrt(sampling._add_bias(args[1], args[3]))
                z_err = float(((out - mean) / std - z).abs().max())
                bound = recovery_bound(out, mean, std, z, g)
            check(torch.equal(got[0], want[0]) and (not bias or torch.equal(got[2], want[2])),
                  f"K1 Philox d mean = given-noise d mean exactly, {shape}, rho {rho:g}")
            ratio = float(((got[1] - want[1]).abs() / bound.clamp_min(1e-38)).max())  # 0/0 where g = 0
            rel = float((got[1] - want[1]).abs().max()) / float(want[1].abs().max())
            check(ratio <= 1.0, f"K1 Philox d var within the z-recovery rounding bound, {shape}, rho {rho:g} "
                  f"(recovered z off by {z_err:.2e}; largest error {ratio:.2f} of the bound, {rel:.2e} of max |d var|)")
            if bias:
                terms = out.numel() // shape[1]
                sum_bound = sampling._channel_sum(bound) + math.ceil(math.log2(terms)) * 2.0**-23 * sampling._channel_sum(want[1].abs())
                check(bool(((got[3] - want[3]).abs() <= sum_bound).all()),
                      f"K1 Philox d bias var within the channel sums of that bound, {shape}, rho {rho:g}")

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
    return {
        "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": worst,
    }


def profile_steps(torch, built, xd, yd, noise, steps=3):
    """Device time by kernel over ``steps`` steady train steps; prints the
    top entries and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    bs = 128
    method = built.method
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            idx = slice(i * bs, (i + 1) * bs)
            built.state, _ = method.update(built.state, noise, (xd[idx], yd[idx]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = [e for e in averages if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        print("profile: no device time in the trace (not measured)")
        return
    ops = sum(e.count for e in averages if e.key.startswith("aten::"))
    print(f"profile of {steps} train steps: wall {wall_ms:.2f} ms, device busy {device_us / 1e3:.2f} ms "
          f"({100 * device_us / 1e3 / wall_ms:.1f}% of the window); per step "
          f"{sum(e.count for e in kernels) // steps} kernels, {ops // steps} aten ops (nested ops counted)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    top += [e for e in kernels if "_sample_kernel" in e.key and e not in top]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / steps:9.4f} ms/step  {e.count // steps:5d} calls/step  {e.key[:90]}")
    # the NaN guard's loss.item() is the step's one host sync: the host's
    # time inside it is what a guard kept on the device could give back
    item_us = sum(e.cpu_time_total for e in averages if e.key == "aten::item")
    print(f"host blocked in the NaN guard's loss.item(): {item_us / 1e3 / steps:.3f} ms/step "
          f"({100 * item_us / 1e3 / wall_ms:.1f}% of the window)")


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
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10
    from beyond_deep_ensembles_tpu_torch.experiments import cifar
    from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import sampling

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} card(s): {name}")

    k1 = kernel_phase(torch, sampling)

    config = {**cifar.DEFAULT_CONFIG, **BBB_VARIANT, **SMOKE}
    x_train, y_train = load_cifar10(True, subsample=config["subsample"])
    x_test, y_test = load_cifar10(False, subsample=config["test_subsample"])
    config["dataset_size"] = x_train.shape[0]
    steps = x_train.shape[0] // config["batch_size"]
    check(steps == TRAIN_STEPS, f"{steps} train steps of batch {config['batch_size']}")
    built = cifar.build(config, torch.Generator().manual_seed(config["seed"]), steps)
    check(built.device.type == "cuda", "build() defaults to the card")
    losses = []

    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    sampling.gaussian_sample.launches = 0
    start.record()
    cifar.train(built, config, x_train, y_train, log=print)  # raises on a non-finite loss
    mid.record()
    train_launches = sampling.gaussian_sample.launches
    result = cifar.eval_model(built, config, x_test, y_test).as_dict()
    end.record()
    launches = sampling.gaussian_sample.launches
    end.synchronize()
    eval_batches = -(-x_test.shape[0] // config["eval_batch_size"])
    per_forward = len(bbb_shapes(1))
    check(train_launches == TRAIN_STEPS * config["bbb_mc_samples"] * per_forward,
          f"K1 launched {train_launches} times in {TRAIN_STEPS} train steps ({per_forward} x mc {config['bbb_mc_samples']} per step)")
    check(launches - train_launches == eval_batches * config["eval_samples"] * per_forward,
          f"K1 launched {launches - train_launches} times in eval ({eval_batches} batches x {config['eval_samples']} samples x {per_forward})")
    params_finite = all(bool(torch.isfinite(p).all()) for p in built.state.params.parameters())
    check(params_finite, "parameters finite after training")
    check(all(isinstance(v, float) and v == v and abs(v) != float("inf") for v in result.values()),
          f"eval metrics finite: {json.dumps(result)}")
    check(0.0 <= result["accuracy"] <= 1.0 and result["avg_log_likelihood"] < 0.0, "eval metrics in range")
    train_ms, eval_ms = start.elapsed_time(mid), mid.elapsed_time(end)
    n_eval = x_test.shape[0] * config["eval_samples"]
    print(f"train: {TRAIN_STEPS} steps in {train_ms:.1f} ms = {train_ms / TRAIN_STEPS:.2f} ms/step (first steps included)")
    print(f"eval: {x_test.shape[0]} images x {config['eval_samples']} samples in {eval_ms:.1f} ms = "
          f"{n_eval / eval_ms * 1e3:.0f} samples/s ({x_test.shape[0] / eval_ms * 1e3:.1f} images/s)")

    # steady train steps on the trained state, outside the counted run
    xd = torch.from_numpy(x_train).cuda().permute(0, 3, 1, 2).contiguous()
    yd = torch.from_numpy(y_train).cuda()
    noise = NoiseSource.seeded(1)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * TRAIN_STEPS + 1)]
    marks[0].record()
    for i in range(2 * TRAIN_STEPS):
        idx = slice((i % TRAIN_STEPS) * 128, (i % TRAIN_STEPS + 1) * 128)
        built.state, m = built.method.update(built.state, noise, (xd[idx], yd[idx]))
        losses.append(m["loss"])
        marks[i + 1].record()
    marks[-1].synchronize()
    check(all(bool(torch.isfinite(v)) for v in losses), "steady steps: every loss finite")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    print(f"steady train step over {len(step_ms)} steps (batch 128, mc 2): median "
          f"{step_ms[len(step_ms) // 2]:.2f} ms, max {step_ms[-1]:.2f} ms, min {step_ms[0]:.2f} ms")
    profile_steps(torch, built, xd, yd, noise)
    small_input_check(torch, NoiseSource, ResNet20)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "k1_gaussian_sample",
        "route": "triton",
        "source": "beyond_deep_ensembles_tpu_torch/ops/sampling.py",
        "replaces": "beyond_deep_ensembles_tpu/ops/sampling.py:46",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
