#!/usr/bin/env python3
"""K1 on bf16 planes on one CUDA card, without the rest of ``chip_smoke.py``.

    python3 benchmarks_torch/k1_bf16_probe.py           # from the repository root
    python3 benchmarks_torch/k1_bf16_probe.py --step    # K1's share of a captured poverty BBB bf16 step

Builds ``csrc/gaussian_sample_bf16.cu`` (ptxas's report), holds the bf16
kernels with ``chip_smoke.k1_bf16_hold`` on small planes of every layout
they tell apart (a bias of one channel a group of 8, of two, of any; no
bias; a dense head of 10 and a ragged one of 5, whose offsets fall inside a
group), then runs ``chip_smoke.bf16_k1_phase``: the SASS counts before and
after, the draw's checks, and poverty's, camelyon17's and CIFAR's planes
held and timed. With ``--step``, only ``step_share``: K1's share of a captured
poverty BBB bf16 step, through the CUDA kernels and through the Triton
ones, in turns. Prints the card's name and power limit first.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SMALL_PLANES = [((6, 16, 8, 8), True), ((5, 64, 11, 11), True), ((4, 3, 3, 3), True), ((6, 32, 16, 16), False),
                ((7, 10), True), ((9, 5), True)]


def small_planes(torch):
    gen = torch.Generator(device="cuda").manual_seed(3)
    planes = []
    for shape, bias in SMALL_PLANES:
        mean = (0.5 * torch.randn(shape, device="cuda", generator=gen)).bfloat16()
        var = (0.25 * torch.rand(shape, device="cuda", generator=gen) + 1e-4).bfloat16()
        b_mean = torch.randn(shape[1], device="cuda", generator=gen).bfloat16() if bias else None
        b_var = torch.rand(shape[1], device="cuda", generator=gen).bfloat16() if bias else None
        planes.append((mean, var, b_mean, b_var))
    return planes


def step_share(torch, cs, sampling, wilds_task, routes=("cuda", "triton", "cuda"), k=2):
    """A captured poverty BBB step at ``compute_dtype: bf16`` (batch 64,
    224x224x8; a graph of ``k`` steps replayed), for each of ``routes`` in
    turn: K1's bf16 planes through the CUDA kernels (the port's path) or
    through the Triton kernels (``_launch_triton``, the earlier bf16 path, put in
    place of ``_launch`` for the measurement). Each: the replayed step's
    time by CUDA events, and from ``chip_smoke.profile_steps`` the device's
    busy share and K1's share of the device time."""
    from beyond_deep_ensembles_tpu_torch.parallel import multistep

    launch = sampling._launch
    built, _, batches = cs.wilds_built(torch, wilds_task, "poverty", "BBB", n_batches=2 * k, compute_dtype="bf16")
    stacked = [multistep.stack_batches(batches[i * k:(i + 1) * k]) for i in range(2)]
    figures = []
    try:
        for route in routes:
            sampling._launch = launch if route == "cuda" else (
                lambda a, v, bm, bv, eps, seed, frozen, backward, rows=None:
                sampling._launch_triton(a, v, bm, bv, eps, seed, frozen, backward, rows))
            multi = multistep.make_multi_step(built.method.update, k)
            built.state, _ = multi(built.state, 1, stacked[0])

            def step(i):
                built.state, _ = multi(built.state, 2 + i, stacked[i % 2])

            with cs.alone_section():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for i in range(4):
                    step(i)
                end.record()
                end.synchronize()
            ms = start.elapsed_time(end) / (4 * k)
            profile = cs.profile_steps(torch, step, ours=("k1_flat", "_flat_kernel"), steps=2,
                                       label=f"graphs of {k} poverty BBB bf16 steps, K1 by {route}")
            k1_ms = profile_k1_ms(torch, step, k)
            figures.append({"route": route, "step_ms": ms, "k1_ms": k1_ms, "busy": profile and profile["busy"]})
            print(f"poverty BBB bf16 captured step, K1 by {route}: {ms:.2f} ms a step, K1 {k1_ms:.3f} ms of it "
                  f"({100 * k1_ms / ms:.1f}%) [{cs.CARD}]")
            del multi
    finally:
        sampling._launch = launch
    return figures


def profile_k1_ms(torch, step, k, reps=2):
    """K1's device time a step (its flat kernels, forward and backward) from
    torch.profiler over ``reps`` replays of a graph of ``k`` steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            step(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if "k1_flat" in e.key or "_flat_kernel" in e.key)
    return us / 1e3 / (reps * k)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_bf16_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import _cuda_build, sampling

    cs.setup("first")
    cs.CARD = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(cs.CARD)
    t0 = time.perf_counter()
    _cuda_build.build("gaussian_sample_bf16.cu")
    print(f"gaussian_sample_bf16.cu built in {time.perf_counter() - t0:.2f} s")
    for line in _cuda_build.build_logs.get("gaussian_sample_bf16.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line or "error" in line:
            print(f"  nvcc: {line.strip()}")
    if "--step" in sys.argv:
        step_share(torch, cs, sampling, wilds_task)
        return 0
    cs.k1_bf16_hold(torch, sampling, small_planes(torch), "the small planes of every layout")
    t0 = time.perf_counter()
    cs.bf16_k1_phase(torch, sampling, wilds_task, cifar, NoiseSource)
    print(f"bf16 K1 phase: {time.perf_counter() - t0:.1f} s [{cs.CARD}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
