#!/usr/bin/env python3
"""K3 on bf16 operands on one CUDA card, without the rest of ``chip_smoke.py``.

    python3 benchmarks_torch/bf16_probe.py [variant ...]   # from the repository root
    python3 benchmarks_torch/bf16_probe.py --phase         # chip_smoke.py's bf16 phase, alone

By default: the CUDA sources built, then ``chip_smoke.bf16_k3`` at (B, H, L,
D) = (8, 12, 512, 64) and (16, 12, 300, 64): K3a and K3b on bf16 operands
(``csrc/dropout_attention_bf16.cu`` through ``ops/attention.py``) against
the plain version, then timed in turns with SDPA at bf16 with the key mask
and dropout p = 0.1 on the script's yardstick (device time only: CUDA-graph
replays, or the profiler's summed kernel time where SDPA does not capture;
its kernels printed). Then, for the port's build and for each variant
(``name=flag,flag``: nvcc ``-D`` switches the source documents, such as
``clocks=-DK3_CLOCKS``), K3a and K3b at both shapes with Philox at p =
0.1 and with no dropout (p = 0), each the minimum of three CUDA-graph
timings, and the backward's two kernels' device times from the profiler;
with ``-DK3_CLOCKS`` also each kernel's cycles by phase of a tile (the
counting costs time, so that variant's times are not the kernels').
With ``--phase``: the build and ``chip_smoke.bf16_phase`` (its checks and
figures) in one process, and the phase's seconds. Prints the card's name and
power limit first.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
P = 0.1


def variant_times(torch, cs, att, _cuda_build, variants):
    """K3a and K3b at the shapes of ``chip_smoke.BF16_K3_SHAPES`` for each
    build variant: Philox at p = ``P`` and no dropout, and the backward's
    kernels one by one."""
    base = list(_cuda_build.NVCC_FLAGS)
    inputs = {}
    for b, h, l, d in cs.BF16_K3_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v, do = (torch.randn(b, l, h, d, device="cuda", generator=gen).bfloat16() for _ in range(4))
        inputs[(b, h, l, d)] = (q, k, v, do, att.key_bias(torch.ones(b, l, dtype=torch.int32, device="cuda")))
    for variant in variants:
        name, _, flags = variant.partition("=")
        _cuda_build.NVCC_FLAGS[:] = base + [f for f in flags.split(",") if f]
        _cuda_build.load.cache_clear()
        att._library_bf16.cache_clear()
        att._library_bf16()
        for line in _cuda_build.build_logs.get("dropout_attention_bf16.cu", "").splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"{name}: {line.strip()}")
        for shape, (q, k, v, do, bias) in inputs.items():
            for mode, p, seed in (("philox", P, 5), ("none", 0.0, None)):
                with torch.no_grad():
                    o, lse, _ = att.attention_forward(q, k, v, bias, p, seed, None)
                    fwd = min(cs.graph_ms(torch, lambda: att.attention_forward(q, k, v, bias, p, seed, None), reps=30)
                              for _ in range(3))
                    bwd = min(cs.graph_ms(torch, lambda: att.attention_backward(q, k, v, bias, p, seed, None, o, lse,
                                                                                  do), reps=30) for _ in range(3))
                print(f"{name} {shape} {mode}: K3a {fwd:.4f} ms, K3b {bwd:.4f} ms [{cs.CARD}]")
            for mode, p, seed in (("philox", P, 5), ("none", 0.0, None)):
                with torch.no_grad():
                    o, lse, _ = att.attention_forward(q, k, v, bias, p, seed, None)
                    per = per_kernel_us(torch, cs, lambda: att.attention_backward(q, k, v, bias, p, seed, None, o, lse,
                                                                                    do))
                print(f"{name} {shape} {mode}, K3b by kernel (profiler): "
                      + ", ".join(f"{kernel} {us:.1f} us" for kernel, us in per.items()))
            if "K3_CLOCKS" in flags:
                print_clocks(torch, att, name, shape, q, k, v, do, bias)
    _cuda_build.NVCC_FLAGS[:] = base
    _cuda_build.load.cache_clear()
    att._library_bf16.cache_clear()


PHASES = {
    label: ["the stage's release", f"elementwise ({mask})", "wait for the next tile", "issue the products",
            "wait for the products"]
    for label, mask in (("K3a", "and the next tile's mask"), ("K3b dQ", "and the next tile's mask"),
                        ("K3b dK/dV", "with the dQ launch's keep bits"))
}


def print_clocks(torch, att, name, shape, q, k, v, do, bias):
    """With ``-DK3_CLOCKS``: one K3a and one K3b launch with Philox, and the
    cycles the first consumer thread of each block spent in each phase of a
    tile, averaged over blocks and tiles, and from its first wait to its last
    store, averaged over blocks."""
    import ctypes

    b, h, l, _ = shape
    lib = att._library_bf16()
    lib.k3_bf16_clocks.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * 24)()
    with torch.no_grad():
        o, lse, _ = att.attention_forward(q, k, v, bias, P, 5, None)
        if lib.k3_bf16_clocks(clocks) != 0:  # clears what earlier launches added
            raise RuntimeError("k3_bf16_clocks failed")
        att.attention_forward(q, k, v, bias, P, 5, None)
        att.attention_backward(q, k, v, bias, P, 5, None, o, lse, do)
    if lib.k3_bf16_clocks(clocks) != 0:
        raise RuntimeError("k3_bf16_clocks failed")
    blocks, tiles = b * h * -(-l // 128), -(-l // 64)
    for kernel, (label, phases) in enumerate(PHASES.items()):
        mine = [clocks[8 * kernel + i] / (blocks * tiles) for i in range(len(phases))]
        print(f"{name} {shape} philox: {label} cycles per tile, first consumer thread: "
              + ", ".join(f"{what} {c:.0f}" for what, c in zip(phases, mine))
              + f"; sum {sum(mine):.0f}; whole walk {clocks[8 * kernel + 7] / blocks:.0f} a block")


def per_kernel_us(torch, cs, fn, reps=20):
    """Device time per call of each kernel ``fn`` launches, by the kernel's
    name in the source (dq_kernel, dkdv_kernel), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with cs.alone_section(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = next((n for n in ("dq_kernel", "dkdv_kernel", "fwd") if n in e.key), e.key[:60])
            out[name] = out.get(name, 0.0) + e.self_device_time_total / reps
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bf16_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from beyond_deep_ensembles_tpu_torch.ops import _cuda_build
    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    cs.setup("first")
    cs.CARD = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(cs.CARD)
    cs.build_phase(torch, _cuda_build)
    if "--phase" not in sys.argv[1:]:
        for shape in cs.BF16_K3_SHAPES:
            cs.bf16_k3(torch, att, shape)
        variant_times(torch, cs, att, _cuda_build, ["port=", *sys.argv[1:]])
        return 0
    from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import sampling, svgd_kernel

    t0 = time.perf_counter()
    cs.bf16_phase(torch, cs.kernel_registry(sampling, svgd_kernel, att), att, sampling, wilds_task, cifar,
                  NoiseSource)
    print(f"bf16 phase: {time.perf_counter() - t0:.1f} s [{cs.CARD}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
