#!/usr/bin/env python3
"""Where K3a's and K3b's time goes on one CUDA card: the dropout-attention
kernels of ``beyond_deep_ensembles_tpu_torch/csrc/dropout_attention.cu`` built
in several variants (nvcc ``-D`` switches the source documents) and timed in
CUDA graphs at the Amazon train shape (8, 12, 512, 64), each with no dropout,
with Philox at p = 0.1 and with a given mask at p = 0.1, beside their largest
error against the plain version.

    python3 benchmarks_torch/k3_probe.py [variant ...]   # from the repository root

Variants are ``name=flag,flag``; with none given: the build the port uses, a
single TF32 product (``-DK3_PRODUCTS=1``: wrong beyond TF32 accuracy, it only
shows what the two small products cost), and the port's build with
``-DK3_CLOCKS``, which makes K3a add up the cycles its thread 0 spends in each
phase of a key tile (they are printed per block and tile; the counting itself
costs time, so that variant's times are not the kernel's). Prints the card's
name and power limit first, then per variant ptxas's report and one line per
mode.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SHAPE = (8, 12, 512, 64)
P = 0.1
DEFAULT_VARIANTS = ["port=", "single=-DK3_PRODUCTS=1", "clocks=-DK3_CLOCKS"]
PHASES = {
    "K3a": ["wait for the tile", "split into operand tiles", "publish", "start the next loads", "start Q K^T",
            "wait for Q K^T", "softmax and dropout", "split P", "start P V", "wait for P V"],
    "K3b dQ": ["wait for the tile", "split into operand tiles", "publish", "start the next loads", "S and dO V^T",
               "elementwise", "split dS", "dS K"],
    "K3b dK/dV": ["wait for the tile", "split into operand tiles", "publish", "start the next loads",
                  "S^T and (dO V^T)^T", "elementwise", "split P_drop and dS", "P_drop^T dO and dS^T Q"],
}


def graph_ms(torch, fn, reps=20):
    """Device time of one call of ``fn`` replayed from a CUDA graph."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from beyond_deep_ensembles_tpu_torch.ops import _cuda_build
    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    b, h, l, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, l, h, d, device="cuda", generator=gen) for _ in range(4))
    mask = torch.ones(b, l, dtype=torch.int32, device="cuda")
    mask[0, 300:] = 0
    mask[1, 77:] = 0
    bias = att.key_bias(mask)
    given = (torch.rand(b, h, l, l, device="cuda", generator=gen) >= P).view(torch.uint8)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    refs = {}
    for mode, p, keep in (("none", 0.0, None), ("given", P, given)):
        out = att.dropout_attention_plain(*leaves, mask, keep, dropout_p=p)
        refs[mode] = (out.detach(), torch.autograd.grad(out, leaves, do))
    base_flags = list(_cuda_build.NVCC_FLAGS)
    for variant in sys.argv[1:] or DEFAULT_VARIANTS:
        name, _, flags = variant.partition("=")
        _cuda_build.NVCC_FLAGS[:] = base_flags + [f for f in flags.split(",") if f]
        _cuda_build.load.cache_clear()
        att._library.cache_clear()
        lib = att._library()
        for line in _cuda_build.build_logs.get("dropout_attention.cu", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        for mode, p, seed, keep in (("none", 0.0, None, None), ("philox", P, 5, None), ("given", P, None, given)):
            with torch.no_grad():
                o, lse, _ = att.attention_forward(q, k, v, bias, p, seed, keep)
                grads = att.attention_backward(q, k, v, bias, p, seed, keep, o, lse, do)
                fwd = min(graph_ms(torch, lambda: att.attention_forward(q, k, v, bias, p, seed, keep)) for _ in range(2))
                bwd = min(graph_ms(torch, lambda: att.attention_backward(q, k, v, bias, p, seed, keep, o, lse, do))
                          for _ in range(2))
            errs = ""
            if mode in refs:
                ref, ref_grads = refs[mode]
                errs = (f"; max abs err output {float((o - ref).abs().max()):.3g}, gradients "
                        f"{max(float((g - r).abs().max()) for g, r in zip(grads, ref_grads)):.3g}")
            print(f"{name} {mode}: K3a {fwd:.4f} ms, K3b {bwd:.4f} ms{errs}")
            if "K3_CLOCKS" in flags:
                clocks = (ctypes.c_ulonglong * 48)()
                lib.k3_clocks(clocks)  # clear what the timed launches added
                with torch.no_grad():
                    att.attention_forward(q, k, v, bias, p, seed, keep)
                    att.attention_backward(q, k, v, bias, p, seed, keep, o, lse, do)
                if lib.k3_clocks(clocks) != 0:
                    raise RuntimeError("k3_clocks failed")
                block_tiles = b * h * -(-l // 128) * -(-l // 64)
                for kernel, (label, phases) in enumerate(PHASES.items()):
                    mine = [clocks[16 * kernel + i] / block_tiles for i in range(len(phases))]
                    print(f"{name} {mode}: {label} cycles per block (128 rows) and tile, thread 0: "
                          + ", ".join(f"{what} {c:.0f}" for what, c in zip(phases, mine)) + f"; sum {sum(mine):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
