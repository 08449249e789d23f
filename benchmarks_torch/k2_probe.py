#!/usr/bin/env python3
"""K2's fixed cost per launch on one CUDA card: ``gram`` of
``beyond_deep_ensembles_tpu_torch/ops/svgd_kernel.py`` (the single launch of
``csrc/svgd_gram.cu``) at n = 5 particles over P from 128 to 1,048,576
columns, each held against an fp64 product within its bound and timed in
CUDA graphs over copies of X that together exceed the 50 MB L2, beside the
byte bound at 3.35 TB/s. Where the time stops falling with P is what one
launch costs before it moves a byte.

    python3 benchmarks_torch/k2_probe.py   # from the repository root

Prints the card's name and power limit first, then one line per P.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
N = 5
COLUMNS = (128, 4096, 65_536, 273_610, 1_048_576)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from beyond_deep_ensembles_tpu_torch.ops import svgd_kernel as sk

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(7)
    for p in COLUMNS:
        copies = min(64, max(1, -(-60_000_000 // (4 * N * p))))
        xs = [torch.randn(N, p, device="cuda", generator=gen) + 1.0 for _ in range(copies)]
        cs.k2_check(torch, sk, xs[0])
        reps = max(copies, 4)

        def repeated():
            for i in range(reps):
                sk.gram(xs[i % copies])

        ms = min(cs.graph_ms(torch, repeated, reps=5) / reps for _ in range(2))
        bound = (4 * N * p + 4 * N * N) / cs.HBM_BYTES_PER_S * 1e3
        print(f"K2 ({N}, {p}), {copies} copies in turn: {ms * 1e3:.2f} us, byte bound {bound * 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
