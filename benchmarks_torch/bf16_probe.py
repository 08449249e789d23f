#!/usr/bin/env python3
"""The bf16 kernels and the bf16 phase on one CUDA card, without the rest of
``chip_smoke.py``.

    python3 benchmarks_torch/bf16_probe.py           # from the repository root
    python3 benchmarks_torch/bf16_probe.py --phase   # chip_smoke.py's bf16 phase, alone

By default: the CUDA sources built, then K3 on bf16 operands
(``csrc/dropout_attention_bf16.cu`` through ``ops/attention.py``) at
(B, H, L, D) = (8, 12, 512, 64) and (16, 12, 300, 64), p = 0.1, Philox: the
forward and the backward launch, SDPA at bf16 (its forward, and its
backward by autograd) and the fp32 K3's forward, each the mean of 50 calls
between CUDA events after 5 warm-up calls. With ``--phase``: the build and
``chip_smoke.bf16_phase`` (its checks and figures) in one process, and the
phase's seconds. Prints the card's name and power limit first.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SHAPES = ((8, 12, 512, 64), (16, 12, 300, 64))
P = 0.1


def events_ms(torch, fn, n=50):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def k3_times(torch):
    import torch.nn.functional as F

    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    for b, h, l, d in SHAPES:
        q, k, v, do = (torch.randn(b, l, h, d, device="cuda").bfloat16() for _ in range(4))
        bias = att.key_bias(torch.ones(b, l, dtype=torch.int32, device="cuda"))
        o, lse, _ = att.attention_forward(q, k, v, bias, P, 7, None)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, dropout_p=P)
        q32, k32, v32 = q.float(), k.float(), v.float()
        times = {
            "K3a bf16": events_ms(torch, lambda: att.attention_forward(q, k, v, bias, P, 7, None)),
            "K3b bf16": events_ms(torch, lambda: att.attention_backward(q, k, v, bias, P, 7, None, o, lse, do)),
            "SDPA bf16 forward": events_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, dropout_p=P)),
            "SDPA bf16 backward": events_ms(torch, lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                                                                               retain_graph=True)),
            "K3a fp32": events_ms(torch, lambda: att.attention_forward(q32, k32, v32, bias, P, 7, None)),
        }
        print(f"{(b, h, l, d)} p = {P}: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bf16_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from beyond_deep_ensembles_tpu_torch.ops import _cuda_build

    cs.setup("first")
    cs.CARD = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(cs.CARD)
    cs.build_phase(torch, _cuda_build)
    if "--phase" not in sys.argv[1:]:
        k3_times(torch)
        return 0
    from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
    from beyond_deep_ensembles_tpu_torch.ops import sampling, svgd_kernel
    from beyond_deep_ensembles_tpu_torch.ops import attention as att

    t0 = time.perf_counter()
    cs.bf16_phase(torch, cs.kernel_registry(sampling, svgd_kernel, att), att, sampling, wilds_task, cifar,
                  NoiseSource)
    print(f"bf16 phase: {time.perf_counter() - t0:.1f} s [{cs.CARD}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
