#!/usr/bin/env python3
"""BBB posterior-predictive eval of one checkout of the port on one CUDA
card, so that two commits can be held against each other in one call.

ResNet-20 BBB in the smoke run's configuration (``chip_smoke.py``'s
``BBB_VARIANT`` and ``SMOKE``: 1280 synthetic train images, 1000 test images
x 50 samples at eval batch 500) is built from its seed and trained 10 steps
through ``experiments/cifar.py``, as the smoke run's BBB slice does. Then:

  * ``eval_model`` ``--evals`` times, each between CUDA events: the first
    includes what K1 compiles at its first frozen-eval launches, the others
    do not;
  * a profile of one more ``eval_model``: the device's busy share of its
    wall time, kernels launched, and K1's device time and launches;
  * the device time of one frozen-eval forward's 22 K1 launches at batch
    500, replayed in a CUDA graph;
  * the host time of one eager K1 launch, no sync: frozen eval on the
    500x10 head without autograd (as in eval), and the train mode on the
    128x10 head with autograd recording (as ``chip_smoke.py`` measures it).

    python3 benchmarks_torch/bbb_eval_probe.py [--root CHECKOUT] [--label NAME] [--evals N]

``--root`` names the checkout whose ``beyond_deep_ensembles_tpu_torch`` is
imported (by default the one holding this script); the helpers and the
configuration come from this script's own checkout. To compare two commits,
unpack the other into a directory that ``.gitignore`` lists and run the
script on each in turn (A, B, B, A) in one call. Prints the card's name and
power limit first.
"""
import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K1's kernel names in the port's versions: one kernel for every mode, then
# a flat kernel and a frozen-eval kernel
K1_KERNELS = ("_sample_kernel", "_flat_kernel", "_frozen_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="checkout whose package is imported")
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--evals", type=int, default=3)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    # a cache of this process's own, so that every run compiles K1 afresh
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", f"triton_cache_{os.getpid()}")
    import torch

    if not torch.cuda.is_available():
        print("bbb_eval_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, root)
    from beyond_deep_ensembles_tpu_torch.data.cifar import load_cifar10
    from beyond_deep_ensembles_tpu_torch.experiments import cifar
    from beyond_deep_ensembles_tpu_torch.ops import sampling

    if not os.path.abspath(sampling.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {sampling.__file__}, not the package under {root}")
    label = args.label
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())

    config = {**cifar.DEFAULT_CONFIG, **cs.BBB_VARIANT, **cs.SMOKE}
    x_train, y_train = load_cifar10(True, subsample=config["subsample"])
    x_test, y_test = load_cifar10(False, subsample=config["test_subsample"])
    config["dataset_size"] = x_train.shape[0]
    steps = x_train.shape[0] // config["batch_size"]
    built = cifar.build(config, torch.Generator().manual_seed(config["seed"]), steps)
    cifar.train(built, config, x_train, y_train)
    torch.cuda.synchronize()

    n_eval = x_test.shape[0] * config["eval_samples"]
    for i in range(args.evals):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        launches = sampling.gaussian_sample.launches
        start.record()
        cifar.eval_model(built, config, x_test, y_test)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        print(f"{label}: eval {i + 1} ({'first, compiles included' if i == 0 else 'warm'}): {ms:.1f} ms = "
              f"{n_eval / ms * 1e3:.0f} samples/s, {sampling.gaussian_sample.launches - launches} K1 launches")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cifar.eval_model(built, config, x_test, y_test)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1 = [e for e in kernels if any(name in e.key for name in K1_KERNELS)]
    print(f"{label}: profile of one eval: wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
          f"({100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in kernels)} kernels; K1 "
          f"{sum(e.self_device_time_total for e in k1) / 1e3:.2f} ms in {sum(e.count for e in k1)} launches")
    del built

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def planes(shape, bias, grad=False):
        out = [0.5 * torch.randn(shape, device=dev, generator=gen),
               0.25 * torch.rand(shape, device=dev, generator=gen) + 1e-4,
               torch.randn(shape[1], device=dev, generator=gen) if bias else None,
               torch.rand(shape[1], device=dev, generator=gen) if bias else None]
        return [t.requires_grad_(grad) if t is not None else None for t in out]

    layers = [planes(shape, bias) for shape, bias in cs.bbb_shapes(500)]

    def frozen_forward():
        for m, v, bm, bv in layers:
            sampling.gaussian_sample(m, v, bm, bv, seed=5, frozen=True)

    with torch.no_grad():
        ms = min(cs.graph_ms(torch, frozen_forward, reps=10) for _ in range(2))
    print(f"{label}: K1 one frozen-eval forward at batch 500 (22 launches), CUDA graph: {ms:.4f} ms")
    del layers

    head = planes((500, 10), True)
    with torch.no_grad():
        frozen_us = cs.host_us(torch, lambda: sampling.gaussian_sample(*head, seed=5, frozen=True))
    train_head = planes((128, 10), True, grad=True)
    train_us = cs.host_us(torch, lambda: sampling.gaussian_sample(*train_head, seed=5))
    print(f"{label}: K1 host time per eager launch, no sync: frozen eval, head 500x10, no autograd "
          f"{frozen_us:.2f} us; train mode, head 128x10, autograd recording {train_us:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
