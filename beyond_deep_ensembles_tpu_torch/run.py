"""Experiment CLI, the cw2 ClusterWork replacement.

Counterpart of ``beyond_deep_ensembles_tpu/run.py`` (reference entry
protocol ``python3 {task}.py {task}.yaml``):

    python -m beyond_deep_ensembles_tpu_torch.run <task> <sweep.yaml>
        [--name VARIANT] [--rep K] [--out results/] [--phase PHASE]
        [--leave-out K] [--wandb] [--device cuda|cpu]

Tasks: ``uci``, ``cifar`` and the WILDS tasks (the text tasks ``amazon``
and ``civilcomments`` are ported, every model of their yamls; the image
tasks raise in ``experiments/wilds_task.py``). Each
variant x repetition trains, evaluates and appends its records to
``<out>/<name>_<variant>/rep_<k>/metrics.jsonl``. The checkpoint-driven
phases read the ``{model}_final`` states a train phase wrote:

  --phase fit_laplace   post-hoc Laplace per repetition (CIFAR, WILDS)
  --phase multix        deep ensemble over the variant's repetitions, in
                        ``<out>/<name>_<variant>/multix[_lo<k>]/`` (CIFAR,
                        WILDS; ``--leave-out K`` for the leave-one-out
                        protocol)
  --phase drop_rates    dropout-rate sweep over a saved MCD checkpoint (WILDS)
  --phase eval          re-evaluate a saved checkpoint without training (WILDS)

``--device`` stands in for the JAX package's global backend choice: every
run goes to ``utils/device.py::resolve_device``, the card unless ``cpu`` is
asked for, with no fallback. The JAX CLI's compile cache and TPU RNG switch
(``_enable_cache``) have no meaning on a card and are not ported (ROADMAP
item 18). Sweeps are parsed with PyYAML.
"""
from __future__ import annotations

import argparse
import json
import os

from .utils.config import load_sweep
from .utils.logging import RunLogger

WILDS_TASKS = (
    "camelyon17",
    "iwildcam",
    "rxrx1",
    "fmow",
    "poverty",
    "civilcomments",
    "amazon",
)


def run_task(task: str, params: dict, log, device=None) -> dict:
    if task == "uci":
        from .experiments import uci

        return uci.run(params, log=log.info, device=device)
    if task == "cifar":
        from .experiments import cifar

        return cifar.run_single(params, log=log.info, device=device)
    if task in WILDS_TASKS:
        from .experiments import wilds_task

        return wilds_task.run_single(task, params, log=log.info, device=device)
    raise ValueError(f"unknown task {task!r}")


def run_phase(task: str, phase: str, params: dict, run_dirs, log, leave_out=None, device=None):
    """Dispatch a checkpoint-driven downstream phase. ``run_dirs`` is the
    single rep dir (fit_laplace) or the variant's rep dirs (multix)."""
    if task == "cifar":
        from .experiments import cifar

        if phase == "fit_laplace":
            return cifar.fit_laplace_phase(params, run_dirs[0], log=log.info, device=device)
        if phase == "multix":
            return cifar.multix_phase(params, run_dirs, leave_out=leave_out, log=log.info, device=device)
    if task in WILDS_TASKS:
        from .experiments import wilds_task

        if phase == "fit_laplace":
            return wilds_task.fit_laplace_phase(task, params, run_dirs[0], log=log.info, device=device)
        if phase == "drop_rates":
            return wilds_task.sweep_drop_rates_phase(task, params, run_dirs[0], log=log.info, device=device)
        if phase == "eval":
            return wilds_task.eval_only_phase(task, params, run_dirs[0], log=log.info, device=device)
        if phase == "multix":
            return wilds_task.multix_phase(task, params, run_dirs, leave_out=leave_out, log=log.info, device=device)
    raise ValueError(f"phase {phase!r} not supported for task {task!r}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("task")
    parser.add_argument("sweep", help="multi-document YAML sweep file")
    parser.add_argument("--name", default=None, help="run only this variant")
    parser.add_argument("--rep", type=int, default=None, help="run only this repetition")
    parser.add_argument("--out", default="results")
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument(
        "--phase",
        default="train",
        choices=("train", "fit_laplace", "multix", "drop_rates", "eval"),
        help="train, or a checkpoint-driven downstream phase",
    )
    parser.add_argument(
        "--leave-out",
        type=int,
        default=None,
        help="multix: exclude this repetition (leave-one-out protocol)",
    )
    parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                        help="where every run goes (default: the card, with no fallback)")
    args = parser.parse_args(argv)

    for spec in load_sweep(args.sweep, name=args.name):
        reps = range(spec["repetitions"]) if args.rep is None else [args.rep]
        variant_dir = os.path.join(args.out, f"{spec['name']}_{spec['variant']}")

        if args.phase == "multix":
            params = dict(spec["params"])
            run_dirs = [os.path.join(variant_dir, f"rep_{r}") for r in range(spec["repetitions"])]
            tag = "multix" if args.leave_out is None else f"multix_lo{args.leave_out}"
            log = RunLogger(os.path.join(variant_dir, tag), name=f"{spec['name']}/{tag}", use_wandb=args.wandb,
                            config=params)
            results = run_phase(args.task, "multix", params, run_dirs, log, leave_out=args.leave_out,
                                device=args.device)
            log.metrics(results)
            log.info(f"results: {json.dumps(results, default=float)}")
            log.close()
            continue

        for rep in reps:
            params = {**spec["params"], "seed": rep + spec["params"].get("seed_offset", 0)}
            out_dir = os.path.join(variant_dir, f"rep_{rep}")
            if args.phase in ("fit_laplace", "drop_rates", "eval"):
                log = RunLogger(os.path.join(out_dir, args.phase), name=f"{spec['name']}/r{rep}/{args.phase}",
                                use_wandb=args.wandb, config=params)
                results = run_phase(args.task, args.phase, params, [out_dir], log, device=args.device)
            else:
                params.setdefault("checkpoint_dir", out_dir)
                log = RunLogger(out_dir, name=f"{spec['name']}/r{rep}", use_wandb=args.wandb, config=params)
                log.info(f"config: {json.dumps(params, default=str)[:500]}")
                results = run_task(args.task, params, log, device=args.device)
            log.metrics(results)
            log.info(f"results: {json.dumps(results, default=float)}")
            log.close()


if __name__ == "__main__":
    main()
