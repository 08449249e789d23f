"""Plotting & result tables.

Counterpart of ``beyond_deep_ensembles_tpu/evals/plotting.py``: the results
may hold tensors (on any device) or arrays. Reference: reliability diagrams (src/eval/calibration.py:17-65,128-159),
regression calibration plots and the tabulate/LaTeX results table
(src/eval/regresssion.py:66-117). Matplotlib imports are local so
headless metric pipelines never pay for them.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reliability_diagram(results, ax=None, title: Optional[str] = None, include_text=True):
    """Bin accuracy vs confidence plot from a CalibrationResults
    (reference calibration.py:128-159)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    counts = _np(results.bin_counts)
    accs = _np(results.bin_accuracys)
    confs = _np(results.bin_confidences)
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.plot([0, 1], [0, 1], color="royalblue")
    ax.plot(confs, accs, "o-", color="darkorange")
    if include_text:
        text = f"ECE: {float(results.ece):.3f}"
        if title:
            text = f"{title}\n{text}"
        ax.text(0.08, 0.9, text, transform=ax.transAxes, va="top",
                bbox={"boxstyle": "square,pad=0.5", "facecolor": "white"})
    for x, c in zip(confs, counts):
        ax.annotate(str(int(c)), (x, 0.02), fontsize=8, ha="center")
    return ax


def regression_calibration_plot(results, ax=None, title: Optional[str] = None):
    """Observed vs expected confidence levels (reference
    regresssion.py:66-83)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ax.set_xlabel("Expected Confidence Level")
    ax.set_ylabel("Observed Confidence Level")
    ax.plot([0, 1], [0, 1], color="royalblue")
    ax.plot(_np(results.quantile_ps), _np(results.observed_cdf),
            "o-", color="darkorange")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    if title:
        ax.text(0.08, 0.9, f"{title}\nQCE: {float(results.qce):.3f}",
                transform=ax.transAxes, va="top",
                bbox={"boxstyle": "square,pad=0.5", "facecolor": "white"})
    return ax


def regression_table(
    title: str, named_results: List[tuple], filename: Optional[str] = None, latex: bool = False
) -> str:
    """Aggregate repetitions into a mean±stderr table (reference
    plot_table, regresssion.py:85-117). named_results: list of
    (name, [RegressionResults per repetition])."""
    from tabulate import tabulate

    rows, latex_rows = [], []
    for name, results in named_results:
        lml = np.asarray([float(r.average_lml) for r in results])
        mse = np.asarray([float(r.mse_of_means) for r in results])
        qce = np.asarray([float(r.qce) for r in results])
        sqce = np.asarray([float(r.sqce) for r in results])
        div = math.sqrt(len(results))
        rows.append([
            name,
            f"{lml.mean():.2f} ± {lml.std() / div:.2f}",
            f"{mse.mean():.4f} ± {mse.std() / div:.4f}",
            f"{qce.mean():.2f} ± {qce.std() / div:.2f}",
        ])
        tag = "O" if sqce.mean() < 0 else "U"  # over/underconfident
        latex_rows.append(
            f"{name} & ${lml.mean():.2f} \\pm {lml.std() / div:.2f}$"
            f" & ${mse.mean():.4f} \\pm {mse.std() / div:.4f}$"
            f" & ${qce.mean():.2f}\\textrm{{{tag}}} \\pm {qce.std() / div:.2f}$ \\\\"
        )
    table = tabulate(rows, headers=(title, "Avg LML", "MSE of Means", "QCE"), tablefmt="orgtbl")
    out = table + ("\n" + "\n".join(latex_rows) if latex else "")
    if filename:
        with open(filename, "w") as f:
            f.write(out)
    return out
