"""Classification calibration metrics.

Counterpart of ``beyond_deep_ensembles_tpu/evals/calibration.py`` (reference
src/eval/calibration.py): per-bin sums as a sum over the points of a one-hot
bin matrix, so the metric runs on the device in O(N B) and is deterministic
there (``index_add_`` adds on a card by atomics, in an order that varies
from run to run: the same log-probs gave ECEs 1e-5 apart). ``correct`` is
the per-point correctness indicator (the reference calls it ``errors``).
"""
from __future__ import annotations

import dataclasses

import torch


def _static_bin_ids(confidences: torch.Tensor, bin_count: int) -> torch.Tensor:
    """bin = clamp(floor(conf * B), 0, B-1) (reference calibration.py:70)."""
    ids = torch.floor(confidences * bin_count).long()
    return torch.clamp(ids, 0, bin_count - 1)


def _adaptive_bin_ids(confidences: torch.Tensor, bin_count: int):
    """Equal-mass bins with ``torch.chunk`` semantics (reference
    calibration.py:74-76): chunk size ceil(N/B) over the points sorted by
    confidence. Returns (bin id per sorted point, sorted order)."""
    n = confidences.shape[0]
    order = torch.argsort(confidences, stable=True)
    chunk = -(-n // bin_count)
    ids_sorted = torch.arange(n, device=confidences.device) // chunk
    return ids_sorted, order


def _bin_stats(bin_ids, correct, confidences, bin_count):
    one_hot = torch.nn.functional.one_hot(bin_ids, bin_count).to(torch.float32)

    def seg_sum(values):
        return torch.sum(one_hot * values.float()[:, None], dim=0)

    counts = seg_sum(torch.ones_like(confidences))
    acc_sum = seg_sum(correct)
    conf_sum = seg_sum(confidences)
    safe = torch.clamp(counts, min=1.0)
    zero = torch.zeros_like(counts)
    bin_acc = torch.where(counts > 0, acc_sum / safe, zero)
    bin_conf = torch.where(counts > 0, conf_sum / safe, zero)
    return counts, bin_acc, bin_conf


def _weighted_calibration_error(counts, bin_acc, bin_conf, signed=False):
    gap = bin_acc - bin_conf
    if not signed:
        gap = torch.abs(gap)
    return torch.sum(counts * gap) / torch.sum(counts)


def calculate_ece(bin_count: int, correct, confidences) -> torch.Tensor:
    """Expected calibration error, static bins (reference calibration.py:9-11)."""
    ids = _static_bin_ids(confidences, bin_count)
    return _weighted_calibration_error(*_bin_stats(ids, correct, confidences, bin_count))


def calculate_mce(bin_count: int, correct, confidences) -> torch.Tensor:
    """Maximum calibration error (reference calibration.py:13-15, 89-92);
    empty bins contribute |0 - 0| = 0."""
    ids = _static_bin_ids(confidences, bin_count)
    _, bin_acc, bin_conf = _bin_stats(ids, correct, confidences, bin_count)
    return torch.max(torch.abs(bin_acc - bin_conf))


def calculate_ace(bin_count: int, correct, confidences) -> torch.Tensor:
    """Adaptive calibration error (reference calibration.py:5-7)."""
    ids_sorted, order = _adaptive_bin_ids(confidences, bin_count)
    stats = _bin_stats(ids_sorted, correct[order], confidences[order], bin_count)
    return _weighted_calibration_error(*stats)


@dataclasses.dataclass
class CalibrationResults:
    """Per-bin statistics + ECE / signed ECE (reference
    ClassificationCalibrationResults, calibration.py:94-126)."""

    bin_counts: torch.Tensor
    bin_accuracys: torch.Tensor
    bin_confidences: torch.Tensor
    ece: torch.Tensor

    @classmethod
    def create(cls, bin_count: int, correct, confidences) -> "CalibrationResults":
        ids = _static_bin_ids(confidences, bin_count)
        counts, bin_acc, bin_conf = _bin_stats(ids, correct, confidences, bin_count)
        return cls(counts, bin_acc, bin_conf, _weighted_calibration_error(counts, bin_acc, bin_conf))

    @property
    def signed_ece(self) -> torch.Tensor:
        """Signed ECE: positive = underconfident (reference
        calibration.py:119-126)."""
        return _weighted_calibration_error(
            self.bin_counts, self.bin_accuracys, self.bin_confidences, signed=True
        )
