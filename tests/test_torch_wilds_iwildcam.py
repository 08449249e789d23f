"""PyTorch port, experiments/wilds_task.py: the MAP, MCD, SWAG_LL and
SWAG_LL_PODS rows of ``configs/iwildcam.yaml`` (ResNet-50, Adam at lr 3e-5,
182 classes, macro-F1; SWAG_LL_PODS's multi-device flags no-ops on one
device) held against the JAX package's engine on the CPU
(``_torch_wilds_parity.check_row``): ``build`` from JAX's initial state,
three ``train`` updates and ``eval_task`` with JAX's draws given, at the
engine's tiny ResNet-50 (stage sizes (1, 1)) on 32x32 crops, both engines'
ResNet-50 under swish (``swish_resnets``: ReLU's kink makes fp32 gradients
of two frameworks part); JAX runs the row without the multi-device flags
(``jax_config``). The other rows are in tests/test_torch_wilds_iwildcam_ll.py.

Tolerances: every state tensor (parameters, optimizer buffers, SWAG's
moments and ring) within 2e-6 after the three updates (under Adam a
parameter whose gradient is zero in exact arithmetic, a bottleneck conv's
bias before its static BN, within 6 lr: ``_torch_wilds_parity.zero_gradient``);
every float metric within 1e-5, relative or absolute."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name", ["MAP", "MCD", "SWAG_LL", "SWAG_LL_PODS"])
def test_iwildcam_row_matches_jax(name, monkeypatch):
    check_row("iwildcam", yaml_row("iwildcam", name), monkeypatch)
