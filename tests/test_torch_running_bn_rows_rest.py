"""PyTorch port, experiments/wilds_task.py with ``static_bn: false``: the
camelyon17 rows on the running-statistics DenseNet (``nn/norm.py::
BatchNorm`` in every norm) held against the JAX package's engine on the CPU
(``_torch_wilds_parity.check_row``): ``build`` from JAX's initial state,
three ``train`` updates and ``eval_task`` with JAX's draws given, at the
tiny DenseNet width (growth 4, blocks (2, 2), 8 initial features, bn_size 2)
on 32x32 crops: SWAG (its draws evaluated with the trained statistics)
and Laplace (the last-layer fit and its draws on the running statistics,
``train=False``; held as tests/test_torch_wilds_camelyon_rest.py holds the
static-BN row).

Tolerances: every state tensor, the parameters and every member's and
particle's ``mean`` / ``var`` buffers among them, within 2e-6 after the
three updates; every float metric within
1e-5, relative or absolute."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

ROWS = {
    "SWAG": ("SWAG", {"swag_start_epoch": 0, "swag_updates": 3}),
    "Laplace": ("Laplace", {}),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_camelyon17_running_stats_rest_matches_jax(case, monkeypatch):
    name, extra = ROWS[case]
    check_row("camelyon17", {**yaml_row("camelyon", name), **extra, "static_bn": False}, monkeypatch)
