"""PyTorch port, experiments/wilds_task.py with ``static_bn: false``: the
camelyon17 rows on the running-statistics DenseNet (``nn/norm.py::
BatchNorm`` in every norm) held against the JAX package's engine on the CPU
(``_torch_wilds_parity.check_row``): ``build`` from JAX's initial state,
three ``train`` updates and ``eval_task`` with JAX's draws given, at the
tiny DenseNet width (growth 4, blocks (2, 2), 8 initial features, bn_size 2)
on 32x32 crops: MAP, and MAP with two members (each member's own
statistics, JAX's stacked ``batch_stats``). SVGD:
tests/test_torch_running_bn_rows_svgd.py; SWAG and Laplace:
tests/test_torch_running_bn_rows_rest.py; BBB:
tests/test_torch_running_bn_rows_bbb.py.

Tolerances: every state tensor, the parameters and every member's and
particle's ``mean`` / ``var`` buffers among them, within 2e-6 after the
three updates; every float metric within
1e-5, relative or absolute."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

ROWS = {
    "MAP": ("MAP", {}),
    "MAP-members2": ("MAP", {"members": 2}),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_camelyon17_running_stats_row_matches_jax(case, monkeypatch):
    name, extra = ROWS[case]
    check_row("camelyon17", {**yaml_row("camelyon", name), **extra, "static_bn": False}, monkeypatch)
