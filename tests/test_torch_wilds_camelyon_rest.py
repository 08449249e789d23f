"""PyTorch port, experiments/wilds_task.py: the SVGD, MultiSWAG and Laplace
rows of ``configs/camelyon.yaml`` held against the JAX package's engine on
the CPU (``_torch_wilds_parity.check_row``): ``build`` from JAX's initial
state, three ``train`` updates and ``eval_task`` with JAX's draws given, at
the tiny DenseNet width (growth 4, blocks (2, 2), 8 initial features,
bn_size 2) on 32x32 crops; JAX runs the row without ``conv_remat`` and
without the multi-device flags (``jax_config``).

Tolerances: every state tensor (parameters, optimizer buffers, SWAG's
moments and ring, iVON's vectors) within 2e-6 after the three updates (SVGD
2e-5; under Adam, a parameter whose gradient is zero in exact arithmetic,
the stem norm's scale, within 6 lr); the Laplace fit (``full``) by its MAP
vector, its prior precision within 1e-3 relative and its covariance within
1e-3 of its largest entry, JAX's fit then evaluated; every float metric
within 1e-5, relative or absolute."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name", ["SVGD", "MultiSWAG", "Laplace"])
def test_camelyon17_row_matches_jax(name, monkeypatch):
    check_row("camelyon17", yaml_row("camelyon", name), monkeypatch)
