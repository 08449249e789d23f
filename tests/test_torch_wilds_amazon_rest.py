"""PyTorch port, experiments/wilds_task.py: the other five rows of
``configs/amazon.yaml`` (SVGD, iVON, LL_iVON, Laplace, SNGP) held against
the JAX package's engine on the CPU, as ``test_torch_wilds_amazon.py``
holds the first six; Laplace's Kronecker fit is held to JAX's and the
port evaluates JAX's fitted state (``_torch_wilds_parity.run_both``).

Tolerances: as ``test_torch_wilds_amazon.py``; the Kronecker factors'
eigenvalues and the matrices they rebuild within 1e-5 relative (1e-6 of
the largest entry absolute), as ``test_torch_laplace.py``."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name", ["SVGD", "iVON", "LL_iVON", "Laplace", "SNGP"])
def test_amazon_row_matches_jax(name, monkeypatch):
    check_row("amazon", yaml_row("amazon", name), monkeypatch)
