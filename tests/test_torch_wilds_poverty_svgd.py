"""PyTorch port, experiments/wilds_task.py: the SVGD row of
``configs/poverty.yaml`` (5 particles, cut to 3; its particles' ``rho__mle`` out of the
Stein transport, stepped by its raw gradient) held against the JAX package's engine on
the CPU (``_torch_wilds_parity.check_row``, with the tolerances
tests/test_torch_wilds_poverty.py states)."""
import pytest

from _torch_wilds_parity import check_row, yaml_row


@pytest.mark.parametrize("name", ["SVGD"])
def test_poverty_row_matches_jax(name, monkeypatch):
    check_row("poverty", yaml_row("poverty", name), monkeypatch)
