"""PyTorch port, experiments/wilds_task.py: the Rank1 row of
``configs/poverty.yaml`` (2 components, every layer rank-1) held against the
JAX package's engine on the CPU (``_torch_wilds_parity.check_row``, with the
tolerances tests/test_torch_wilds_poverty.py states)."""
import pytest

from _torch_wilds_parity import check_row, yaml_row


@pytest.mark.parametrize("name", ["Rank1"])
def test_poverty_row_matches_jax(name, monkeypatch):
    check_row("poverty", yaml_row("poverty", name), monkeypatch)
