"""PyTorch port, experiments/wilds_task.py: the iVON row of
``configs/poverty.yaml`` (GaussLayer's ``rho__mle`` out of the posterior: no
perturbation) held against the JAX package's engine on the CPU
(``_torch_wilds_parity.check_row``, with the tolerances
tests/test_torch_wilds_poverty.py states)."""
import pytest

from _torch_wilds_parity import check_row, yaml_row


@pytest.mark.parametrize("name", ["iVON"])
def test_poverty_row_matches_jax(name, monkeypatch):
    check_row("poverty", yaml_row("poverty", name), monkeypatch)
