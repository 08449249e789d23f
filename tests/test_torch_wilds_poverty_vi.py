"""PyTorch port, experiments/wilds_task.py: the BBB row of
``configs/poverty.yaml`` (every layer variational, as the JAX engine builds
the from-scratch nets; GaussLayer's ``rho__mle`` out of the KL) held against
the JAX package's engine on the CPU (``_torch_wilds_parity.check_row``, with
the tolerances tests/test_torch_wilds_poverty.py states; the SVGD row is in
tests/test_torch_wilds_poverty_svgd.py)."""
import pytest

from _torch_wilds_parity import check_row, yaml_row


@pytest.mark.parametrize("name", ["BBB"])
def test_poverty_row_matches_jax(name, monkeypatch):
    check_row("poverty", yaml_row("poverty", name), monkeypatch)
