"""PyTorch port, experiments/wilds_task.py: the first six rows of
``configs/amazon.yaml`` (MAP, MCD, SWAG, SWAG_LL, BBB, Rank1) held against
the JAX package's engine on the CPU (``_torch_wilds_parity.check_row``):
``build`` from JAX's initial state, three ``train`` updates and
``eval_task`` with JAX's draws given, TINY_CONFIG's width.

Tolerances: every state tensor (parameters, Adam moments, SWAG moments and
ring) within 2e-6 after the three lr 1e-5 updates (the ``k_lin`` biases,
whose gradient is zero in exact arithmetic, within 6 lr); every float
metric within 1e-5, relative or absolute."""
import pytest

from _torch_parity import one_cpu_thread  # noqa: F401 (a fixture)
from _torch_wilds_parity import check_row, yaml_row

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.mark.parametrize("name", ["MAP", "MCD", "SWAG", "SWAG_LL", "BBB", "Rank1"])
def test_amazon_row_matches_jax(name, monkeypatch):
    check_row("amazon", yaml_row("amazon", name), monkeypatch)
