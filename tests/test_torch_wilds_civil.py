"""PyTorch port, experiments/wilds_task.py: the first five rows of
``configs/civilcomments.yaml`` (MAP, MCD, SWAG, BBB, Rank1) held against
the JAX package's engine on the CPU, as ``test_torch_wilds_amazon.py`` holds
Amazon's (``_torch_wilds_parity.check_row``: ``build`` from JAX's initial
state, three ``train`` updates and ``eval_task`` with JAX's draws given,
TINY_CONFIG's width, two classes and the worst-group metrics).

Tolerances: as ``test_torch_wilds_amazon.py``."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name", ["MAP", "MCD", "SWAG", "BBB", "Rank1"])
def test_civilcomments_row_matches_jax(name, monkeypatch):
    check_row("civilcomments", yaml_row("civilcomments", name), monkeypatch)
