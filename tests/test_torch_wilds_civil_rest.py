"""PyTorch port, experiments/wilds_task.py: the other four rows of
``configs/civilcomments.yaml`` (LL_SVGD, LL_iVON, Laplace, SNGP), and two
variants no yaml row names, the last-layer BBB (``ll_bbb``) and a two-member
MAP ensemble (``members: 2``), held against the JAX package's engine on the
CPU as ``test_torch_wilds_amazon.py`` holds Amazon's rows.

Tolerances: as ``test_torch_wilds_amazon.py`` and
``test_torch_wilds_amazon_rest.py``."""
import pytest

from _torch_parity import one_cpu_thread  # noqa: F401 (a fixture)
from _torch_wilds_parity import check_row, yaml_row

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.mark.parametrize("name", ["LL_SVGD", "LL_iVON", "Laplace", "SNGP"])
def test_civilcomments_row_matches_jax(name, monkeypatch):
    check_row("civilcomments", yaml_row("civilcomments", name), monkeypatch)


@pytest.mark.parametrize("variant", [{"model": "ll_bbb", "weight_decay": 0.0}, {"model": "map", "members": 2}],
                         ids=["ll_bbb", "map_members2"])
def test_variant_matches_jax(variant, monkeypatch):
    check_row("civilcomments", {**yaml_row("civilcomments", "MAP"), **variant}, monkeypatch)
