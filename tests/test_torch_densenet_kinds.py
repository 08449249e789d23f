"""PyTorch port, models/densenet.py against the JAX package's
``DenseNetClassifier`` for the Rank-1 kind (one mixture component per
forward), the spectral kind and MC-Dropout (frozen masks at eval, as
camelyon17, and rescaled per-element masks, as fmow), train and eval, from
JAX's weights and draws (``_torch_densenet_parity.check_case``; the plain
and BBB kinds are in tests/test_torch_densenet.py).

Tolerances: logits 1e-4, parameter gradients 1e-4 of the largest gradient
(fp32 sums in another order on each side)."""
import pytest

from _torch_densenet_parity import check_case


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", ["rank1-c0", "rank1-c1", "spectral", "mcd-frozen", "mcd-rescaled"])
def test_densenet_kind_matches_jax(case, train, monkeypatch):
    check_case(case, train, monkeypatch)
