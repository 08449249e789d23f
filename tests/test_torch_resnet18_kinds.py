"""PyTorch port, models/resnet.py's ``ResNet18`` against the JAX package's
for the BBB kind (variational convs and head), the Rank-1 kind (one mixture
component per forward: component 0 in training, 1 at eval) and MC-Dropout
(after the stem and every conv; frozen masks at eval, FixableDropout's
default, as PovertyMap's MCD row runs it), train and eval, on 32x32x8 inputs
from JAX's weights and draws (``_torch_resnet50_parity.check_case``, under
swish).

Tolerances: outputs 1e-4, parameter gradients 1e-4 of the largest gradient
(fp32 sums in another order on each side)."""
import pytest

from _torch_resnet50_parity import check_case


@pytest.mark.parametrize("case,train", [("bbb", True), ("bbb", False), ("rank1-c0", True), ("rank1-c1", False),
                                        ("mcd-frozen", True), ("mcd-frozen", False)],
                         ids=["bbb-train", "bbb-eval", "rank1-c0-train", "rank1-c1-eval", "mcd-train", "mcd-frozen-eval"])
def test_resnet18_kind_matches_jax(case, train, monkeypatch):
    check_case(case, train, monkeypatch, arch="resnet18")
