"""PyTorch port, experiments/wilds_task.py: the LL_iVON, SNGP and Laplace
rows of ``configs/rxrx1.yaml`` (ResNet-50, Adam at lr 1e-4 and iVON's head
rate under one ``cosine_warmup`` schedule, 1139 classes) held against the
JAX package's engine on the CPU (``_torch_wilds_parity.check_row``):
``build`` from JAX's initial state, three ``train`` updates and
``eval_task`` with JAX's draws given, at the engine's tiny ResNet-50 (stage
sizes (1, 1)) on 32x32 crops, both engines' ResNet-50 under swish
(``swish_resnets``); LL_iVON also with ``warmup_steps: 2``, so that both
optimizers' three updates cross the warmup's end.

Tolerances: as tests/test_torch_wilds_iwildcam_ll.py (states 2e-6; SNGP's
precision 3e-3 and Adam moments 1e-4 of their largest entries, one element
in a hundred free; Laplace's factor A 1e-4 of its largest entry; metrics
1e-5)."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name,extra", [("LL_iVON", {}), ("SNGP", {}), ("Laplace", {}),
                                        ("LL_iVON", {"warmup_steps": 2})],
                         ids=["LL_iVON", "SNGP", "Laplace", "LL_iVON-warmup2"])
def test_rxrx1_row_matches_jax(name, extra, monkeypatch):
    check_row("rxrx1", {**yaml_row("rxrx1", name), **extra}, monkeypatch)
