"""PyTorch port, experiments/wilds_task.py: the MAP, MCD and SWAG_LL rows
of ``configs/rxrx1.yaml`` (ResNet-50, Adam at lr 1e-4 under
``cosine_warmup``, the linear warmup and cosine decay stepped per batch,
1139 classes) held against the JAX package's engine on the CPU
(``_torch_wilds_parity.check_row``): ``build`` from JAX's initial state,
three ``train`` updates and ``eval_task`` with JAX's draws given, at the
engine's tiny ResNet-50 (stage sizes (1, 1)) on 32x32 crops, both engines'
ResNet-50 under swish (``swish_resnets``). The cut's one epoch of three
steps makes the default ``warmup_steps`` ``3 // 20 = 0``, so MAP also runs
with ``warmup_steps: 2``: its three updates are two of warmup (lr 0, then
lr / 2) and the first of the decay.

Tolerances: every state tensor within 2e-6 after the three updates (a
bottleneck conv's bias, whose gradient is zero in exact arithmetic, within
6 lr); every float metric within 1e-5, relative or absolute."""
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_wilds_parity import check_row, yaml_row

@pytest.mark.parametrize("name,extra", [("MAP", {}), ("MCD", {}), ("SWAG_LL", {}), ("MAP", {"warmup_steps": 2})],
                         ids=["MAP", "MCD", "SWAG_LL", "MAP-warmup2"])
def test_rxrx1_row_matches_jax(name, extra, monkeypatch):
    check_row("rxrx1", {**yaml_row("rxrx1", name), **extra}, monkeypatch)
