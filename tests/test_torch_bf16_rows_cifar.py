"""PyTorch port, experiments/cifar.py at ``bf16: true``: the BBB row of
``configs/cifar.yaml`` (BBB ResNet-20, FRN, swish; K1 on bf16 planes)
held against the JAX package's engine at bf16 on the CPU
(tests/_torch_bf16_rows.py states the holds and their bounds): four SGD
updates from JAX's initial state on JAX's draws, each state leaf no
farther from the port's fp32 update than twice JAX's, and ``eval_model``
from JAX's trained state, every metric within 1e-2."""
import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_bf16_rows import check_cifar_bbb_row


def test_cifar_bbb_bf16_row_matches_jax(monkeypatch):
    check_cifar_bbb_row(monkeypatch)
