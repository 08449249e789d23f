"""PyTorch port, experiments/wilds_task.py at ``compute_dtype: bf16``: the
MAP row of ``configs/poverty.yaml`` held against the JAX package's
engine at bf16 on the CPU (tests/_torch_bf16_rows.py states the holds and
their bounds): three updates from JAX's initial state on JAX's draws, each
state leaf no farther from the reference update than twice JAX's, and
``eval_task`` from JAX's trained state, every metric within 1e-2."""
import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from _torch_bf16_rows import check_wilds_row
from _torch_wilds_parity import yaml_row


def test_poverty_map_bf16_row_matches_jax(monkeypatch):
    check_wilds_row("poverty", yaml_row("poverty", "MAP"), monkeypatch)
