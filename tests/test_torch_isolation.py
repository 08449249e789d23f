"""The PyTorch port stands alone: every module imports with JAX (and
Triton) made unimportable, and none of ``beyond_deep_ensembles_tpu`` is
loaded. Its entry points refuse to run on a missing CUDA device instead of
falling back to the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)

from beyond_deep_ensembles_tpu_torch.experiments import cifar, wilds_task

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["triton"] = None
import beyond_deep_ensembles_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "beyond_deep_ensembles_tpu" or m.startswith("beyond_deep_ensembles_tpu."))
assert not leaked, leaked
assert "jax" not in [m.split(".")[0] for m, v in sys.modules.items() if v is not None]
print(" ".join(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 42  # every module of the slices was imported
    for module in ("parallel", "parallel.multistep", "keys", "utils.optim", "methods.ensemble", "methods.swag",
                   "methods.rings", "utils.checkpoint", "experiments.phases"):
        assert f"beyond_deep_ensembles_tpu_torch.{module}" in names, module


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for model in ("bbb", "svgd"):
        config = {**cifar.DEFAULT_CONFIG, "model": model}
        with pytest.raises(RuntimeError, match="CUDA"):
            cifar.build(config, torch.Generator(), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            cifar.build(config, torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            cifar.run_single({"model": model, "subsample": 8})


def test_wilds_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for model in ("map", "mcd"):
        config = {**wilds_task.DEFAULT_CONFIG, "model": model, "tiny": True}
        with pytest.raises(RuntimeError, match="CUDA"):
            wilds_task.build("amazon", config, torch.Generator(), device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            wilds_task.build("amazon", config, torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA"):
            wilds_task.run_single("amazon", {"model": model, "tiny": True, "subsample": 8})
