"""The PyTorch port stands alone: every module imports with JAX (and
Triton) made unimportable, and none of ``beyond_deep_ensembles_tpu`` is
loaded. Its entry points refuse to run on a missing CUDA device instead of
falling back to the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from beyond_deep_ensembles_tpu_torch.experiments import cifar

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
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every module of the slice was imported


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = {**cifar.DEFAULT_CONFIG, "model": "bbb"}
    with pytest.raises(RuntimeError, match="CUDA"):
        cifar.build(config, torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cifar.build(config, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        cifar.run_single({"model": "bbb", "subsample": 8})
