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

from beyond_deep_ensembles_tpu_torch.data import wilson
from beyond_deep_ensembles_tpu_torch.experiments import bnn_hmc, cifar, wilds_task
from beyond_deep_ensembles_tpu_torch.models import zoo

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
    assert len(names) >= 82  # every module of the slices was imported (68 before the bnn-hmc slice)
    for module in ("parallel", "parallel.multistep", "keys", "utils.optim", "methods.ensemble", "methods.swag",
                   "methods.rings", "utils.checkpoint", "experiments.phases",
                   # the bnn-hmc subsystem and the utilities
                   "evals.losses", "evals.surface", "evals.plotting", "utils.profiling", "models.lenet",
                   "models.cnn_lstm", "models.zoo", "data.mnist", "data.imdb", "data.wilson", "methods.hmc",
                   "methods.sgmcmc", "methods.vi", "experiments.bnn_hmc"):
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


def test_bnn_hmc_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = zoo.get_model("logistic_regression", 3, in_shape=(4,))
    x, y = torch.zeros((8, 4)), torch.zeros(8, dtype=torch.int64)
    entries = [
        lambda **kw: bnn_hmc.run_hmc(model, (x, y), (x, y), n_iterations=1, **kw),
        lambda **kw: bnn_hmc.run_sgmcmc(model, (x, y), n_epochs=1, batch_size=4, **kw),
        lambda **kw: bnn_hmc.run_sgd(model, (x, y), n_epochs=1, batch_size=4, **kw),
        lambda **kw: bnn_hmc.run_vi(model, (x, y), n_epochs=1, batch_size=4, **kw),
        lambda **kw: wilson.WilsonHMC(**kw),
        lambda **kw: cifar.eval_hmc({"test_subsample": 8, "eval_batch_size": 8}, **kw),
    ]
    for entry in entries:
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cifar.run_single({"model": "map", "subsample": 8, "use_hmc_baseline": True})
