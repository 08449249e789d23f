"""PyTorch port, the CIFAR slice of MAP, MCD, SWAG and BBB with their Multi-X
ensembles as a whole: ``experiments/cifar.py`` ``build`` -> ``train`` ->
``eval_model`` of a 2-member deep ensemble held against the JAX package on
the CPU from the same initial weights; every new row of
``configs/cifar.yaml`` through ``run_single`` (cut in epochs and data size
only); ``multix_phase`` against ``eval_model`` of the same ensemble.

Tolerances: the JAX comparison's metrics within 1e-5, relative for the
log-likelihood (near -2.3) and absolute for accuracy, likelihood and ECE
(near 0.1): one epoch of 4 SGD steps at lr 0.05 and an eval of 4 samples,
sums in other orders (their last digits move with the CPU's thread count);
``multix_phase`` against its own ensemble's ``eval_model``: equal. The rows
share their data sets through a cache (the synthetic splits take most of a
CPU run's time)."""
import functools
import math
from pathlib import Path

import jax
import pytest
import torch
import yaml

from _torch_parity import assert_close, to_numpy_tree
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu_torch.data import cifar as cifar_data
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble
from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
from beyond_deep_ensembles_tpu_torch.models.jax_convert import particles_from_jax
from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

YAML = Path(__file__).resolve().parents[1] / "configs" / "cifar.yaml"
NEW_ROWS = ["MAP", "DeepEnsemble", "SWAG", "MultiSWAG", "MCD", "MultiMCD", "MultiBBB"]
# cut in epochs and data size only: one epoch of 2 steps at batch 16, 10 test
# images per split at S = 2 (SWAG's start epoch cut in proportion, to 0)
CUT = {"epochs": 1, "subsample": 32, "test_subsample": 10, "batch_size": 16, "eval_batch_size": 10,
       "eval_samples": 2}


@pytest.fixture
def cached_data(monkeypatch):
    """The synthetic splits made once for the file (run_single only reads
    them)."""
    for name in ("load_cifar10", "load_cifar10_corrupted"):
        monkeypatch.setattr(cifar_data, name, _CACHED[name])


_CACHED = {name: functools.lru_cache(maxsize=None)(getattr(cifar_data, name))
           for name in ("load_cifar10", "load_cifar10_corrupted")}


def _rows():
    docs = {d["name"]: d.get("params", {}) for d in yaml.safe_load_all(YAML.read_text()) if d}
    return docs["DEFAULT"], docs


def test_map_ensemble_slice_matches_jax():
    """members 2, augmentation off, 64 images (4 steps of 16), S = 4 over
    24 test images at eval batch 10 (the last batch padded): the port from
    JAX's initial weights, both trained and evaluated by their
    ``train`` / ``eval_model`` (host loops, the same shuffle)."""
    config = {**jax_cifar.DEFAULT_CONFIG, "model": "map", "members": 2, "augment": False, "epochs": 1,
              "subsample": 64, "test_subsample": 24, "batch_size": 16, "eval_batch_size": 10, "eval_samples": 4}
    config, (x, y), (xt, yt) = cifar._load_data(config)
    jbuilt = jax_cifar.build(config, jax.random.key(config["seed"]), 4)
    built = cifar.build(config, torch.Generator().manual_seed(0), 4, device="cpu")
    for member, state_dict in zip(built.state.members, particles_from_jax(to_numpy_tree(jbuilt.state.params))):
        member.params.load_state_dict(state_dict, strict=True)

    jbuilt = jax_cifar.train(jbuilt, config, x, y)
    want = jax_cifar.eval_model(jbuilt, config, xt, yt).as_dict()
    built = cifar.train(built, config, x, y)
    got = cifar.eval_model(built, {**config, "device_eval": False}, xt, yt).as_dict()
    runner = cifar.eval_model(built, {**config, "device_eval": True}, xt, yt).as_dict()
    assert got.keys() == want.keys() and runner == got
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("row", NEW_ROWS)
def test_new_rows_run_single_on_cpu(row, cached_data):
    default, rows = _rows()
    config = {**default, **rows[row], **CUT}
    if "swag_start_epoch" in config:
        config["swag_start_epoch"] = 0
    res = cifar.run_single(config, device="cpu")
    assert list(res) == ["test"] + [f"corrupted{i}" for i in default["corrupted_intensities"]]
    for split, metrics in res.items():
        assert all(math.isfinite(v) for v in metrics.values()), (split, metrics)
        assert 0.0 <= metrics["accuracy"] <= 1.0 and metrics["avg_log_likelihood"] < 0.0


def test_multix_phase_equals_eval_of_the_ensemble(tmp_path, cached_data):
    """Three MAP runs save their finals; ``multix_phase`` with leave_out 0
    gives the metrics of ``eval_model`` over a deep_ensemble of the other
    two states."""
    default, rows = _rows()
    dirs = [str(tmp_path / f"rep_{i}") for i in range(3)]
    for seed, d in enumerate(dirs):
        cifar.run_single({**rows["MAP"], **CUT, "seed": seed, "checkpoint_dir": d}, device="cpu")
    config = {**rows["MAP"], **CUT}
    got = cifar.multix_phase(config, dirs, leave_out=0, device="cpu")

    config, built, _, (xt, yt) = cifar._rebuild(config, "cpu")
    states = []
    for d in dirs[1:]:
        state = cifar._build_for(config, "cpu").state
        states.append(ckpt.restore_final(d, "map", state))
    built.method, built.state = deep_ensemble(built.method, 2), EnsembleState(states)
    want = cifar.eval_model(built, config, xt, yt).as_dict()
    assert got == {"test": want}


def test_unported_options_raise(monkeypatch):
    """Every model of configs/cifar.yaml is ported, and the bf16 key and
    the HMC baseline with them (tests/test_torch_bf16_cli_cifar.py,
    tests/test_torch_wilson_cifar.py: ``build`` takes ``use_hmc_baseline``,
    which only ``run_single`` reads); data parallelism where the process
    sees a second card and no process group (on one card it is a no-op,
    under a group the mesh path) raises, naming the torchrun line, before
    any work is done, in ``build`` and in the phases."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    base = {**cifar.DEFAULT_CONFIG, "dataset_size": 64}
    for model in ("map", "laplace", "ivon", "rank1", "sngp"):
        with pytest.raises(RuntimeError, match="data_parallel.*torchrun"):
            cifar.build({**base, "model": model, "data_parallel": True}, torch.Generator(), device="cpu")
        cifar.build({**base, "model": model, "use_hmc_baseline": True}, torch.Generator(), device="cpu")
    with pytest.raises(ValueError):
        cifar.build({**base, "model": "nope"}, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="data_parallel.*torchrun"):
        cifar.fit_laplace_phase({"data_parallel": True}, "unused", device="cpu")
