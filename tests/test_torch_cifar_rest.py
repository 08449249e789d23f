"""PyTorch port, the rest of CIFAR: the ``Rank1``, ``iVON``, ``MultiiVON``,
``SNGP``, ``Laplace`` and ``MultiLaplace`` rows of ``configs/cifar.yaml``
through ``experiments/cifar.py``, on the CPU:

  * ``build`` -> ``train`` -> ``eval_model`` of ``rank1`` (4 steps at batch
    16, 24 test images at S = 4, augmentation off) held against the JAX
    package from JAX's initial weights, with JAX's draws given
    (``_torch_parity.run_both``); ``ivon``, ``sngp`` and ``laplace`` are held
    the same way in their own files, so that the JAX compiles spread over
    the suite's workers;
  * every new row through ``run_single`` (cut in epochs and data size only)
    on the host loop and on the runners (``device_data``);
  * ``fit_laplace_phase`` from a saved ``map_final`` against the Laplace
    row's fit and eval of the same state.

Tolerances: the JAX comparison's metrics within 1e-5, relative for the
log-likelihood and absolute for the rest (as ``test_torch_cifar_multix``);
``fit_laplace_phase`` against its own eval: equal. The rank-1 run takes one
MC sample a step (the jitted JAX step compiles in half the time; two samples
a step are held in ``test_torch_rank1.py``)."""
import functools
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_parity import PARITY, assert_close, one_cpu_thread, record_jax_normals, run_both  # noqa: F401
from beyond_deep_ensembles_tpu.nn import rank1 as jax_rank1
from beyond_deep_ensembles_tpu_torch.data import cifar as cifar_data
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
from beyond_deep_ensembles_tpu_torch.methods.laplace import LaplaceState
from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

YAML = Path(__file__).resolve().parents[1] / "configs" / "cifar.yaml"
NEW_ROWS = ["Rank1", "iVON", "MultiiVON", "SNGP", "Laplace", "MultiLaplace"]
# cut in epochs and data size only: one epoch of 2 steps at batch 16, 10 test
# images per split at S = 2 (SNGP's row keeps its S = 1); members cut to 2
CUT = {"epochs": 1, "subsample": 32, "test_subsample": 10, "batch_size": 16, "eval_batch_size": 10,
       "eval_samples": 2}

_CACHED = {name: functools.lru_cache(maxsize=None)(getattr(cifar_data, name))
           for name in ("load_cifar10", "load_cifar10_corrupted")}


@pytest.fixture
def cached_data(monkeypatch):
    """The synthetic splits made once for the file (run_single only reads
    them)."""
    for name, fn in _CACHED.items():
        monkeypatch.setattr(cifar_data, name, fn)


def _rows():
    docs = {d["name"]: d.get("params", {}) for d in yaml.safe_load_all(YAML.read_text()) if d}
    return docs["DEFAULT"], docs


def _batches_of(draws, per_batch):
    assert len(draws) % per_batch == 0, (len(draws), per_batch)
    return [draws[i : i + per_batch] for i in range(0, len(draws), per_batch)]


def test_rank1_build_train_eval_matches_jax(monkeypatch):
    """``rank1`` (4 components, mc 1): the steps' components from the
    update counter, eval sample i on the joint component i % 4."""
    record_jax_normals(monkeypatch, jax_rank1)
    config = {**PARITY, "model": "rank1", "prior_std": 0.1, "bbb_mc_samples": 1}
    sites, s = 44, PARITY["eval_samples"]

    def to_port(train, evals, module):
        del module
        out = list(train)
        for batch in _batches_of(evals, sites * s):  # JAX's vmap: the samples of a site together
            out += [batch[site * s + i] for i in range(s) for site in range(sites)]
        return [torch.from_numpy(d) for d in out]

    want, got, _, built = run_both(config, monkeypatch, to_port)
    assert int(built.state.updates) == 4
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("device_data", [False, True], ids=["host_loop", "runners"])
@pytest.mark.parametrize("row", NEW_ROWS)
def test_new_rows_run_single_on_cpu(row, device_data, cached_data):
    default, rows = _rows()
    config = {**default, **rows[row], **CUT, "device_data": device_data}
    if config.get("members", 1) > 1:
        config["members"] = 2
    if row == "SNGP":
        config["eval_samples"] = rows[row]["eval_samples"]
    res = cifar.run_single(config, device="cpu")
    assert list(res) == ["test"] + [f"corrupted{i}" for i in default["corrupted_intensities"]]
    for split, metrics in res.items():
        assert all(math.isfinite(v) for v in metrics.values()), (split, metrics)
        assert 0.0 <= metrics["accuracy"] <= 1.0 and metrics["avg_log_likelihood"] < 0.0


@pytest.mark.parametrize("members", [1, 2], ids=["Laplace", "MultiLaplace"])
def test_fit_laplace_phase_equals_the_rows_fit(members, tmp_path, cached_data):
    """A MAP run saves ``map_final``; ``fit_laplace_phase`` restores it into
    a fresh build, fits the last-layer posterior on the training split and
    evaluates the test split: equal to ``eval_model`` of the ``laplace``
    row's build with the same state restored and fitted (with two members a
    ``deep_ensemble`` of the fitted members)."""
    _, rows = _rows()
    base = {**CUT, "members": members, "corrupted_intensities": []}
    cifar.run_single({**rows["MAP"], **base, "members": members, "checkpoint_dir": str(tmp_path)}, device="cpu")
    lines = []
    got = cifar.fit_laplace_phase({**base, "ll_hessian": "full"}, str(tmp_path), log=lines.append, device="cpu")
    assert lines and lines[0].startswith("fit_laplace: prior_prec=")

    config, built, (x, y), (xt, yt) = cifar._rebuild({**rows["Laplace"], **base}, "cpu")
    built.state = ckpt.restore_final(str(tmp_path), "map", built.state)
    cifar._fit_laplace(built, config, x, y)
    fitted = built.state.members if members > 1 else [built.state]
    assert all(isinstance(s, LaplaceState) for s in fitted) and isinstance(built.state, EnsembleState) == (members > 1)
    assert got == {"test": cifar.eval_model(built, config, xt, yt).as_dict()}
