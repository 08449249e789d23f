"""PyTorch port, data/cifar.py's CIFAR-10-C and STL-10 loaders and
experiments/cifar.py::run_single with ``configs/cifar.yaml``'s DEFAULT keys
(``corrupted_intensities: [0, 1, 2, 3, 4]`` included), held against the JAX
package on the CPU: the synthetic fallbacks and staged dumps bit-equal, the
layout checks raising where JAX raises, and every split's metrics finite.
The train paths (the epoch runner under ``device_data``, the multi-step
runner under ``scan_steps``) run eagerly here."""
import math
import os

import numpy as np
import pytest
import torch
import yaml

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.data import cifar as jax_data
from beyond_deep_ensembles_tpu_torch import tree
from beyond_deep_ensembles_tpu_torch.data import cifar as data
from beyond_deep_ensembles_tpu_torch.experiments import cifar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _yaml_default():
    with open(os.path.join(ROOT, "configs", "cifar.yaml")) as f:
        blocks = list(yaml.safe_load_all(f))
    return next(b for b in blocks if b["name"] == "DEFAULT")["params"]


@pytest.fixture
def no_data(monkeypatch, tmp_path):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))  # nothing staged there
    return tmp_path


def _equal(got, want):
    """Bit-equal: the same dtype and shape, and a gap of 0 (printed)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert_close(a, b, rtol=0, atol=0)


@pytest.fixture
def small_clean_set(monkeypatch):
    """Both packages' fallback built on a clean test set cut to 64 images:
    its seeds, noise scale, order of types and subsample cut do not depend on
    the clean set's size, and 3 x 64 noise images draw in milliseconds where
    3 x 10,000 take seconds in each package."""
    for module in (data, jax_data):
        full = module.load_cifar10
        monkeypatch.setattr(module, "load_cifar10", lambda train, seed=0, _full=full, **kw: _full(train, subsample=64, seed=seed))


@pytest.mark.parametrize("intensity", range(5))
def test_corrupted_fallback_bit_equal(no_data, small_clean_set, intensity):
    """The synthetic fallback (clean test set + 0.1 (i + 1) noise over three
    corruption types, RandomState(seed + 100 + i)), whole and subsampled:
    within the first type, across the first two and across all three (the
    port draws only the rows it keeps)."""
    ref = jax_data.load_cifar10_corrupted(intensity)
    whole = data.load_cifar10_corrupted(intensity)
    _equal(whole, ref)
    assert whole[0].shape == (192, 32, 32, 3)
    for sub in (10, 65, 150, 192, 500):
        _equal(data.load_cifar10_corrupted(intensity, subsample=sub), jax_data.load_cifar10_corrupted(intensity, subsample=sub))
    if intensity:
        assert not np.array_equal(whole[0][:10], data.load_cifar10_corrupted(intensity - 1, subsample=10)[0])


def test_corrupted_fallback_full_size_bit_equal(no_data):
    """The fallback as run_single meets it, on the 10,000-image synthetic
    clean set, at one intensity: whole, and subsampled within the first type
    and across all three. The JAX loader subsamples by cutting its whole
    result, so its subsample is the prefix of ``ref``."""
    ref = jax_data.load_cifar10_corrupted(2)
    whole = data.load_cifar10_corrupted(2)
    _equal(whole, ref)
    assert whole[0].shape == (30_000, 32, 32, 3)
    for sub in (1000, 25_000):
        _equal(data.load_cifar10_corrupted(2, subsample=sub), tuple(a[:sub] for a in ref))


def _stage_corrupted(root, rows=20, files=("fog.npy", "snow.npy"), label_rows=None):
    rng = np.random.RandomState(0)
    c = root / "CIFAR-10-C"
    c.mkdir()
    np.save(c / "labels.npy", rng.randint(0, 10, label_rows or rows).astype(np.uint8))
    for name in files:
        np.save(c / name, rng.randint(0, 256, (rows, 32, 32, 3)).astype(np.uint8))
    return c


def test_corrupted_staged_dump_bit_equal(no_data):
    """A staged dump of two corruption files of 5 x 4 rows: each intensity
    selects its block of every file, equal to JAX, with and without
    subsample."""
    _stage_corrupted(no_data)
    for intensity in range(5):
        got = data.load_cifar10_corrupted(intensity)
        _equal(got, jax_data.load_cifar10_corrupted(intensity))
        assert got[0].shape == (8, 32, 32, 3)
    _equal(data.load_cifar10_corrupted(3, subsample=5), jax_data.load_cifar10_corrupted(3, subsample=5))


@pytest.mark.parametrize("layout", ["labels_not_five_blocks", "file_rows_mismatch"])
def test_corrupted_layout_errors(no_data, layout):
    if layout == "labels_not_five_blocks":
        _stage_corrupted(no_data, rows=21)
    else:
        _stage_corrupted(no_data, rows=20, label_rows=25)
    for loader in (data.load_cifar10_corrupted, jax_data.load_cifar10_corrupted):
        with pytest.raises(ValueError, match="CIFAR-10-C"):
            loader(0)


def test_stl10_fallback_and_staged_bit_equal(no_data):
    _equal(data.load_stl10_test(), jax_data.load_stl10_test())
    _equal(data.load_stl10_test(subsample=50, seed=3), jax_data.load_stl10_test(subsample=50, seed=3))
    assert data.load_stl10_test()[0].shape == (2048, 32, 32, 3)
    stl = no_data / "stl10_binary"
    stl.mkdir()
    rng = np.random.RandomState(1)
    rng.randint(0, 256, (6, 3, 96, 96)).astype(np.uint8).tofile(stl / "test_X.bin")
    rng.randint(1, 11, 6).astype(np.uint8).tofile(stl / "test_y.bin")
    staged = data.load_stl10_test()
    _equal(staged, jax_data.load_stl10_test())
    assert staged[0].shape == (6, 32, 32, 3) and staged[1].min() >= 0


def test_corruptions_list():
    assert data.CORRUPTIONS == jax_data.CORRUPTIONS and len(data.CORRUPTIONS) == 15


SMALL = {"subsample": 64, "test_subsample": 30, "epochs": 1, "batch_size": 32, "eval_batch_size": 20,
         "eval_samples": 2}


@pytest.mark.parametrize("model,paths", [
    ("bbb", {}),
    ("svgd", {"device_data": True}),
], ids=["bbb-host-loop", "svgd-epoch-runner"])
def test_run_single_with_yaml_default_keys(no_data, model, paths):
    """The DEFAULT block of configs/cifar.yaml as it is (corrupted
    intensities 0-4), the variant's own keys, cut to a small size: every
    split's metrics finite and in range. BBB takes the host loop and the
    host eval loop; SVGD (2 particles) the epoch runner and the eval runner
    (``device_data`` turns both on)."""
    default = _yaml_default()
    assert default["corrupted_intensities"] == [0, 1, 2, 3, 4]
    variant = {"model": "bbb", "prior_std": 1.0, "weight_decay": 0.0, "bbb_mc_samples": 2,
               "kl_rescaling": 0.2} if model == "bbb" else {"model": "svgd", "svgd_particles": 2}
    res = cifar.run_single({**default, **variant, **SMALL, **paths}, device="cpu")
    assert list(res) == ["test"] + [f"corrupted{i}" for i in range(5)]
    for split, metrics in res.items():
        assert set(metrics) == {"accuracy", "avg_log_likelihood", "avg_likelihood", "ece", "signed_ece"}, split
        assert all(math.isfinite(v) for v in metrics.values()), split
        assert 0.0 <= metrics["accuracy"] <= 1.0 and metrics["avg_log_likelihood"] < 0.0, split


def test_scan_steps_equal_single_steps_on_a_deterministic_run(no_data):
    """SVGD of plain ResNet-20s without augmentation draws no noise, so the
    multi-step path (``scan_steps`` 2 over 5 batches an epoch: two runner
    calls, then one single update) and the one-update-per-call path take
    the same steps: the same particles, bit for bit."""
    config = {**cifar.DEFAULT_CONFIG, "model": "svgd", "svgd_particles": 2, "augment": False, "epochs": 1,
              "batch_size": 8, "dataset_size": 40}
    x, y = data.load_cifar10(True, subsample=40)
    runs = []
    for scan_steps in (1, 2):
        built = cifar.build({**config, "scan_steps": scan_steps}, torch.Generator().manual_seed(0), 5, device="cpu")
        cifar.train(built, {**config, "scan_steps": scan_steps}, x, y)
        assert built.state.step == 5 and int(built.state.opt_state[0].count) == 5
        runs.append(tree.ravel(built.state.params))
    assert torch.equal(runs[0], runs[1])


def test_unported_keys_still_raise(monkeypatch):
    """``data_parallel`` where the process sees a second card and no process
    group raises before any work is done, naming the torchrun line
    (``checkpoint_dir``, ``members`` > 1 and ``use_hmc_baseline`` are
    ported: see test_torch_checkpoint.py, test_torch_cifar_multix.py and
    test_torch_wilson_cifar.py; ``svgd`` with ``members: 2`` builds one
    particle set, as JAX's build ignores ``members`` there)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        cifar.run_single({"model": "bbb", "data_parallel": True}, device="cpu")
    config = {**cifar.DEFAULT_CONFIG, "model": "svgd", "members": 2, "dataset_size": 64}
    built = cifar.build(config, torch.Generator(), 1, device="cpu")
    assert len(built.state.params) == config["svgd_particles"]
