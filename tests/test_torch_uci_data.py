"""PyTorch port, ``data/uci.py`` held against the JAX package's
``data/uci.py`` on the CPU: every split of ``UCIDataset`` (``train``,
``test``, ``val_train`` at two ``val_percentage``, ``val_test``, and each gap
split of yacht, its training arrays from the first shuffle and its test
arrays from the second, as ``run_single`` draws them), from the synthetic
stand-in of each data set and from a staged ``$BDE_DATA_DIR/uci/<name>.npz``;
the normalization statistics; ``batch_iter``'s order and its wrapped last
batch. Plain numpy on both sides: everything must be equal."""
import numpy as np
import pytest

from beyond_deep_ensembles_tpu.data import uci as jax_uci_data
from beyond_deep_ensembles_tpu_torch.data import uci as uci_data

SPLITS = ("train", "test", "val_train", "val_test")


def _assert_same(mine: uci_data.UCIDataset, ref, gap=None):
    for split in SPLITS:
        for a, b in zip(mine.get_arrays(split, gap), ref.get_arrays(split, gap)):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), (split, gap)
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name


@pytest.mark.parametrize("name", sorted(uci_data.UCI_SHAPES))
def test_synthetic_splits_equal_jax(name):
    assert uci_data.UCI_SHAPES[name] == jax_uci_data.UCI_SHAPES[name]
    for val_percentage in (1.0, 0.5):
        mine = uci_data.UCIDataset(name, val_percentage=val_percentage)
        ref = jax_uci_data.UCIDataset(name, val_percentage=val_percentage)
        assert mine.in_dim == ref.in_dim == uci_data.UCI_SHAPES[name][0]
        _assert_same(mine, ref)
    mine = uci_data.UCIDataset(name, normalize=False, split=3)
    ref = jax_uci_data.UCIDataset(name, normalize=False, split=3)
    _assert_same(mine, ref)


def test_gap_splits_of_yacht_equal_jax():
    """Each dimension's gap split as ``run_single`` takes it: the training
    arrays from one call, the test arrays from the next, on one data set
    whose shuffle moves on at every call (so the second call's order
    differs from the first's)."""
    mine, ref = uci_data.UCIDataset("yacht"), jax_uci_data.UCIDataset("yacht")
    for dim in range(mine.in_dim):
        for split in ("train", "test", "val_train", "val_test"):
            for a, b in zip(mine.get_arrays(split, dim), ref.get_arrays(split, dim)):
                assert np.array_equal(a, b), (dim, split)
    fresh = uci_data.UCIDataset("yacht")
    first, second = fresh.get_arrays("test", 0)[0], fresh.get_arrays("test", 0)[0]
    assert not np.array_equal(first, second) and np.array_equal(np.sort(first, 0), np.sort(second, 0))


def test_staged_npz_equals_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(5)
    x = rng.standard_normal((137, 4)) * [1.0, 3.0, 0.0, 2.0] + 1.0  # a constant column: std taken as 1
    y = rng.standard_normal(137) * 4.0 + 2.0  # 1-D: the loader makes it [n, 1]
    (tmp_path / "uci").mkdir()
    np.savez(tmp_path / "uci" / "power.npz", x=x, y=y)
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    mine, ref = uci_data.UCIDataset("power"), jax_uci_data.UCIDataset("power")
    assert mine.x_train.shape == (124, 4) and mine.y_test.shape == (13, 1)
    assert mine.x_std[2] == 1.0
    _assert_same(mine, ref)
    for dim in range(4):
        _assert_same(mine, ref, gap=dim)


@pytest.mark.parametrize("n, batch, drop", [(100, 32, False), (100, 32, True), (64, 16, False), (5, 8, False)])
def test_batch_iter_equals_jax(n, batch, drop):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.float32).reshape(n, 1)
    for rng in (None, 7):
        mine = list(uci_data.batch_iter(x, y, batch, None if rng is None else np.random.RandomState(rng), drop))
        ref = list(jax_uci_data.batch_iter(x, y, batch, None if rng is None else np.random.RandomState(rng), drop))
        assert len(mine) == len(ref) == (n // batch if drop else -(-n // batch))
        for (a, b), (c, d) in zip(mine, ref):
            assert np.array_equal(a, c) and np.array_equal(b, d) and a.shape == (batch, 3)
    # the last batch wraps to the permutation's first rows
    rows = list(uci_data.batch_indices(n, batch, np.random.RandomState(7)))
    perm = np.random.RandomState(7).permutation(n)
    if n % batch and not drop:
        assert np.array_equal(rows[-1][n % batch :], perm[: batch - n % batch])


def test_batch_order_shared_across_epochs():
    """One ``RandomState`` drives every epoch, as ``train`` holds it: the
    second epoch's order is the generator's next permutation."""
    rng = np.random.RandomState(0)
    first = np.concatenate(list(uci_data.batch_indices(50, 10, rng)))
    second = np.concatenate(list(uci_data.batch_indices(50, 10, rng)))
    check = np.random.RandomState(0)
    assert np.array_equal(first, check.permutation(50)) and np.array_equal(second, check.permutation(50))
