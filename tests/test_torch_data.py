"""PyTorch port, data/cifar.py + utils/schedules.py + the optimizer of
experiments/cifar.py::_base_tx, held against the JAX package: augment with
the same crop offsets and flip bits, normalize, the synthetic data set
bit-equal, the shuffle against the JAX batch_iter, the Wilson schedule and
the lr each step runs at. Exact where the arithmetic is the same; schedule 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, nchw
from beyond_deep_ensembles_tpu.data import cifar as jax_data
from beyond_deep_ensembles_tpu.utils.schedules import wilson_schedule as jax_wilson
from beyond_deep_ensembles_tpu_torch.data import cifar as data
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.utils.schedules import wilson_schedule


def test_augment_matches_jax_with_same_draws():
    images = np.random.RandomState(0).standard_normal((6, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(7)
    ref = jax_data.augment(key, jnp.asarray(images))
    # the JAX function's own draws (data/cifar.py:224-226)
    k_crop, k_flip = jax.random.split(key)
    offsets = np.asarray(jax.random.randint(k_crop, (6, 2), 0, 9))
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (6,)))
    assert flips.any() and not flips.all()
    got = data.augment(nchw(images), offsets=torch.from_numpy(offsets), flips=torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(), nchw(np.asarray(ref)).numpy())


def test_augment_draws_from_generator():
    images = torch.arange(2 * 3 * 32 * 32, dtype=torch.float32).reshape(2, 3, 32, 32)
    a = data.augment(images, generator=torch.Generator().manual_seed(1))
    b = data.augment(images, generator=torch.Generator().manual_seed(1))
    assert a.shape == images.shape and torch.equal(a, b)
    offsets = torch.full((2, 2), 4)
    centred = data.augment(images, offsets=offsets, flips=torch.tensor([False, True]))
    assert torch.equal(centred[0], images[0])
    assert torch.equal(centred[1], images[1].flip(-1))


def test_normalize_matches_jax():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    f = rng.rand(4, 32, 32, 3).astype(np.float32)
    for a in (u8, f):
        np.testing.assert_array_equal(data.normalize(a), jax_data.normalize(a))


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_cifar_bit_equal(monkeypatch, tmp_path, train):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))  # no CIFAR-10 there
    x, y = data.load_cifar10(train, subsample=300)
    xr, yr = jax_data.load_cifar10(train, subsample=300)
    np.testing.assert_array_equal(x, xr)
    np.testing.assert_array_equal(y, yr)
    assert x.dtype == np.float32 and y.dtype == np.int64 and x.shape == (300, 32, 32, 3)


def test_shuffle_matches_jax_batch_order():
    """Each epoch's batches are the JAX loader's: ``batch_iter`` with the
    epoch's RandomState, taken here as slices of ``shuffled_indices``."""
    x = np.arange(50, dtype=np.float32)[:, None]
    y = np.arange(50)
    seed = 5 * 1_000_003 + 2
    idx = data.shuffled_indices(50, seed)
    ref = list(jax_data.batch_iter(x, y, 16, np.random.RandomState(seed)))
    assert len(ref) == 50 // 16
    for step, (xb, yb) in enumerate(ref):
        sel = idx[step * 16 : (step + 1) * 16]
        np.testing.assert_array_equal(x[sel], xb)
        np.testing.assert_array_equal(y[sel], yb)


@pytest.mark.parametrize("swag_lr", [None, 0.0005])
def test_wilson_schedule_matches_jax(swag_lr):
    port, ref = wilson_schedule(20, 0.05, swag_lr), jax_wilson(20, 0.05, swag_lr)
    for epoch in range(25):
        assert_close(port(epoch), float(ref(epoch)), rtol=1e-6)


def test_base_tx_lr_per_step():
    """optax reads the schedule at its update count before each update."""
    config = {**cifar.DEFAULT_CONFIG, "epochs": 4}
    spe = 3
    optimizer, scheduler = cifar._base_tx(config, spe)([torch.nn.Parameter(torch.zeros(1))])
    factor = jax_wilson(config["epochs"], config["lr"], config["swag_lr"])
    for step in range(4 * spe):
        want = config["lr"] * float(factor(step // spe))
        assert_close(optimizer.param_groups[0]["lr"], want, rtol=1e-6)
        optimizer.step()
        scheduler.step()
    group = optimizer.param_groups[0]
    assert group["nesterov"] and group["momentum"] == 0.9 and group["weight_decay"] == 0.0003
    no_schedule = cifar._base_tx({**config, "lr_schedule": False}, spe)([torch.nn.Parameter(torch.zeros(1))])
    assert no_schedule[1] is None
