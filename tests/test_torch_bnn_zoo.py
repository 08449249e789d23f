"""PyTorch port, the bnn-hmc model zoo and data, held against the JAX
package:

* every ``get_model`` name (``models/zoo.py``) builds the module whose state
  dict the converted JAX parameters (``models/jax_convert.py::
  model_params_from_jax``) fill exactly, and its logits agree within rtol
  1e-5, atol 1e-5 (JAX's side jitted); an unknown name raises JAX's
  ``ValueError`` text, and an MLP without ``in_shape`` says so;
* ``data/mnist.py`` on idx files written here (plain and gz), the synthetic
  and FashionMNIST paths, MedMNIST (a staged npz and the fallback) and
  MNIST-C's fallback; ``data/imdb.py``'s cache round trip, fallback and
  schema errors: equal, array for array.
"""
import gzip
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.data import imdb as jax_imdb
from beyond_deep_ensembles_tpu.data import mnist as jax_mnist
from beyond_deep_ensembles_tpu.models import zoo as jax_zoo
from beyond_deep_ensembles_tpu_torch.data import imdb, mnist
from beyond_deep_ensembles_tpu_torch.models import zoo
from beyond_deep_ensembles_tpu_torch.models.jax_convert import model_params_from_jax

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _port_input(x):
    x = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if x.ndim == 4:
        return t.permute(0, 3, 1, 2).contiguous()
    return t if x.dtype.kind == "f" else t.long()


ZOO = [
    ("lenet", {}, (2, 28, 28, 1)),
    ("resnet20_frn", {}, (2, 32, 32, 3)),
    ("resnet20_frn_swish", {}, (2, 32, 32, 3)),
    ("cnn_lstm", {"max_features": 300, "embedding_size": 8, "cell_size": 8, "num_filters": 8}, (2, 20)),
    ("smooth_cnn_lstm", {"max_features": 300, "embedding_size": 8, "cell_size": 8, "num_filters": 8}, (2, 20)),
    ("mlp_regression", {}, (3, 6)),
    ("mlp_regression_small", {}, (3, 6)),
    ("mlp_classification", {}, (3, 4, 4, 2)),
    ("logistic_regression", {}, (3, 5)),
]


@pytest.mark.parametrize("name,kw,shape", ZOO, ids=[z[0] for z in ZOO])
def test_get_model_names_match_jax(name, kw, shape):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 300, shape).astype(np.int32) if "lstm" in name else rng.standard_normal(shape).astype(
        np.float32)
    jmodel = jax_zoo.get_model(name, num_classes=10, **kw)
    params, state = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
    want, _, _ = jax.jit(lambda p, xb: jmodel.apply(p, state, None, xb, train=False, mutable_state=False))(
        params, jnp.asarray(x))
    model = zoo.get_model(name, num_classes=10, in_shape=shape[1:], generator=torch.Generator().manual_seed(0),
                          **kw)
    model.module.load_state_dict(model_params_from_jax(model.module, params), strict=True)
    with torch.no_grad():
        got, _, _ = model.apply(model.module, {}, None, _port_input(x), train=False)
    assert_close(got.numpy(), np.asarray(want), **TOL, err_msg=f"get_model {name}")


def test_get_model_unknown_name_raises_as_jax():
    with pytest.raises(ValueError) as want:
        jax_zoo.get_model("nope")
    with pytest.raises(ValueError) as got:
        zoo.get_model("nope")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="in_shape"):
        zoo.get_model("mlp_regression")


def _write_idx(path, arr, gz):
    data = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_mnist_loaders_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    # nothing staged: the synthetic stand-ins (MNIST, FashionMNIST, MNIST-C, MedMNIST)
    _equal(mnist.load_mnist(True, subsample=64), jax_mnist.load_mnist(True, subsample=64))
    _equal(mnist.load_mnist(False, fashion=True, seed=3), jax_mnist.load_mnist(False, fashion=True, seed=3))
    _equal(mnist.load_corrupted_mnist(subsample=32), jax_mnist.load_corrupted_mnist(subsample=32))
    for subset in ("pathmnist", "octmnist"):
        _equal(mnist.load_medmnist(subset, "test", subsample=16), jax_mnist.load_medmnist(subset, "test", subsample=16))

    rng = np.random.RandomState(0)
    for name, gz in (("mnist", False), ("fashion_mnist", True)):
        os.makedirs(tmp_path / name)
        ext = ".gz" if gz else ""
        for prefix, n in (("train", 20), ("t10k", 12)):
            _write_idx(tmp_path / name / f"{prefix}-images-idx3-ubyte{ext}",
                       rng.randint(0, 256, (n, 28, 28)).astype(np.uint8), gz)
            _write_idx(tmp_path / name / f"{prefix}-labels-idx1-ubyte{ext}",
                       rng.randint(0, 10, n).astype(np.uint8), gz)
    for train in (True, False):
        for fashion in (False, True):
            got = mnist.load_mnist(train, fashion=fashion, subsample=10)
            _equal(got, jax_mnist.load_mnist(train, fashion=fashion, subsample=10))
            assert got[0].shape == (10, 28, 28, 1)
    np.savez(tmp_path / "medmnist_dermamnist.npz")  # a file beside the folder is ignored
    os.makedirs(tmp_path / "medmnist")
    np.savez(tmp_path / "medmnist" / "dermamnist.npz", train_images=rng.randint(0, 256, (9, 28, 28, 3)).astype(
        np.uint8), train_labels=rng.randint(0, 7, (9, 1)))
    _equal(mnist.load_medmnist("dermamnist"), jax_mnist.load_medmnist("dermamnist"))


def test_imdb_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    for split in ("train", "test"):
        _equal(imdb.load_imdb(split), jax_imdb.load_imdb(split))
    _equal(imdb.load_imdb("train", subsample=0.25), jax_imdb.load_imdb("train", subsample=0.25))

    rng = np.random.RandomState(1)
    xtr, xte = rng.randint(0, 20000, (12, 100)), rng.randint(0, 20000, (5, 100))
    ytr, yte = rng.randint(0, 2, 12), rng.randint(0, 2, 5)
    path = imdb.write_imdb_cache(xtr, ytr, xte, yte)
    assert path == str(tmp_path / "imdb.npz")
    for split in ("train", "test"):
        _equal(imdb.load_imdb(split, subsample=4), jax_imdb.load_imdb(split, subsample=4))
    other = tmp_path / "jax"
    jax_imdb.write_imdb_cache(xtr, ytr, xte, yte, root=str(other))
    with np.load(path) as a, np.load(other / "imdb.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    for bad in (np.zeros((3, 99)), np.full((3, 100), 20000)):
        with pytest.raises(ValueError) as want:
            jax_imdb.write_imdb_cache(bad, [0] * 3, xte, yte, root=str(other))
        with pytest.raises(ValueError) as got:
            imdb.write_imdb_cache(bad, [0] * 3, xte, yte)
        assert str(got.value) == str(want.value)
