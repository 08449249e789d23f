"""PyTorch port, CIFAR's ``eval_hmc`` (``experiments/cifar.py``: the Wilson
HMC samples themselves through the eval metrics) held against the JAX
package's on pickles written here in the published layout (2 files x 3
chains of JAX ``WilsonResNet20`` trees under haiku's names): 64 images in
2 eval batches of 32, agreement 1.0, total variation 0 and every metric
within rtol 1e-5, atol 1e-6 of JAX's.
"""
import jax
import numpy as np
import pytest

from _torch_bnn_parity import jax_inits, to_haiku, write_published
from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu_torch.experiments import cifar


@pytest.fixture(scope="module")
def samples():
    """Six haiku trees: the three JAX inits, then each perturbed."""
    inits = jax_inits(3)
    rng = np.random.RandomState(0)
    moved = [jax.tree.map(lambda v: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32), p) for p in inits]
    return [to_haiku(p) for p in inits], [to_haiku(p) for p in moved]


def test_eval_hmc_matches_jax(samples, tmp_path, monkeypatch):
    write_published(str(tmp_path), samples)
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    config = {"test_subsample": 64, "eval_batch_size": 32}
    want = jax_cifar.eval_hmc(config)
    got = cifar.eval_hmc(config, device="cpu")
    assert got.keys() == want.keys()
    assert got["hmc_agreement"] == 1.0 and got["hmc_total_variation"] == 0.0
    for k, w in want.items():
        assert_close(got[k], w, rtol=1e-5, atol=1e-6, err_msg=f"eval_hmc {k}")
