"""PyTorch port, the Wilson et al. HMC baseline (``data/wilson.py``) and
CIFAR's ``eval_hmc``, held against the JAX package on pickles written here:
three JAX ``WilsonResNet20`` initializations renamed to haiku's names
(``conv2_d{,_i}``, ``frn{,_i}`` with (1, 1, 1, C) leaves, ``linear``; some
keys behind a ``res_net/~/`` prefix) stand for the three chains:

* ``convert_wilson_sample`` equals JAX's, leaf for leaf (exactly), and keys
  on names (two same-shaped FRN modules swapped in the source swap in the
  result);
* the published layout (``wilson_hmc/cifar10/state-<i>.pkl``, 2 files x 3
  chains on a leading axis): ``n_samples`` 6, file-major chain-minor order,
  ``infer`` (all samples and the first 4) and ``log_marginal`` on 8 images
  within rtol 1e-5, atol 1e-5 of JAX's; ``max_samples_per_chain`` 1 keeps
  the first file's 3; the legacy ``wilson_hmc/chain<k>/`` layout loads in
  JAX's order;
* a pickle that needs a ``jax`` class raises, naming the class and the
  file; with nothing staged the fallback holds 4 samples of the template's
  shapes within a few 0.05-sigma draws of the seed's init.

``eval_hmc``: ``test_torch_wilson_eval.py``; ``run_single`` with
``use_hmc_baseline``: ``test_torch_wilson_cifar.py``.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bnn_parity import jax_inits, to_haiku, write_published
from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.data import wilson as jax_wilson
from beyond_deep_ensembles_tpu_torch.data import wilson
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import WilsonResNet20

TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module")
def samples():
    """Six haiku trees: the three JAX inits, then each perturbed."""
    inits = jax_inits(3)
    rng = np.random.RandomState(0)
    moved = [jax.tree.map(lambda v: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32), p) for p in inits]
    return [to_haiku(p) for p in inits], [to_haiku(p) for p in moved]


def test_convert_wilson_sample_matches_jax(samples):
    template = jax_inits(1, seed=9)[0]
    module = WilsonResNet20(10, generator=torch.Generator().manual_seed(0))
    for hk in samples[0][:2]:
        want = params_from_jax(jax.tree.map(np.asarray, jax_wilson.convert_wilson_sample(hk, template)))
        got = wilson.convert_wilson_sample(hk, module)
        assert got.keys() == want.keys() == module.state_dict().keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    hk = dict(samples[0][0])
    k1, k2 = (next(k for k in hk if k.split("/")[-1] == name) for name in ("frn_1", "frn_2"))
    hk[k1], hk[k2] = hk[k2], hk[k1]
    swapped = wilson.convert_wilson_sample(hk, module)
    plain = wilson.convert_wilson_sample(samples[0][0], module)
    assert torch.equal(swapped["frn_1.tau"], plain["frn_2.tau"])
    assert torch.equal(swapped["frn_2.beta"], plain["frn_1.beta"])
    with pytest.raises(ValueError, match="unexpected scope"):
        wilson.convert_wilson_sample(samples[0][0], {"head.kernel": torch.zeros(1)})


def test_published_layout_matches_jax(samples, tmp_path, monkeypatch):
    write_published(str(tmp_path), samples)
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    want_hmc = jax_wilson.WilsonHMC()
    hmc = wilson.WilsonHMC(device="cpu")
    assert hmc.n_samples == want_hmc.n_samples == 6
    x = np.random.RandomState(3).standard_normal((8, 32, 32, 3)).astype(np.float32)
    want = np.asarray(want_hmc.infer(x))
    got = hmc.infer(x)
    assert got.shape == (6, 8, 10)
    assert_close(got.numpy(), want, **TOL, err_msg="infer")
    assert_close(hmc.infer(x, 4).numpy(), want[:4], **TOL, err_msg="infer, 4 samples")
    assert_close(hmc.log_marginal(x).numpy(), np.asarray(want_hmc.log_marginal(x)), **TOL, err_msg="log_marginal")
    assert_close(hmc.log_marginal(x, 4).numpy(), np.asarray(want_hmc.log_marginal(x, 4)), **TOL,
                 err_msg="log_marginal, 4 samples")
    # file-major, chain-minor: sample 4 is file 1's chain 1
    module = WilsonResNet20(10, generator=torch.Generator().manual_seed(0))
    module.load_state_dict(wilson.convert_wilson_sample(samples[1][1], module))
    with torch.no_grad():
        one = torch.log_softmax(module(torch.from_numpy(x).permute(0, 3, 1, 2)), -1)
    torch.testing.assert_close(got[4], one, rtol=1e-6, atol=1e-6)
    first = wilson.WilsonHMC(max_samples_per_chain=1, device="cpu")
    assert first.n_samples == 3
    torch.testing.assert_close(first.infer(x), got[:3], rtol=0, atol=0)


def test_legacy_layout_and_refusals(samples, tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    for k, trees in enumerate((samples[0][:2], samples[1][:1])):
        d = tmp_path / "wilson_hmc" / f"chain{k}"
        os.makedirs(d)
        for i, tree in enumerate(trees):
            with open(d / f"sample{i}.pkl", "wb") as f:
                pickle.dump({"params": tree} if i == 0 else tree, f)
    hmc = wilson.WilsonHMC(device="cpu")
    assert hmc.n_samples == jax_wilson.WilsonHMC().n_samples == 3
    module = WilsonResNet20(10, generator=torch.Generator().manual_seed(0))
    for i, tree in enumerate((samples[0][0], samples[0][1], samples[1][0])):
        want = wilson.convert_wilson_sample(tree, module)
        for name, stacked in hmc._stacked.items():
            assert torch.equal(stacked[i], want[name]), (i, name)

    bad = tmp_path / "bad"
    os.makedirs(bad / "wilson_hmc" / "cifar10")
    path = bad / "wilson_hmc" / "cifar10" / "state-0.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": {"linear": {"w": jnp.zeros((64, 10))}}}, f)
    monkeypatch.setenv("BDE_DATA_DIR", str(bad))
    with pytest.raises(pickle.UnpicklingError) as err:
        wilson.WilsonHMC(device="cpu")
    assert str(path) in str(err.value) and "jax" in str(err.value)

    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path / "empty"))
    fallback = wilson.WilsonHMC(seed=4, device="cpu")
    assert fallback.n_samples == 4
    init = WilsonResNet20(10, generator=torch.Generator().manual_seed(4)).state_dict()
    for name, stacked in fallback._stacked.items():
        assert stacked.shape == (4,) + tuple(init[name].shape)
        assert float((stacked - init[name]).abs().max()) < 0.05 * 6
    assert 0.04 < float((fallback._stacked["conv_3.kernel"] - init["conv_3.kernel"]).std()) < 0.06
