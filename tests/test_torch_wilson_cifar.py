"""PyTorch port, CIFAR's ``run_single`` with ``use_hmc_baseline``
(``experiments/cifar.py::hmc_baseline``) held against the JAX package's
``run_single`` (its ``eval_model`` with the Wilson baseline) on the same
state and baseline: a MAP ResNet-20 trained 2 steps from JAX's initial
weights (no augmentation), then given JAX's trained parameters, so the
eval compares one state (the two trained states agree within 5e-4: two
SGD steps at lr 0.05 through 19 FRN layers from the init amplify fp32
gradient differences; the training parity is ``test_torch_cifar_multix.py``'s);
the
Wilson baseline read from pickles written here in the published layout (2
files x 3 chains, ``hmc_samples_per_chain`` 1: the first file's 3 samples,
of which ``eval_samples`` 2 are used), 20 test images in eval batches of 8
(the last padded). Every metric of the clean split, ``hmc_agreement`` and
``hmc_total_variation`` included, within rtol 1e-5, atol 1e-6 of JAX's.
"""
import jax
import numpy as np

from _torch_bnn_parity import jax_inits, to_haiku, write_published
from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax

CONFIG = {"model": "map", "epochs": 1, "subsample": 32, "test_subsample": 20, "batch_size": 16,
          "eval_batch_size": 8, "eval_samples": 2, "augment": False, "use_hmc_baseline": True,
          "hmc_samples_per_chain": 1}


def test_run_single_with_hmc_baseline_matches_jax(tmp_path, monkeypatch):
    inits = [to_haiku(p) for p in jax_inits(3, seed=20)]
    rng = np.random.RandomState(1)
    moved = [jax.tree.map(lambda v: (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32), t) for t in inits]
    write_published(str(tmp_path), [inits, moved])
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))

    jinit, trained = {}, {}
    jax_build, jax_train = jax_cifar.build, jax_cifar.train

    def record_init(*args, **kwargs):
        built = jax_build(*args, **kwargs)
        jinit.update(params_from_jax(jax.tree.map(np.asarray, built.state.params)))
        return built

    def record(built, *args, **kwargs):
        built = jax_train(built, *args, **kwargs)
        trained.update(params_from_jax(jax.tree.map(np.asarray, built.state.params)))
        return built

    monkeypatch.setattr(jax_cifar, "build", record_init)
    monkeypatch.setattr(jax_cifar, "train", record)
    want = jax_cifar.run_single(CONFIG)["test"]

    build_for, train = cifar._build_for, cifar.train

    def from_jax_init(config, device):
        built = build_for(config, device)
        built.state.params.load_state_dict(jinit, strict=True)
        return built

    def to_jax_state(built, *args, **kwargs):
        built = train(built, *args, **kwargs)
        for name, value in built.state.params.state_dict().items():
            assert_close(value.numpy(), trained[name].numpy(), rtol=0, atol=5e-4, err_msg=f"trained {name}")
        built.state.params.load_state_dict(trained, strict=True)
        return built

    monkeypatch.setattr(cifar, "_build_for", from_jax_init)
    monkeypatch.setattr(cifar, "train", to_jax_state)
    got = cifar.run_single(CONFIG, device="cpu")["test"]
    assert got.keys() == want.keys()
    assert {"hmc_agreement", "hmc_total_variation"} <= got.keys()
    for k, w in want.items():
        assert_close(got[k], w, rtol=1e-5, atol=1e-6, err_msg=f"run_single {k}")
    assert 0.0 <= got["hmc_total_variation"] <= 1.0
