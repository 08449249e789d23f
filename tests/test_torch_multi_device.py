"""PyTorch port, utils/device.py::refuse_multi_device: ``data_parallel`` and
``ring_shard`` on one device. The JAX package gates every use of them on
``jax.device_count() > 1``, so on one device a flagged row is the unflagged
row; the port, which has no mesh yet, does the same and raises where the
process sees more than one card (ROADMAP item 18).

In CIFAR, UCI and WILDS: a flagged tiny row equals the unflagged one on the
port bit for bit (state and metrics, one seed, one key), and the flagged
port row matches the JAX engine's unflagged row in that engine's parity
harness, at its tolerances (CIFAR and UCI: parameters and metrics within
1e-5; WILDS: ``_torch_wilds_parity.check_row``). Under tests/conftest.py JAX
sees 8 virtual CPU devices, where its flagged row would shard: JAX's own
tests/test_engine_parallel.py holds that equal to the unflagged row."""
import pytest
import torch

import _torch_uci_parity
from _torch_parity import PARITY, assert_close, run_both
from _torch_wilds_parity import check_row, yaml_row
from beyond_deep_ensembles_tpu_torch.experiments import cifar, uci, wilds_task
from beyond_deep_ensembles_tpu_torch.utils.device import device_count, refuse_multi_device

def _flagged(monkeypatch, module, names, **flags):
    """The port's ``module.<names>`` run with ``flags`` set in their config."""
    for name in names:
        real = getattr(module, name)

        def wrapped(*args, _real=real, **kwargs):
            args = list(args)
            i = next(i for i, a in enumerate(args) if isinstance(a, dict))
            args[i] = {**args[i], **flags}
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)


def test_one_device_is_what_the_cpu_sees(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert device_count() == 1
    refuse_multi_device({"data_parallel": True, "ring_shard": True})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    refuse_multi_device({"data_parallel": True, "ring_shard": True})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    refuse_multi_device({"data_parallel": False})
    for flag in ("data_parallel", "ring_shard"):
        with pytest.raises(NotImplementedError, match="item 18"):
            refuse_multi_device({flag: True})


def _cifar_run(flags):
    config = {**cifar.DEFAULT_CONFIG, **PARITY, "model": "map", "subsample": 32, "test_subsample": 10, **flags}
    config, (x, y), (xt, yt) = cifar._load_data(config)
    built = cifar.build(config, torch.Generator().manual_seed(0), x.shape[0] // config["batch_size"], device="cpu")
    built = cifar.train(built, config, x, y)
    return built.state.state_dict(), cifar.eval_model(built, {**config, "device_eval": False}, xt, yt).as_dict()


def test_cifar_flagged_row_is_the_unflagged_row(monkeypatch):
    state, metrics = _cifar_run({})
    got_state, got_metrics = _cifar_run({"data_parallel": True})
    assert got_state.keys() == state.keys()
    assert all(torch.equal(got_state[k], v) for k, v in state.items())
    assert got_metrics == metrics
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="data_parallel"):
        _cifar_run({"data_parallel": True})


def test_cifar_flagged_row_matches_jax(monkeypatch):
    _flagged(monkeypatch, cifar, ("build", "train"), data_parallel=True)
    want, got, _, _ = run_both({**PARITY, "model": "map"}, monkeypatch, lambda train, evals, module: [])
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _uci_run(flags):
    config = _torch_uci_parity.config_for("map", **flags)
    _, (x, y), _ = _torch_uci_parity._arrays()
    built = uci.build(config, x.shape[0], torch.Generator().manual_seed(0), device="cpu")
    return uci.train(built, config, x, y, seed=0).state.state_dict()


def test_uci_flagged_row(monkeypatch):
    """The flagged port row equals the unflagged one bit for bit, and
    matches JAX's unflagged row (``check_matches_jax``'s parameters and
    metrics within 1e-5)."""
    state, got = _uci_run({}), _uci_run({"data_parallel": True})
    assert all(torch.equal(got[k], v) for k, v in state.items())
    _flagged(monkeypatch, uci, ("train",), data_parallel=True)
    _torch_uci_parity.check_matches_jax("map", monkeypatch)


def _wilds_run(task, flags):
    row = {**yaml_row(task, "SWAG"), "swag_start_epoch": 0, "swag_updates": 3}
    config = {**wilds_task.DEFAULT_CONFIG, **row, "tiny": True, "subsample": 12, "test_subsample": 6, "epochs": 1,
              "batch_size": 4, "eval_batch_size": 4, "eval_samples": 2, **flags}
    if task == "amazon":
        config["bert_config"] = {"vocab_size": 1024, "dim": 32, "n_layers": 1, "n_heads": 2, "hidden_dim": 64,
                                 "max_position_embeddings": 512}
    config, built, (x, y), test = wilds_task._rebuild(task, config, device="cpu")
    built = wilds_task.train(built, config, x, y)
    metrics = wilds_task.eval_task(built, task, {**config, "device_eval": False}, *test)
    return built.state.state_dict(), metrics


@pytest.mark.parametrize("task,flags", [
    ("fmow", {"data_parallel": True, "ring_shard": True, "ring_dtype": "bf16"}),
    ("amazon", {"data_parallel": True, "ring_shard": True}),
], ids=["fmow-SWAG_PODS", "amazon"])
def test_wilds_flagged_row_is_the_unflagged_row(task, flags):
    unflagged = {k: v for k, v in flags.items() if k == "ring_dtype"}
    state, metrics = _wilds_run(task, unflagged)
    got_state, got_metrics = _wilds_run(task, flags)
    assert got_state.keys() == state.keys()
    assert all(torch.equal(got_state[k], v) for k, v in state.items())
    assert got_metrics == metrics


def test_wilds_flagged_row_matches_jax(monkeypatch):
    """A flagged camelyon17 row on the port against JAX's unflagged row
    (``run_both`` runs JAX without the flags)."""
    check_row("camelyon17", {**yaml_row("camelyon", "MAP"), "data_parallel": True, "ring_shard": True}, monkeypatch)
