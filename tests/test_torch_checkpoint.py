"""PyTorch port, utils/checkpoint.py, the states' ``state_dict`` /
``load_state_dict``, ``experiments/phases.py`` and the checkpoint paths of
``experiments/cifar.py`` (periodic saves, auto-resume, ``{model}_final``),
on the CPU.

Everything here is held to equality: a checkpoint is a ``torch.save`` of
the state's tensors and a restore copies them back in place, so a round
trip and a resumed run (the same operations on the same values) are bit
for bit."""
import math
import os

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from beyond_deep_ensembles_tpu_torch.experiments import cifar, phases
from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

KINDS = {
    "map": {"model": "map"},
    "bbb": {"model": "bbb", "bbb_mc_samples": 1},
    "svgd": {"model": "svgd", "svgd_particles": 2},
    "swag": {"model": "swag", "swag_start_epoch": 0, "swag_deviation_samples": 3, "epochs": 1},
    "ensemble": {"model": "mcd", "members": 2},
    # iVON (mean, momentum, precision, its device count), SNGP (the spectral
    # u, the precision, covariance and seen_data as buffers), MultiiVON, a
    # Rank-1 mixture (its update counter)
    "ivon": {"model": "ivon", "ivon_mc_samples": 1},
    "sngp": {"model": "sngp", "sngp": {**cifar.DEFAULT_CONFIG["sngp"], "num_random_features": 16}},
    "multiivon": {"model": "ivon", "members": 2, "ivon_mc_samples": 1},
    "rank1": {"model": "rank1", "bbb_mc_samples": 1},
}
# a tiny run: 2 steps of 16 an epoch, 3 epochs, the Wilson schedule over them
RUN = {"subsample": 32, "test_subsample": 10, "batch_size": 16, "eval_batch_size": 10, "eval_samples": 2,
       "epochs": 3, "checkpoint_interval": 1, "seed": 0, "augment": True}


def _build(kind, seed):
    config = {**cifar.DEFAULT_CONFIG, **KINDS[kind], "dataset_size": 64}
    return cifar.build(config, torch.Generator().manual_seed(seed), 1, device="cpu")


def _step(built):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 4))
    built.state, _ = built.method.update(built.state, NoiseSource.seeded(1), (x, y))


def _equal(a, b):
    da, db = a.state_dict(), b.state_dict()
    return da.keys() == db.keys() and all(torch.equal(da[k], db[k]) for k in da)


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_of_each_state_kind(tmp_path, kind):
    """Save after one update (momentum and counters moved), restore into a
    state built from another seed: bit-equal, in place (the optimizer's
    parameters stay views of its flat buffer)."""
    saved = _build(kind, 0)
    _step(saved)
    ckpt.save_checkpoint(tmp_path, 5, saved.state)
    other = _build(kind, 1)
    assert not _equal(saved.state, other.state)
    template = other.state
    state, step = ckpt.restore_checkpoint(tmp_path, template)
    assert step == 5 and state is template and _equal(saved.state, state)
    members = state.members if isinstance(state, EnsembleState) else [state]
    for member in members:
        flat = member.flat if member.opt_state is None else member.opt_state[0].flat  # iVON: its own buffer
        lo, hi = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
        assert all(lo <= p.data_ptr() < hi for p in member.params.parameters() if p.requires_grad)
    loaded = torch.load(tmp_path / "checkpoint_5", weights_only=True)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in loaded.values())


def test_sngp_state_dict_carries_its_buffers():
    """The JAX package keeps SNGP's spectral ``u`` and the head's precision,
    covariance and seen_data as mutable model state; the port's are module
    buffers, in ``params.*`` of the state's checkpoint, and ``model_state``
    stays empty."""
    state = _build("sngp", 0).state
    keys = state.state_dict().keys()
    assert not state.model_state
    for name in ("SNGPHead_0.precision", "SNGPHead_0.covariance", "SNGPHead_0.seen_data",
                 "SNGPHead_0.RandomFourierFeatures_0.W", "SpectralNormConv_0.kernel_u",
                 "BasicBlock_8.SpectralNormConv_1.kernel_u"):
        assert f"params.{name}" in keys, name
    assert sum(k.endswith("kernel_u") for k in keys) == 21


def test_a_swag_ring_is_saved_from_its_first_filled_row(tmp_path):
    """A ring fills from its last row: the file holds the filled rows only
    (one after one update, none before), and a restore puts the leading
    zeros back, bit for bit."""
    for updates in (0, 1):
        saved = _build("swag", 0)
        for _ in range(updates):
            _step(saved)
        ckpt.save_final(tmp_path, f"swag{updates}", saved.state)
        loaded = torch.load(tmp_path / f"swag{updates}_final", weights_only=True)
        assert loaded["swag.deviations"].shape[0] == updates and saved.state.deviations.shape[0] == 3
        state = ckpt.restore_final(tmp_path, f"swag{updates}", _build("swag", 1).state)
        assert _equal(saved.state, state)


def test_restore_refuses_another_kind(tmp_path):
    ckpt.save_final(tmp_path, "map", _build("map", 0).state)
    with pytest.raises(KeyError):
        ckpt.restore_final(tmp_path, "map", _build("swag", 0).state)


def test_latest_checkpoint_step(tmp_path):
    assert ckpt.latest_checkpoint_step(tmp_path / "absent") is None
    assert ckpt.restore_checkpoint(tmp_path, "template") == ("template", None)
    for name in ("checkpoint_3", "checkpoint_10", "checkpoint_2", "checkpoint_11.tmp", "map_final", "checkpoint_x"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt.latest_checkpoint_step(tmp_path) == 10


class _Preempted(Exception):
    pass


def _preempt_after(epoch):
    """A log that stops the run when epoch ``epoch`` ends, before its
    checkpoint is written: the latest is then ``epoch - 1``'s."""
    def log(line):
        if line.startswith(f"epoch {epoch}:"):
            raise _Preempted(line)
    return log


@pytest.mark.parametrize("variant", [{"model": "swag", "swag_start_epoch": 1, "swag_deviation_samples": 3},
                                     {"model": "map", "members": 2, "device_data": True},
                                     {"model": "ivon", "ivon_mc_samples": 1},
                                     {"model": "sngp", "device_data": True,
                                      "sngp": {**cifar.DEFAULT_CONFIG["sngp"], "num_random_features": 16}}],
                         ids=["swag_host_loop", "deep_ensemble_epoch_runner", "ivon_host_loop", "sngp_epoch_runner"])
def test_resumed_run_equals_uninterrupted(tmp_path, variant):
    """A run stopped after epoch 1 (its checkpoint_0 saved), resumed by a
    fresh build to 3 epochs, equals a 3-epoch run without checkpoints,
    bit for bit: parameters, optimizer buffers, SWAG's moments, ring and
    counters, the members' states, iVON's mean, momentum, precision and
    count, SNGP's buffers (u, precision, covariance, seen_data)."""
    config = {**cifar.DEFAULT_CONFIG, **RUN, **variant}
    config, (x, y), _ = cifar._load_data(config)
    whole = cifar.train(cifar._build_for(config, "cpu"), config, x, y)

    run = {**config, "checkpoint_dir": str(tmp_path)}
    with pytest.raises(_Preempted):
        cifar.train(cifar._build_for(run, "cpu"), run, x, y, log=_preempt_after(1))
    assert ckpt.latest_checkpoint_step(tmp_path) == 0
    lines = []
    resumed = cifar.train(cifar._build_for(run, "cpu"), run, x, y, log=lines.append)
    assert lines[0] == "resumed from epoch 0" and lines[1].startswith("epoch 1:")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_0", "checkpoint_1", "checkpoint_2"]
    assert _equal(whole.state, resumed.state)


def test_multix_from_checkpoints_with_leave_out(tmp_path):
    """Three saved map finals, the middle one left out: a 2-member
    deep_ensemble of the other two, each restored into its own state."""
    dirs = [tmp_path / f"rep_{i}" for i in range(3)]
    finals = []
    for i, d in enumerate(dirs):
        built = _build("map", i)
        ckpt.save_final(d, "map", built.state)
        finals.append(built.state)
    inner = _build("map", 9).method
    states = phases.load_members(dirs, "map", lambda: _build("map", 9).state)
    assert len({id(s) for s in states}) == 3
    method, state = phases.multix_from_checkpoints(inner, states, leave_out=1)
    assert len(state.members) == 2 and not method.sample_is_identity
    assert _equal(state.members[0], finals[0]) and _equal(state.members[1], finals[2])
    params, _ = method.sample(state, None, 3)
    assert params is state.members[1].params


def test_failed_async_save_surfaces_in_its_own_run(tmp_path, monkeypatch):
    """A write that fails in run A raises at A's next wait, not at B's;
    B's own save commits."""
    real = ckpt._write_file

    def write(path, tensors):
        if "run_a" in path:
            raise OSError("disk full")
        real(path, tensors)

    monkeypatch.setattr(ckpt, "_write_file", write)
    state = _build("map", 0).state
    ckpt.save_checkpoint(tmp_path / "run_a", 0, state, async_save=True)
    ckpt.save_checkpoint(tmp_path / "run_b", 0, state, async_save=True)
    ckpt.wait_for_async_saves(tmp_path / "run_b")
    assert (tmp_path / "run_b" / "checkpoint_0").exists()
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_async_saves(tmp_path / "run_a")
    ckpt.wait_for_async_saves(tmp_path / "run_a")  # the error is raised once


def test_diverged_run_waits_for_its_save(tmp_path, monkeypatch):
    """Epoch 0 ends, its checkpoint write starts (slowed down here), the
    parameters go NaN, epoch 1 diverges: ``train`` raises "Diverged" only
    after the write has committed."""
    real = ckpt._write_file

    def slow(path, tensors):
        import time
        time.sleep(0.5)
        real(path, tensors)

    monkeypatch.setattr(ckpt, "_write_file", slow)
    config = {**cifar.DEFAULT_CONFIG, **RUN, "model": "map", "checkpoint_dir": str(tmp_path)}
    config, (x, y), _ = cifar._load_data(config)
    built = cifar._build_for(config, "cpu")

    def poison(line):
        if line.startswith("epoch 0:"):
            with torch.no_grad():
                next(built.state.params.parameters()).fill_(math.nan)

    with pytest.raises(RuntimeError, match="Diverged"):
        cifar.train(built, config, x, y, log=poison)
    assert os.listdir(tmp_path) == ["checkpoint_0"]


def test_run_single_saves_the_final_state(tmp_path):
    config = {**RUN, "model": "map", "epochs": 1, "checkpoint_dir": str(tmp_path), "checkpoint_interval": 20}
    res = cifar.run_single(config, device="cpu")
    assert math.isfinite(res["test"]["avg_log_likelihood"])
    assert sorted(os.listdir(tmp_path)) == ["map_final"]
