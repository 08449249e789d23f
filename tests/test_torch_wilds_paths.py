"""PyTorch port, experiments/wilds_task.py's other paths and K3's key mode,
on the CPU (where the runners run their steps eagerly, as
``parallel/multistep.py::eager_steps`` does; the CUDA-graph capture itself
runs on the card, in ``chip_smoke.py``):

  * ``train`` with ``scan_steps: 3`` (one multi-step call and a leftover
    single update an epoch) against the host loop on the same draws, and
    against the JAX package's ``scan_steps`` train with JAX's draws given;
  * ``train`` with ``device_data`` (the epoch runner) against updates on the
    runner's batches one call each;
  * ``eval_task`` through the eval runner (``device_eval``) against the host
    loop on the same keys;
  * periodic checkpoints: a run stopped after its first epoch and resumed
    equals an uninterrupted one; ``eval_while_train`` and the early stopper,
    the stopper against the JAX package's on one loss sequence, and a
    Laplace run evaluated during training through the eval runner against
    the host loop;
  * K3's key mode (``NoiseSource.attention`` with a ``DeviceSeed``): the
    plain version's mask a function of (key, index) alone, and the key-mode
    forward and backward against the plain version fed that explicit mask,
    and against the JAX Pallas kernel run by the TPU interpreter at p = 0 and
    where every probability is kept.

Tolerances: the port's paths against each other, equal (the same fp32
operations in the same order); against JAX, the states within 2e-6 after the
lr 1e-5 Adam updates (``_torch_wilds_parity.compare_states``); K3 as
``test_torch_attention.py`` (outputs 2e-5, gradients atol 3e-5, rtol 3e-4
against the interpreted kernel; the plain version fed its own mask, equal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from _torch_wilds_parity import (BERT, CUT, RECORDED, compare_states, data, jax_state_dict, load_jax_state,
                                 port_draws, record_draws, yaml_row)
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.data import wilds as wilds_data
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.ops import attention as att
from beyond_deep_ensembles_tpu_torch.ops.sampling import DeviceSeed
from beyond_deep_ensembles_tpu_torch.parallel import multistep
from beyond_deep_ensembles_tpu_torch.utils.early_stopping import EarlyStopper

# four steps of batch 4 an epoch: with scan_steps 3, one multi-step call and
# one leftover single update
PATHS = {**CUT, "bert_config": BERT, "seed": 0}


def _config(row="MCD", **extra):
    x, y, xt, yt, mt = data("amazon")
    x, y = np.concatenate([x, x[:4]]), np.concatenate([y, y[:4]])  # 16 reviews: 4 steps
    config = {**wilds_task.DEFAULT_CONFIG, **yaml_row("amazon", row), **PATHS, "dataset_size": x.shape[0],
              "steps_per_epoch": x.shape[0] // 4, **extra}
    return config, (x, y, xt, yt, mt)


def _build(config):
    return wilds_task.build("amazon", config, torch.Generator().manual_seed(0), config["steps_per_epoch"],
                            device="cpu")


def _masks(n_steps, config, seed=0):
    """Keep masks of ``n_steps`` MCD training forwards, in their draw order."""
    cfg = wilds_task._bert_config(config)
    gen = torch.Generator().manual_seed(seed)
    b, l = config["batch_size"], BERT["max_position_embeddings"]
    out = []
    for _ in range(n_steps):
        out.append(torch.rand(b, l, cfg.dim, generator=gen) >= cfg.dropout)
        for _ in range(cfg.n_layers):
            out.append(torch.rand(b, cfg.n_heads, l, l, generator=gen) >= cfg.attention_dropout)
            out.append(torch.rand(b, l, cfg.dim, generator=gen) >= cfg.dropout)
        out.append(torch.rand(b, cfg.dim, generator=gen) >= config["dropout_p"])
    return out


def _given_everywhere(monkeypatch, draws):
    given = NoiseSource(given=draws)
    monkeypatch.setattr(wilds_task, "NoiseSource", lambda **kw: given)
    monkeypatch.setattr(multistep, "NoiseSource", lambda **kw: given)
    return given


def test_scan_steps_equal_the_host_loop(monkeypatch):
    config, (x, y, *_) = _config()
    masks = _masks(4, config)
    runs = {}
    for scan in (1, 3):
        given = _given_everywhere(monkeypatch, masks)
        built = wilds_task.train(_build(config), {**config, "scan_steps": scan}, x, y)
        assert given.draws == len(masks) and built.state.step == 4
        runs[scan] = built.state.state_dict()
    assert all(torch.equal(runs[1][k], runs[3][k]) for k in runs[1])


def test_scan_steps_match_jax(monkeypatch):
    """JAX's ``scan_steps: 3`` train (one scanned call of three updates and
    a leftover one) against the port's, from JAX's state with JAX's draws."""
    config, (x, y, *_) = _config(scan_steps=3)
    jbuilt = jax_wilds.build("amazon", config, jax.random.key(0), config["steps_per_epoch"])
    built = _build(config)
    load_jax_state(built, jbuilt, config)
    record_draws(monkeypatch)
    jbuilt = jax_wilds.train(jbuilt, config, x, y)
    jax.effects_barrier()
    draws = port_draws(config, jbuilt, built, list(RECORDED), [], 4, 1)
    given = _given_everywhere(monkeypatch, draws)
    built = wilds_task.train(built, config, x, y)
    assert given.draws == len(draws) == 4 * 6
    compare_states(built, jax_state_dict(built, jbuilt, config), config)


def test_device_data_equals_updates_on_its_batches(monkeypatch):
    """The epoch runner's epoch: its permutation from ``fold_in(key, 0)``, then
    one update per batch, each under its step key; the same updates made one
    call each on those batches and keys give the same state."""
    config, (x, y, *_) = _config("MCD", device_data=True)
    built = wilds_task.train(_build(config), config, x, y)
    ref = _build(config)
    xd, yd = wilds_task._to_device(ref, x, y)
    key = keys.fold_in(config["seed"], 0)
    perm = torch.argsort(keys.bits(keys.fold_in(key, 0), 0, xd.shape[0]))
    bs = config["batch_size"]
    batches = [(xd[perm][i * bs : (i + 1) * bs], yd[perm][i * bs : (i + 1) * bs]) for i in range(4)]
    ref.state, _ = multistep.eager_steps(ref.method.update, ref.state, keys.fold_in(key, 2), batches)
    got, want = built.state.state_dict(), ref.state.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if k not in ("epoch",))


@pytest.mark.parametrize("row", ["MCD", "SWAG", "Rank1"])
def test_eval_runner_equals_the_host_loop(row):
    config, (x, y, xt, yt, mt) = _config(row, epochs=1)
    built = wilds_task.train(_build(config), config, x, y)
    host = wilds_task.eval_task(built, "amazon", {**config, "device_eval": False}, xt, yt, mt)
    runner = wilds_task.eval_task(built, "amazon", {**config, "device_eval": True}, xt, yt, mt)
    assert runner == host and (6, 4, config["eval_samples"]) in built.eval_runners


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    config, (x, y, *_) = _config("SWAG", epochs=2, checkpoint_interval=1)
    straight = wilds_task.train(_build(config), {**config, "checkpoint_dir": str(tmp_path / "a")}, x, y)
    stopped = {**config, "epochs": 1, "checkpoint_dir": str(tmp_path / "b")}
    wilds_task.train(_build(config), stopped, x, y)
    assert (tmp_path / "b" / "checkpoint_0").exists() and not (tmp_path / "b" / "checkpoint_1").exists()
    logs = []
    resumed = wilds_task.train(_build(config), {**config, "checkpoint_dir": str(tmp_path / "b")}, x, y,
                               log=logs.append)
    assert logs[0] == "resumed from epoch 0" and (tmp_path / "b" / "checkpoint_1").exists()
    got, want = resumed.state.state_dict(), straight.state.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_eval_while_train_and_early_stopping(monkeypatch):
    seen = []
    config, (x, y, *_) = _config("MAP", epochs=3)
    stopper = EarlyStopper(lambda state: -seen[-1], interval=1, delta=0.0, patience=0)

    def callback(epoch, built):
        seen.append(epoch)
        built.stop = stopper.should_stop(built.state, epoch)

    wilds_task.train(_build(config), config, x, y, epoch_callback=callback)
    assert seen == [0, 1, 2] and stopper.losses == [0.0, -1.0, -2.0] and stopper.epochs_since_best == 0
    assert EarlyStopper(lambda s: 1.0, 1, 0.0, 1).should_stop(None, 0) is False

    calls = []
    monkeypatch.setattr(wilds_task, "eval_task", lambda b, task, c, xv, yv, mv: calls.append(xv.shape) or {})
    monkeypatch.setattr(wilds_data, "load_wilds", lambda task, split, subsample=None, fold=None: (
        np.zeros((4, 64, 2), np.int32), np.zeros(4, np.int64), np.zeros((4, 1), np.int64)))
    wilds_task.run_single("amazon", {**config, "eval_while_train": True, "eval_interval": 2, "epochs": 3}, device="cpu")
    assert calls == [(4, 64, 2)] * 3  # epochs 0 and 2 on the val split, then the test split


@pytest.mark.parametrize("interval,delta,patience", [(1, 0.0, 0), (1, 0.05, 1), (2, 0.1, 1), (3, 0.0, 2)])
def test_early_stopper_matches_jax(interval, delta, patience):
    """The port's and the JAX package's stoppers on one evaluator sequence
    (a noisy descent that stalls, so both improvements beyond ``delta`` and
    plateaus occur): every ``should_stop`` and the stoppers' state after each
    epoch equal."""
    from beyond_deep_ensembles_tpu.utils.early_stopping import EarlyStopper as JaxStopper

    rng = np.random.RandomState(interval * 10 + patience)
    losses = np.concatenate([np.cumsum(-0.1 + 0.1 * rng.standard_normal(8)), 0.05 * rng.standard_normal(8)])
    ours = EarlyStopper(lambda loss: loss, interval, delta, patience)
    theirs = JaxStopper(lambda loss: loss, interval, delta, patience)
    stops = []
    for epoch, loss in enumerate(losses):
        stop = ours.should_stop(float(loss), epoch)
        assert stop == theirs.should_stop(float(loss), epoch), epoch
        assert (ours.losses, ours.best_loss, ours.epochs_since_best) == (
            theirs.losses, theirs.best_loss, theirs.epochs_since_best), epoch
        stops.append(stop)
    assert len(ours.losses) == -(-len(losses) // interval)
    assert any(stops) and not all(stops)


def test_eval_while_train_then_laplace_through_the_eval_runner(monkeypatch):
    """``run_single`` of the Laplace row with ``eval_while_train``: the val
    evals during training and the test eval after the fit have one shape,
    so the eval runner's cache must not hand the fitted Laplace state to the
    MAP method's runner. The eval runner's metrics equal the host loop's."""
    real = wilds_data.load_wilds

    def load(task, split, subsample=None, fold=None):
        x, y, meta = real(task, split, subsample=subsample, fold=fold)
        return x[:, :BERT["max_position_embeddings"]], y, meta

    monkeypatch.setattr(wilds_data, "load_wilds", load)
    config = {**yaml_row("amazon", "Laplace"), **PATHS, "subsample": 8, "test_subsample": 6,
              "eval_while_train": True}
    runner, host = (wilds_task.run_single("amazon", {**config, "device_eval": on}, device="cpu")
                    for on in (True, False))
    assert runner == host


# K3's key mode --------------------------------------------------------------

SHAPE = (2, 8, 2, 64)


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4))
    mask = np.ones(SHAPE[:2], np.int32)
    mask[0, 6:] = 0
    return q, k, v, cot, mask


def _port(q, k, v, cot, mask, **kw):
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = att.fused_dropout_attention(*leaves, torch.from_numpy(mask), **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def test_key_mode_mask_is_a_function_of_key_and_index():
    q, k, v, _, mask = (torch.from_numpy(a) for a in _qkv())
    key = torch.tensor(keys.fold_in(3, 1))

    def probs(key, index):
        return att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=0.3, seed=DeviceSeed(key, index))[1]

    b, l, h, _ = SHAPE
    first = probs(key, 1 << 20)
    assert torch.equal(first, probs(key.clone(), 1 << 20))
    assert not torch.equal(first > 0, probs(key, 2 << 20) > 0)
    assert not torch.equal(first > 0, probs(key + 1, 1 << 20) > 0)
    unpadded = (mask > 0)[:, None, None, :].expand(b, h, l, l)
    explicit = att.key_keep_mask((b, h, l, l), DeviceSeed(key, 1 << 20), 0.3)
    assert torch.equal(first > 0, explicit & unpadded)
    # NoiseSource in key mode: draw d passes K3 the seed key + ((d + 1) << 20)
    noise = NoiseSource(key=key)
    noise.keep_mask((2, 3), "cpu", 0.1)
    got = noise.attention(q, k, v, mask, 0.3)
    want = att.dropout_attention_plain(q, k, v, mask, att.key_keep_mask((b, h, l, l), DeviceSeed(key, 2 << 20), 0.3),
                                       dropout_p=0.3)
    assert torch.equal(got, want) and noise.draws == 2


def test_key_mode_equals_the_plain_version_on_its_mask():
    q, k, v, cot, mask = _qkv(1)
    seed = DeviceSeed(torch.tensor(12345), 3 << 20)
    b, l, h, _ = SHAPE
    keep = att.key_keep_mask((b, h, l, l), seed, 0.3)
    got, grads = _port(q, k, v, cot, mask, dropout_p=0.3, seed=seed)
    want, want_grads = _port(q, k, v, cot, mask, dropout_p=0.3, keep=keep)
    assert np.array_equal(got, want) and all(np.array_equal(g, w) for g, w in zip(grads, want_grads))


@pytest.mark.parametrize("dropout_p,regime", [(0.0, "none"), (2.0**-25, "keep_all")])
def test_key_mode_matches_interpreted_pallas_kernel(dropout_p, regime):
    """The interpreter's random bits are all zero (u = 0.5): at p = 2^-25 it
    keeps every probability, scaled by 1 / (1 - p); the port's key-mode mask
    keeps every one too at that p for this key (a 24-bit uniform of zero is
    the only one dropped), which the test asserts."""
    from jax.experimental.pallas import tpu as pltpu

    from beyond_deep_ensembles_tpu.ops.attention import fused_dropout_attention

    q, k, v, cot, mask = _qkv(2)

    def jax_fn(q, k, v):
        return fused_dropout_attention(q, k, v, jnp.asarray(mask), jnp.array([7], jnp.int32), dropout_p=dropout_p,
                                       interpret=pltpu.InterpretParams())

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))
    seed = DeviceSeed(torch.tensor(keys.fold_in(9, 0)), 1 << 20) if dropout_p else None
    if regime == "keep_all":
        b, l, h, _ = SHAPE
        assert bool(att.key_keep_mask((b, h, l, l), seed, dropout_p).all())
    got, grads = _port(q, k, v, cot, mask, dropout_p=dropout_p, seed=seed)
    assert_close(got, np.asarray(want), rtol=2e-5, atol=2e-5, err_msg=f"output, {regime}")
    for name, g, w in zip("qkv", grads, want_grads):
        assert_close(g, np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=f"d{name}, {regime}")


def test_device_seed_input_checks():
    q, k, v, _, mask = (torch.from_numpy(a) for a in _qkv())
    for seed in (DeviceSeed(torch.tensor(1.0), 0), DeviceSeed(torch.tensor([1, 2]), 0),
                 DeviceSeed(torch.tensor(1), 2**31)):
        with pytest.raises(ValueError, match="device seed"):
            att.fused_dropout_attention(q, k, v, mask, dropout_p=0.1, seed=seed)
    with pytest.raises(ValueError, match="B H"):
        big = torch.zeros(1, 1, 1 << 20, 1)
        NoiseSource(key=torch.tensor(1)).attention(big, big, big, torch.ones(1, 1), 0.1)

