"""PyTorch port, data/wilds.py + data/native_loader.py +
experiments/wilds_task.py: the WILDS data bit-equal to the JAX package's,
the official metrics equal on the same predictions, the batch order equal to
the native loader's SplitMix64 shuffle, ``_tx`` against the JAX optimizer,
``eval_task``'s padding, ``train``'s batches against the JAX
``PrefetchLoader``, the options that still raise (the image tasks, bf16,
the image schedules, data parallelism, a sharded ring, an ensemble of SVGD
particle sets, pretrained weights, remat), and ``run_single`` end to end at
a tiny size on the CPU.

Tolerances: the data, metrics and batch order are compared for equality;
``_tx``: after five steps of a toy vector, SGD 1e-6 (the same fp32 update in
another library), Adam 4e-5 of lr per step (optax's fp32 bias correction,
see the test); ``eval_task`` against the JAX one on a deterministic linear
model: 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.data import native_loader as jax_native
from beyond_deep_ensembles_tpu.data import wilds as jax_wilds_data
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu_torch.data import native_loader, wilds
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods.api import MethodState, PosteriorMethod
from beyond_deep_ensembles_tpu_torch.methods.map import map_method

TINY = {
    "tiny": True, "subsample": 24, "test_subsample": 10, "batch_size": 8, "eval_batch_size": 4,
    "eval_samples": 2, "epochs": 1, "optimizer_kind": "adam", "lr": 1e-3, "weight_decay": 0.01,
}


@pytest.mark.parametrize(
    "split,subsample", [("train", None), ("train", 80), ("test", 32), ("val", 0.25), ("id_val", 3)]
)
def test_load_wilds_synthetic_is_bit_equal(split, subsample):
    got = wilds.load_wilds("amazon", split, subsample=subsample)
    want = jax_wilds_data.load_wilds("amazon", split, subsample=subsample)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[1:] == (512, 2) and got[0].dtype == np.int32


def test_load_wilds_reads_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    (tmp_path / "wilds").mkdir()
    rng = np.random.RandomState(0)
    x = rng.randint(0, 30522, size=(10, 512, 2)).astype(np.int32)
    np.savez(tmp_path / "wilds" / "amazon_test.npz", x=x, y=rng.randint(0, 5, 10), meta=rng.randint(0, 3, (10, 1)))
    for subsample in (None, 0.5, 4):
        for a, b in zip(wilds.load_wilds("amazon", "test", subsample=subsample),
                        jax_wilds_data.load_wilds("amazon", "test", subsample=subsample)):
            np.testing.assert_array_equal(a, b)
    assert wilds.load_wilds("amazon", "test", subsample=4)[0].shape == (4, 512, 2)


@pytest.mark.parametrize("task", sorted(wilds.TASKS))
def test_evaluate_task_equals_jax(task):
    rng = np.random.RandomState(len(task))
    n = 200
    spec = wilds.TASKS[task]
    if spec.classes == 1:
        preds, targets = rng.standard_normal(n), rng.standard_normal(n)
    else:
        targets = rng.randint(0, spec.classes, n)
        preds = np.where(rng.rand(n) < 0.6, targets, rng.randint(0, spec.classes, n))
    _, _, meta = jax_wilds_data._synthetic(jax_wilds_data.TASKS[task], n, seed=3)
    got = wilds.evaluate_task(task, preds, targets, meta)
    assert got == jax_wilds_data.evaluate_task(task, preds, targets, meta)
    if task == "amazon":
        assert set(got) == {"accuracy", "10th_percentile_acc", "worst_user_acc", "n_users"}


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 5), (1000, 0), (4097, 2**40 + 17), (245_502, 3 * 1_000_003 + 2)])
def test_shuffle_equals_the_native_loader(n, seed):
    assert jax_native._load_library() is not None, "native/libbatcher.so did not load"
    np.testing.assert_array_equal(native_loader.shuffled_indices(n, seed), jax_native.shuffled_indices(n, seed))


def test_tx_matches_jax():
    """Five steps of Adam and of SGD with momentum, weight decay added to the
    gradient first, on a toy vector with a gradient 2 (w - t)."""
    rng = np.random.RandomState(0)
    w0, t = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    for kind in ("adam", "sgd"):
        config = {"optimizer_kind": kind, "lr": 0.05, "weight_decay": 0.01, "momentum": 0.9}
        tx = jax_wilds._tx(config)
        w = jnp.asarray(w0)
        opt_state = tx.init(w)
        for _ in range(5):
            updates, opt_state = tx.update(2 * (w - t), opt_state, w)
            w = optax.apply_updates(w, updates)
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        optimizer, scheduler = wilds_task._tx(config)([p])
        assert scheduler is None
        for _ in range(5):
            optimizer.zero_grad()
            (torch.sum((p - torch.from_numpy(t)) ** 2)).backward()
            optimizer.step()
        # optax takes Adam's bias corrections 1 - beta^t in fp32 (as the
        # port's ``utils/optim.py::Adam`` does), where 1 - 0.999 cancels to
        # about 6e-5 relative, 3e-5 after the square root: a step taken with
        # fp64 corrections may differ by 4e-5 of lr, the bound kept here
        atol = 5 * config["lr"] * 4e-5 if kind == "adam" else 1e-6
        assert_close(p.detach().numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=kind)


def _recording_method(seen):
    def update(state, noise, batch):
        seen.append(tuple(t.clone() for t in batch))
        return state, {"loss": torch.zeros(())}

    return PosteriorMethod(init=None, update=update, sample=None)


def test_train_walks_the_native_loader_order():
    """Two epochs of ``train`` see the batches the JAX ``PrefetchLoader``
    yields (SplitMix64 order, the last partial batch dropped)."""
    config = {**wilds_task.DEFAULT_CONFIG, "model": "map", **TINY, "epochs": 2, "batch_size": 5, "seed": 3}
    x, y, _ = wilds.load_wilds("amazon", "train", subsample=23)
    built = wilds_task.build("amazon", config, torch.Generator().manual_seed(0), device="cpu")
    seen = []
    built.method = _recording_method(seen)
    wilds_task.train(built, config, x, y)
    loader = jax_native.PrefetchLoader((x, y), config["batch_size"], seed=config["seed"])
    want = [batch for epoch in range(2) for batch in loader.epoch(epoch)]
    assert len(seen) == len(want) == 2 * (23 // 5)
    for (xb, yb), (wx, wy) in zip(seen, want):
        np.testing.assert_array_equal(xb.numpy(), wx)
        np.testing.assert_array_equal(yb.numpy(), wy)


def test_eval_task_pads_and_matches_jax():
    """10 reviews at eval batch 4 (the last batch padded with its last review
    and trimmed) through a deterministic linear model of the token ids, on
    both sides: every review counted once, the metrics equal."""
    x, y, meta = wilds.load_wilds("amazon", "test", subsample=10)
    w = np.random.RandomState(1).standard_normal((512, 5)).astype(np.float32) / 1000.0
    config = {"eval_batch_size": 4, "eval_samples": 3, "ece_bins": 10, "model": "map"}

    jmethod = jax_map_method(None, optax.sgd(0.1))
    jbuilt = jax_wilds.BuiltExperiment(
        model=None, method=jmethod, state=jmethod.init(jax.random.key(0), {"w": jnp.asarray(w)}),
        apply_fn=lambda p, s, k, xb: jax.nn.log_softmax(xb[:, :, 0].astype(jnp.float32) @ p["w"]),
        regression=False,
    )
    want = jax_wilds.eval_task(jbuilt, "amazon", config, x, y, meta)

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w))
    method = map_method(None, lambda params: (None, None))
    seen = []

    def apply_fn(params, model_state, noise, xb):
        seen.append(xb[:, :, 0].clone())
        return F.log_softmax(xb[:, :, 0].float() @ params.w, dim=-1)

    built = wilds_task.BuiltExperiment(
        model=None, method=method, state=MethodState(module, {}, None), apply_fn=apply_fn, device=torch.device("cpu"),
    )
    got = wilds_task.eval_task(built, "amazon", config, x, y, meta)
    assert [t.shape[0] for t in seen] == [4] * 9  # 3 batches x 3 samples
    last = seen[-1]
    assert torch.equal(last[2], last[1]) and torch.equal(last[3], last[1])  # padded with the 10th review
    covered = torch.cat([seen[0], seen[3], seen[6][:2]])
    assert torch.equal(covered, torch.from_numpy(x[:, :, 0]))  # each review once
    assert got.keys() == want.keys()
    for k in got:
        assert_close(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", ["map", "mcd"])
def test_run_single_on_cpu(model):
    """The slice end to end through its entry point at TINY_CONFIG's width,
    L = 512; the metrics are finite and in range."""
    res = wilds_task.run_single("amazon", {"model": model, "dropout_p": 0.2, **TINY}, device="cpu")
    assert set(res) == {"accuracy", "avg_log_likelihood", "avg_likelihood", "ece", "signed_ece",
                        "10th_percentile_acc", "worst_user_acc", "n_users"}
    assert all(math.isfinite(v) for v in res.values())
    assert 0.0 <= res["accuracy"] <= 1.0 and res["avg_log_likelihood"] < 0.0
    assert 0.0 <= res["10th_percentile_acc"] <= res["accuracy"] <= 1.0 and res["n_users"] > 0


def test_build_heads_and_frozen_encoder():
    config = {**wilds_task.DEFAULT_CONFIG, **TINY}
    gen = torch.Generator().manual_seed(0)
    mcd = wilds_task.build("amazon", {**config, "model": "mcd", "dropout_p": 0.2}, gen, device="cpu")
    module = mcd.state.params
    assert module.head_kind == "drop" and module.head_dropout.rate == 0.2 and module.bert.mc_dropout
    assert mcd.method.sample_is_identity

    frozen = wilds_task.build("amazon", {**config, "model": "map", "train_all_layers": False}, gen, device="cpu")
    module = frozen.state.params
    assert module.head_kind == "map" and not module.bert.mc_dropout
    before = {k: p.detach().clone() for k, p in module.named_parameters()}
    x, y, _ = wilds.load_wilds("amazon", "train", subsample=4)
    from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

    frozen.method.update(frozen.state, NoiseSource.seeded(0), (torch.from_numpy(x), torch.from_numpy(y)))
    for k, p in module.named_parameters():
        assert torch.equal(p.detach(), before[k]) == k.startswith("bert."), k


@pytest.mark.parametrize(
    "task,override",
    [
        ("iwildcam", {}),
        ("camelyon17", {}),
        ("fmow", {}),
        ("rxrx1", {}),
        ("poverty", {}),
        ("amazon", {"compute_dtype": "bf16"}),
        ("amazon", {"lr_schedule_kind": "cosine_warmup"}),
        ("amazon", {"lr_schedule_kind": "exponential"}),
        ("amazon", {"data_parallel": True}),
        ("civilcomments", {"model": "swag", "ring_shard": True}),
        ("amazon", {"model": "svgd", "members": 2}),
        ("amazon", {"pretrained_path": "/nonexistent"}),
        ("amazon", {"tiny": False, "bert_remat": True}),
    ],
)
def test_unported_options_raise(task, override):
    config = {**wilds_task.DEFAULT_CONFIG, **TINY, "model": "map", **override}
    with pytest.raises(NotImplementedError):
        wilds_task.build(task, config, torch.Generator(), device="cpu")


def test_pretrained_weights_on_disk_raise(tmp_path, monkeypatch):
    """Where the JAX package would load distilbert-base weights from
    $BDE_DATA_DIR, the port refuses instead of training from random ones."""
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    (tmp_path / "distilbert-base-uncased").mkdir()
    (tmp_path / "distilbert-base-uncased" / "pytorch_model.bin").write_bytes(b"")
    config = {**wilds_task.DEFAULT_CONFIG, **TINY, "model": "map"}
    with pytest.raises(NotImplementedError):
        wilds_task.build("amazon", config, torch.Generator(), device="cpu")
    wilds_task.build("amazon", {**config, "pretrained": False}, torch.Generator(), device="cpu")
