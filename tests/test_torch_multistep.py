"""PyTorch port, parallel/multistep.py (the step and eval runners), keys.py,
tree.tree_where and the device-side NaN guards, held against the JAX
package on the CPU, where the runners run their steps eagerly (on a card
they replay CUDA graphs; ``chip_smoke.py`` holds replays against eager
steps there).

Tolerances: ``make_multi_step`` over ``map_method.update`` with the CIFAR
optimizer (the port's SGD against optax, lr on the device from the count):
parameters atol 2e-6 (fp32 steps of lr 0.05 on O(1) weights, the sums
taken in other orders), metrics rtol 1e-5; ``make_eval_runner`` against the
JAX runner on a deterministic ``predict_batch``: 1e-6; the port's runners
against the port's own eager loops over the same order and keys: equal bit
for bit (the same operations on the CPU)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import assert_close, nchw, one_cpu_thread  # noqa: F401 (one_cpu_thread: a fixture)
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu.parallel.multistep import make_eval_runner as jax_make_eval_runner
from beyond_deep_ensembles_tpu.parallel.multistep import make_multi_step as jax_make_multi_step
from beyond_deep_ensembles_tpu.parallel.multistep import stack_batches as jax_stack_batches
from beyond_deep_ensembles_tpu.tree import tree_where as jax_tree_where
from beyond_deep_ensembles_tpu_torch import keys, tree
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput, MethodState
from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
from beyond_deep_ensembles_tpu_torch.methods.map import map_method
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.parallel import multistep
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

IN, OUT = 12, 4
TX_CONFIG = {**jax_cifar.DEFAULT_CONFIG, "epochs": 4, "lr": 0.05}  # the schedule decays from step 3


def _linear_data(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.standard_normal((n, IN)).astype(np.float32), rng.randint(0, OUT, n)


def _jax_loss(params, model_state, key, batch):
    del key
    x, y = batch
    logp = jax.nn.log_softmax(jnp.tanh(x @ params["w"] + params["b"]) @ params["v"], axis=-1)
    loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))
    return JaxLossOutput(loss=loss, model_state=model_state, metrics={"acc": jnp.mean(jnp.argmax(logp, -1) == y)})


def _port_loss(params, model_state, noise, batch):
    del noise
    x, y = batch
    logp = F.log_softmax(torch.tanh(x @ params.w + params.b) @ params.v, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
    return LossOutput(loss=loss, model_state=model_state, metrics={"acc": torch.mean((logp.argmax(-1) == y).float())})


def _weights(seed=1):
    rng = np.random.RandomState(seed)
    return {"w": 0.5 * rng.standard_normal((IN, 8)).astype(np.float32),
            "b": 0.1 * rng.standard_normal(8).astype(np.float32),
            "v": 0.5 * rng.standard_normal((8, OUT)).astype(np.float32)}


def _port_state(weights, spe=1):
    module = torch.nn.Module()
    for name, value in weights.items():
        setattr(module, name, torch.nn.Parameter(torch.from_numpy(value.copy())))
    method = map_method(_port_loss, cifar._base_tx(TX_CONFIG, spe))
    return method, method.init(module)


def test_multi_step_matches_jax():
    """Two calls of ``make_multi_step(map_method.update, 4)`` (8 steps, the
    Wilson lr decaying from step 3 at one step an epoch) against JAX's."""
    weights = _weights()
    x, y = _linear_data(8 * 16)
    batches = [(x[i * 16 : (i + 1) * 16], y[i * 16 : (i + 1) * 16]) for i in range(8)]

    jmethod = jax_map_method(_jax_loss, jax_cifar._base_tx(TX_CONFIG, 1))
    jstate = jmethod.init(jax.random.key(0), {k: jnp.asarray(v) for k, v in weights.items()})
    jmulti = jax_make_multi_step(jmethod.update, 4)
    method, state = _port_state(weights)
    multi = multistep.make_multi_step(method.update, 4)
    for call in range(2):
        chunk = batches[4 * call : 4 * call + 4]
        jstate, jm = jmulti(jstate, jax.random.key(call), jax_stack_batches(
            [(jnp.asarray(a), jnp.asarray(b)) for a, b in chunk]))
        state, m = multi(state, call, multistep.stack_batches(
            [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in chunk]))
        assert m.keys() == {"loss", "acc"} and m["loss"].shape == ()
        for k in ("loss", "acc"):
            assert_close(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k}, call {call}")
    assert state.step == 8 and int(state.opt_state[0].count) == 8
    for name, p in state.params.named_parameters():
        assert_close(p.detach().numpy(), np.asarray(jstate.params[name]), atol=2e-6, rtol=0, err_msg=name)
    with pytest.raises(ValueError):
        multi(state, 0, multistep.stack_batches([(torch.from_numpy(x[:16]), torch.from_numpy(y[:16]))]))


def _eval_predict_jax(state, key, xb):
    del key
    return jax.nn.log_softmax(xb @ state["w"])


def _eval_predict_port(state, key, xb):
    del key
    return F.log_softmax(xb @ state["w"], dim=-1)


def test_eval_runner_matches_jax():
    """70 points at batch 16 (the last batch padded with 10 copies of its
    last row and trimmed): the port's runner against JAX's, 1e-6, and
    against a plain loop over the 70 points."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((70, 3)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    ref = np.asarray(jax_make_eval_runner(_eval_predict_jax, 70, 16)({"w": jnp.asarray(w)}, jax.random.key(42),
                                                                      jnp.asarray(x)))
    calls = []

    def predict(state, key, xb):
        calls.append((int(key), xb.shape[0]))
        return _eval_predict_port(state, key, xb)

    got = multistep.make_eval_runner(predict, 70, 16)({"w": torch.from_numpy(w)}, 42, torch.from_numpy(x)).numpy()
    assert got.shape == (70, 5)
    assert_close(got, ref, rtol=1e-6, atol=1e-6, err_msg="eval runner")
    assert calls == [(keys.fold_in(42, i), 16) for i in range(5)]
    np.testing.assert_array_equal(got, F.log_softmax(torch.from_numpy(x @ w), dim=-1).numpy())


def test_eval_model_runner_equals_host_loop():
    """``eval_model`` with ``device_eval`` (the runner) and without (the host
    loop) on a linear model whose output carries key-mode noise: the same
    batches under the same keys give the same metrics, bit for bit."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((23, 4, 4, 3)).astype(np.float32)
    y = rng.randint(0, 5, 23)
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(rng.standard_normal((48, 5)).astype(np.float32)))
    method = bbb_method(None, lambda p: (None, None), None, dataset_size=1)

    def apply_fn(params, model_state, noise, xb):
        logits = xb.reshape(xb.shape[0], -1) @ params.w
        return F.log_softmax(logits + 0.5 * noise.normal(logits.shape, xb.device, True, False), dim=-1)

    built = cifar.BuiltExperiment(model=None, method=method, state=MethodState(module, {}, None),
                                  apply_fn=apply_fn, device=torch.device("cpu"))
    config = {"eval_batch_size": 10, "eval_samples": 3, "ece_bins": 10}
    runner = cifar.eval_model(built, {**config, "device_eval": True}, x, y).as_dict()
    host = cifar.eval_model(built, {**config, "device_eval": False}, x, y).as_dict()
    other = cifar.eval_model(built, {**config, "device_eval": False}, x, y, seed=43).as_dict()
    assert runner == host and runner != other
    assert list(built.eval_runners) == [(23, 10, 3)]


def _counting_update(seen):
    """An update that records each batch's first column and takes one SGD
    step of a scalar towards the batch mean."""
    def update(state, noise, batch):
        x, _ = batch
        seen.append(x[:, 0].clone())
        optimizer, _ = state.opt_state
        optimizer.zero_grad()
        loss = torch.mean((state.params.c - x[:, 0]) ** 2) + 0.01 * noise.normal((1,), x.device, True, False).sum()
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}
    return update


def _scalar_state():
    module = torch.nn.Module()
    module.c = torch.nn.Parameter(torch.zeros(()))
    return MethodState(module, {}, (SGD(module.parameters(), 0.1, momentum=0.9), None))


def test_epoch_runner_takes_each_example_once_and_drops_the_remainder():
    """70 examples at batch 16: 4 steps, 64 distinct examples, the other 6
    dropped; the permutation is the argsort of ``keys.bits`` under
    ``fold_in(key, 0)``; the state equals the eager per-step loop's over the
    same order from ``fold_in(key, 2)``, bit for bit; another key, another
    order."""
    n, bs = 70, 16
    x = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 3)
    y = torch.zeros(n, dtype=torch.int64)
    seen = []
    runner = multistep.make_epoch_runner(_counting_update(seen), n, bs)
    state, metrics = runner(_scalar_state(), 5, (x, y))
    used = torch.cat(seen).long()
    assert len(seen) == 4 and used.numel() == 64 and used.unique().numel() == 64
    perm = torch.argsort(keys.bits(keys.fold_in(5, 0), 0, n))[:64]
    assert torch.equal(used, perm)
    assert state.step == 4

    seen2 = []
    eager, sums = multistep.eager_steps(_counting_update(seen2), _scalar_state(), keys.fold_in(5, 2),
                                        [(x[perm[i * bs : (i + 1) * bs]], y[:bs]) for i in range(4)])
    assert torch.equal(eager.params.c, state.params.c) and torch.equal(sums["loss"] / 4, metrics["loss"])
    seen3 = []
    multistep.make_epoch_runner(_counting_update(seen3), n, bs)(_scalar_state(), 6, (x, y))
    assert not torch.equal(torch.cat(seen3), torch.cat(seen))
    with pytest.raises(ValueError):
        multistep.make_epoch_runner(_counting_update([]), 10, 16)


def test_epoch_runner_applies_the_transform_once_per_epoch():
    calls = []

    def transform(key, data):
        calls.append((key, data[0].shape[0]))
        return data[0] + 1.0, data[1]

    seen = []
    x, y = torch.zeros(40, 2), torch.zeros(40, dtype=torch.int64)
    multistep.make_epoch_runner(_counting_update(seen), 40, 8, epoch_transform=transform)(_scalar_state(), 9, (x, y))
    assert calls == [(keys.fold_in(9, 1), 40)] and all(bool((s == 1.0).all()) for s in seen)


def test_keys():
    """Advance is a bijection on 62 bits (no collisions over a run of
    steps, and distinct starts stay distinct); tensors and ints advance
    alike; fold_in separates its inputs; bits are distinct for one key and
    stream and change with either; normals have unit moments."""
    k, seen = 12345, set()
    for _ in range(1000):
        seen.add(k)
        assert 0 <= k < 2**62
        k = keys.advance(k)
    assert len(seen) == 1000
    t = torch.tensor(12345)
    for _ in range(3):
        t = keys.advance(t)
    assert int(t) == keys.advance(keys.advance(keys.advance(12345)))
    assert len({keys.fold_in(0, i) for i in range(1000)} | {keys.fold_in(1, i) for i in range(1000)}) == 2000
    b = keys.bits(keys.fold_in(0, 1), 0, 100_000)
    assert b.unique().numel() == 100_000 and int(b.min()) >= 0 and int(b.max()) < 2**32
    assert not torch.equal(b, keys.bits(keys.fold_in(0, 1), 1, 100_000))
    assert torch.equal(b, keys.bits(torch.tensor(keys.fold_in(0, 1)), 0, 100_000))
    z = keys.normal(3, 7, 200_001)
    assert z.shape == (200_001,) and abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    with pytest.raises(ValueError):
        keys.fold_in(2**62, 0)


def test_noise_source_key_mode():
    """Key mode: the same key gives the same draws (K1's CPU path, pooled
    normals, crops, attention masks), another key other draws (dropout masks
    draw in it: ``tests/test_torch_mcd.py``)."""
    def draws(key):
        noise = NoiseSource(key=torch.tensor(key))
        m = torch.zeros(2, 3, 4, 4)
        out = noise.gaussian(m, torch.ones_like(m), None, None, train=True, freeze_on_eval=True)
        row = noise.normal((2, 3), "cpu", train=False, freeze_on_eval=True)
        offsets, flips = noise.crops(5, "cpu")
        return [out, row, offsets, flips.long()], noise.draws

    a, n = draws(7)
    b, _ = draws(7)
    c, _ = draws(8)
    assert n == 3 and all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert torch.equal(a[1][0], a[1][1])  # a frozen row shared by the batch
    assert int(a[2].min()) >= 0 and int(a[2].max()) <= 8
    q = torch.randn(1, 64, 2, 64, generator=torch.Generator().manual_seed(0))

    def attention(key):
        return NoiseSource(key=torch.tensor(key)).attention(q, q, q, torch.ones(1, 64, dtype=torch.bool), 0.5)

    assert torch.equal(attention(7), attention(7)) and not torch.equal(attention(7), attention(8))
    with pytest.raises(ValueError):
        NoiseSource(key=torch.tensor(7), generator=torch.Generator())


def test_tree_where_matches_jax():
    rng = np.random.RandomState(0)
    a = {"x": rng.standard_normal(3).astype(np.float32), "y": rng.standard_normal((2, 2)).astype(np.float32)}
    b = {k: v + 1 for k, v in a.items()}
    for pred in (True, False):
        ref = jax_tree_where(jnp.asarray(pred), {k: jnp.asarray(v) for k, v in a.items()},
                             {k: jnp.asarray(v) for k, v in b.items()})
        got = tree.tree_where(torch.tensor(pred), {k: torch.from_numpy(v) for k, v in a.items()},
                              {k: torch.from_numpy(v) for k, v in b.items()})
        for k in a:
            assert_close(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=0, err_msg=f"{k}, {pred}")
    nan = [torch.tensor([float("nan")]), torch.tensor([1.0])]
    assert tree.tree_where(torch.tensor(False), nan, [torch.tensor([2.0]), torch.tensor([3.0])])[0].item() == 2.0


def _bad_batch_keeps_state(model):
    """Two steps through the multi-step runner, the second on a batch with a
    NaN: the parameters, momentum and count equal those after the first
    step alone (JAX: the update keeps ``params`` and ``opt_state``), and the
    runner's mean loss is not finite."""
    config = {**cifar.DEFAULT_CONFIG, "model": model, "svgd_particles": 2, "bbb_mc_samples": 1,
              "dataset_size": 100, "epochs": 2, "augment": False}
    rng = np.random.RandomState(0)
    x = nchw(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 2))
    bad = x.clone()
    bad[0] = float("nan")
    one = cifar.build(config, torch.Generator().manual_seed(0), 1, device="cpu")
    two = cifar.build(config, torch.Generator().manual_seed(0), 1, device="cpu")
    one.state, _ = multistep.eager_steps(one.method.update, one.state, 3, [(x, y)])
    multi = multistep.make_multi_step(two.method.update, 2)
    two.state, metrics = multi(two.state, 3, multistep.stack_batches([(x, y), (bad, y)]))
    assert not math.isfinite(float(metrics["loss"])) and two.state.step == 2
    opt1, opt2 = one.state.opt_state[0], two.state.opt_state[0]
    assert int(opt1.count) == int(opt2.count) == 1
    assert torch.equal(opt1.flat, opt2.flat) and torch.equal(opt1.trace, opt2.trace)


@pytest.mark.parametrize("model", ["bbb", "svgd"])
def test_nonfinite_batch_keeps_params_momentum_and_count(model):
    _bad_batch_keeps_state(model)


@pytest.mark.usefixtures("one_cpu_thread")
@pytest.mark.parametrize("kind", [{"model": "swag"}, {"model": "map", "members": 2}, {"model": "swag", "members": 2}],
                         ids=["swag", "deep_ensemble", "multiswag"])
def test_warm_up_leaves_the_state_as_it_found_it(kind):
    """A capture's warm-up (two updates) writes back every tensor the
    update wrote, as the state lists them: SWAG's moments, ring and
    counters (collecting from the first step here), every member's
    parameters and optimizer; ``step`` too. The same two updates without
    the write-back do move all of them."""
    config = {**cifar.DEFAULT_CONFIG, **kind, "swag_start_epoch": 0, "epochs": 1, "dataset_size": 100,
              "augment": False}
    built = cifar.build(config, torch.Generator().manual_seed(0), 1, device="cpu")
    rng = np.random.RandomState(0)
    batch = (nchw(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)), torch.from_numpy(rng.randint(0, 10, 2)))
    before = {k: v.clone() for k, v in built.state.state_dict().items()}
    metrics = multistep._warm_up(built.method.update, built.state, keys.as_key(3, "cpu"), batch)
    assert math.isfinite(float(metrics["loss"])) and built.state.step == 0
    after = built.state.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    multistep.eager_steps(built.method.update, built.state, 3, [batch, batch])
    moved = built.state.state_dict()
    unmoved = [k for k, v in before.items() if torch.equal(moved[k], v) and not k.endswith(("epoch", ".lr"))]
    assert unmoved == []
