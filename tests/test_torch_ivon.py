"""PyTorch port, methods/ivon.py (``ivon_method``) held against the JAX
package on the CPU: three jitted updates of a two-layer MLP with the JAX
draws given (the JAX ``tree.normal_like`` is wrapped so that each draw is
also recorded, by an ordered ``jax.debug.callback``), the NaN skip, and
``sample``; then properties of the port's own: distinct draws, the device
counter that the bias corrections read, MultiiVON's members.

Then the CIFAR row's ``build`` -> ``train`` -> ``eval_model`` against the
JAX package's (``_torch_parity.run_both``): metrics within 1e-5 (as
``test_torch_cifar_multix``).

Tolerances: ``mean``, ``momentum`` and ``precision`` 1e-6 relative and
1e-7 absolute after three updates at lr 0.1 (fp32 elementwise math; the
gradients' sums are taken in other orders), the counters exact, the metrics
1e-6 relative; a sample from the same state and draw 1e-7 absolute (one
add and one divide per element)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import (PARITY, RECORDED, JaxShim, assert_close, one_cpu_thread,  # noqa: F401 (a fixture)
                           random_jax_params, run_both, to_numpy_tree)
from beyond_deep_ensembles_tpu import tree as jax_tree
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import ivon as jax_ivon
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble, ivon_method
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.methods.ivon import IvonState
from beyond_deep_ensembles_tpu_torch.models.jax_convert import _port_flat, params_from_jax, state_from_jax
from beyond_deep_ensembles_tpu_torch.models.layers import Dense
from beyond_deep_ensembles_tpu_torch.nn.base import Model, add_auto_named
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

# configs/cifar.yaml, row "iVON"
IVON_ROW = {"model": "ivon", "members": 1, "lr_schedule": False, "ivon_lr": 0.0001, "ivon_prior_prec": 50,
            "ivon_damping": 0.001, "ivon_augmentation": 10, "ivon_mc_samples": 2}
GEN = torch.Generator().manual_seed(0)
KNOBS = {"lr": 0.1, "prior_prec": 50.0, "dataset_size": 100, "damping": 1e-3, "augmentation": 10, "mc_samples": 2}
def _recorded_normal_like(key, t):
    value = jax_tree.normal_like(key, t)
    jax.debug.callback(lambda v: RECORDED.append(to_numpy_tree(v)), value, ordered=True)
    return value


@pytest.fixture
def draws(monkeypatch):
    """The JAX iVON's eps trees, recorded as they are drawn (in
    ``_torch_parity.RECORDED``)."""
    RECORDED.clear()
    monkeypatch.setattr(jax_ivon, "tree", JaxShim(jax_tree, normal_like=_recorded_normal_like))
    return RECORDED


class JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        h = jax.nn.relu(fnn.Dense(16)(x))
        return fnn.Dense(3)(h)


class TorchNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        add_auto_named(self, Dense(5, 16, generator=GEN))
        add_auto_named(self, Dense(16, 3, generator=GEN))

    def forward(self, x, noise=None, train=True):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _jax_method():
    model = JaxModel(JaxNet())

    def loss_fn(params, model_state, key, batch):
        x, y = batch
        out, kl, ms = model.apply(params, model_state, key, x, train=True)
        logp = jax.nn.log_softmax(out, axis=-1)
        return JaxLossOutput(loss=-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), kl=kl, model_state=ms)

    return model, jax_ivon.ivon_method(loss_fn, **KNOBS)


def _port_method():
    model = Model(TorchNet())

    def loss_fn(params, model_state, noise, batch):
        x, y = batch
        out, kl, ms = model.apply(params, model_state, noise, x, train=True)
        return LossOutput(loss=F.cross_entropy(out, y), kl=kl, model_state=ms)

    return model, ivon_method(loss_fn, **KNOBS)


def _batches(n, seed=0, nan_at=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rng.standard_normal((6, 5)).astype(np.float32)
        if i == nan_at:
            x[0, 0] = np.nan
        out.append((x, rng.randint(0, 3, 6)))
    return out


def _flat(module, tree):
    return _port_flat(module, params_from_jax(to_numpy_tree(tree)))


def _assert_state(state, jstate, module, err=""):
    for name in ("mean", "momentum", "precision"):
        assert_close(getattr(state, name).numpy(), _flat(module, getattr(jstate, name)).numpy(), rtol=1e-6,
                     atol=1e-7, err_msg=f"{err}{name}")
    assert int(state.count) == int(jstate.step)
    assert torch.equal(state.flat, state.mean)  # the parameters hold the mean


def test_three_ivon_updates_match_jax(draws):
    """Three jitted updates (mc 2) with JAX's deltas given, then one with a
    NaN input: the whole update skipped, its count included (JAX step 3 of
    4 updates)."""
    jmodel, jmethod = _jax_method()
    params = random_jax_params(jmodel.module, (6, 5), seed=1)
    jstate = jmethod.init(jax.random.key(0), params, {})
    update = jax.jit(jmethod.update)
    batches = _batches(4, nan_at=3)
    want = []
    for i, (x, y) in enumerate(batches):
        jstate, m = update(jstate, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        want.append({k: float(v) for k, v in m.items()})
    jax.effects_barrier()
    assert len(draws) == 4 * KNOBS["mc_samples"] and int(jstate.step) == 3

    model, method = _port_method()
    net = model.module
    net.load_state_dict(params_from_jax(to_numpy_tree(params)))
    state = method.init(net)
    assert isinstance(state, IvonState) and state.opt_state is None
    initial = {k: getattr(state, k).clone() for k in ("mean", "momentum", "precision")}
    noise = NoiseSource(given=[_flat(net, d) for d in draws])
    for i, ((x, y), ref) in enumerate(zip(batches, want)):
        state, m = method.update(state, noise, (torch.from_numpy(x), torch.from_numpy(y)))
        for k in ("loss", "backbone_loss"):
            if i < 3:
                assert_close(float(m[k]), ref[k], rtol=1e-6, err_msg=k)
            else:
                assert not np.isfinite(float(m[k])) and not np.isfinite(ref[k])
    assert state.step == 4 and noise.draws == len(draws)
    assert all(not torch.equal(getattr(state, k), v) for k, v in initial.items())
    _assert_state(state, jstate, net)


def test_sample_matches_jax(draws):
    """``sample`` of a JAX state converted to the port (``state_from_jax``),
    with JAX's draw given: ``mean + eps / sqrt(N max(prec, 1e-4))``."""
    jmodel, jmethod = _jax_method()
    params = random_jax_params(jmodel.module, (6, 5), seed=2)
    jstate = jmethod.init(jax.random.key(0), params, {})
    (x, y), = _batches(1, seed=3)
    jstate, _ = jax.jit(jmethod.update)(jstate, jax.random.key(1), (jnp.asarray(x), jnp.asarray(y)))
    jax.effects_barrier()
    RECORDED.clear()
    want, _ = jmethod.sample(jstate, jax.random.key(5))
    jax.effects_barrier()
    assert len(draws) == 1

    model, method = _port_method()
    state = method.init(model.module)
    state.load_state_dict(state_from_jax(model.module, jstate))
    _assert_state(state, jstate, model.module, "loaded ")
    got, _ = method.sample(state, NoiseSource(given=[_flat(model.module, draws[0])]))
    ref = params_from_jax(to_numpy_tree(want))
    assert got.keys() == ref.keys()
    for k in ref:
        assert_close(got[k].numpy(), ref[k].numpy(), atol=1e-7, rtol=0, err_msg=k)


def test_mc_draws_and_members_draw_apart():
    """Key mode: the two MC deltas of one step differ, and the two members
    of a MultiiVON step draw different deltas (each its own key)."""
    seen = []

    class Recording(NoiseSource):
        def normal(self, shape, device, train, freeze_on_eval):
            eps = super().normal(shape, device, train, freeze_on_eval)
            seen.append(eps.clone())
            return eps

        def member(self, index):
            return Recording(key=keys.fold_in(self.key.reshape(()), index))

    _, method = _port_method()
    ens = deep_ensemble(method, 2)
    state = ens.init([TorchNet(), TorchNet()])
    (x, y), = _batches(1)
    ens.update(state, Recording(key=keys.as_key(keys.fold_in(0, 1), "cpu")), (torch.from_numpy(x), torch.from_numpy(y)))
    assert len(seen) == 4
    assert all(not torch.equal(a, b) for i, a in enumerate(seen) for b in seen[i + 1:])


def test_bias_corrections_read_the_device_count():
    """The runners set ``state.step`` back after a capture's warm-up; the
    update reads its own device count: two updates with the host step reset
    after each equal two plain ones."""
    (x, y), (x2, y2) = _batches(2, seed=4)
    states, weights = [], TorchNet().state_dict()
    for reset in (False, True):
        model, method = _port_method()
        model.module.load_state_dict(weights)
        state = method.init(model.module)
        for i, (xb, yb) in enumerate(((x, y), (x2, y2))):
            state, _ = method.update(state, NoiseSource.seeded(i), (torch.from_numpy(xb), torch.from_numpy(yb)))
            if reset:
                state.step = 0
        states.append(state)
    assert int(states[1].count) == 2 and states[1].count.device.type == "cpu"
    for name in ("mean", "momentum", "precision"):
        assert torch.equal(getattr(states[0], name), getattr(states[1], name)), name


def test_ivon_build_train_eval_matches_jax(monkeypatch, draws):
    """The CIFAR ``ivon`` row (lr 1e-4, no schedule) through ``build`` ->
    ``train`` (4 steps) -> ``eval_model`` (24 images, S = 4) from JAX's
    weights: each MC draw and each eval sample's eps tree given as the
    port's flat ``[D]`` draw. One MC sample a step, so that the jitted JAX
    step compiles in half the time (the two of the row are held above)."""
    config = {**IVON_ROW, **PARITY, "ivon_mc_samples": 1}

    def to_port(train, evals, module):
        return [_port_flat(module, params_from_jax(d)) for d in train + evals]

    want, got, _, built = run_both(config, monkeypatch, to_port)
    assert int(built.state.count) == 4
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
