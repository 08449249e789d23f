"""PyTorch port, methods/swag.py and methods/rings.py, held against the JAX
package's jitted ``swag_method`` on the CPU: a two-layer MLP with an
``__mle`` parameter, the CIFAR optax chain (the port's SGD), the same
weights and batches. The JAX state comes across through
``models/jax_convert.py::state_from_jax``, which maps JAX's flat order
(sorted keys) to the port's (the module's parameter order, here with the
``__mle`` parameter first).

Tolerances: moments and the fp32 ring atol 1e-6 (six SGD steps of lr 0.05
on O(1) weights, the running means in fp32); the update count and step
counters exactly; the bf16 ring within one bf16 rounding (rtol 2^-7) of
JAX's. A sample is drawn from JAX's own state loaded into the port (its
diagonal std, sqrt(0.5 (sq_mean - mean^2)), turns the moments' last-bit
differences into 1e-4 of a weight after six collections, so the two sides'
own moments are not a fair input) with JAX's own z1 and z2: atol 2e-6."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import swag_method as jax_swag_method
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods import rings, swag_method
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.models.jax_convert import (
    _port_flat, _unravel_sorted, params_from_jax, state_from_jax)
from beyond_deep_ensembles_tpu_torch.models.layers import Dense
from beyond_deep_ensembles_tpu_torch.nn.base import add_auto_named
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

K = 4
CONFIG = {**jax_cifar.DEFAULT_CONFIG, "epochs": 4, "lr": 0.05}


class _JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        scale = self.param("scale__mle", lambda k: jnp.ones(4))
        h = jnp.tanh(fnn.Dense(8)(x))
        return scale * fnn.Dense(4)(h)


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.scale__mle = torch.nn.Parameter(torch.ones(4))
        gen = torch.Generator()
        self.layers = (add_auto_named(self, Dense(12, 8, generator=gen)), add_auto_named(self, Dense(8, 4, generator=gen)))

    def forward(self, x):
        return self.scale__mle * self.layers[1](torch.tanh(self.layers[0](x)))


def _jax_loss(params, model_state, key, batch):
    del key
    x, y = batch
    logp = jax.nn.log_softmax(_JaxMLP().apply({"params": params}, x), axis=-1)
    return JaxLossOutput(loss=-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), model_state=model_state)


def _port_loss(params, model_state, noise, batch):
    del noise
    x, y = batch
    logp = F.log_softmax(params(x), dim=-1)
    return LossOutput(loss=-torch.mean(torch.gather(logp, 1, y[:, None])), model_state=model_state)


def _setup(start_epoch, interval=2, jax_ring=jnp.float32, ring=torch.float32):
    rng = np.random.RandomState(0)
    params = {"Dense_0": {"kernel": 0.5 * rng.standard_normal((12, 8)).astype(np.float32),
                          "bias": 0.1 * rng.standard_normal(8).astype(np.float32)},
              "Dense_1": {"kernel": 0.5 * rng.standard_normal((8, 4)).astype(np.float32),
                          "bias": 0.1 * rng.standard_normal(4).astype(np.float32)},
              "scale__mle": 1.0 + 0.1 * rng.standard_normal(4).astype(np.float32)}
    jmethod = jax_swag_method(_jax_loss, jax_cifar._base_tx(CONFIG, 1), update_interval=interval,
                              start_epoch=start_epoch, deviation_samples=K, ring_dtype=jax_ring)
    jstate = jmethod.init(jax.random.key(0), jax.tree.map(jnp.asarray, params))
    module = _MLP()
    module.load_state_dict(params_from_jax(params))
    method = swag_method(_port_loss, cifar._base_tx(CONFIG, 1), update_interval=interval, start_epoch=start_epoch,
                         deviation_samples=K, ring_dtype=ring)
    return jmethod, jstate, method, method.init(module), params


def _batches(n):
    rng = np.random.RandomState(1)
    return [(rng.standard_normal((16, 12)).astype(np.float32), rng.randint(0, 4, 16)) for _ in range(n)]


def _run(jmethod, jstate, method, state, batches):
    update = jax.jit(jmethod.update)
    for x, y in batches:
        jstate, _ = update(jstate, jax.random.key(0), (jnp.asarray(x), jnp.asarray(y)))
        state, _ = method.update(state, NoiseSource.seeded(0), (torch.from_numpy(x), torch.from_numpy(y)))
    return jstate, state


def _compare(jstate, state, ring_rtol=0.0):
    want = state_from_jax(state.params, jstate, CONFIG["lr"])
    got = state.state_dict()
    assert got.keys() == want.keys()
    for k in ("swag.updates", "swag.steps_since_start", "step", "opt.count"):
        assert int(got[k]) == int(want[k]), k
    for k in ("swag.mean", "swag.sq_mean", "opt.flat"):
        assert_close(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert_close(got["swag.deviations"].float().numpy(), want["swag.deviations"].numpy(), rtol=ring_rtol,
                 atol=1e-6, err_msg="deviations")


def test_six_updates_match_jax():
    """start_epoch 0, a collection every 2 steps: 3 collections, the ring
    rows in JAX's roll order."""
    jmethod, jstate, method, state, _ = _setup(start_epoch=0)
    jstate, state = _run(jmethod, jstate, method, state, _batches(6))
    assert int(state.updates) == int(jstate.updates) == 3
    assert bool((state.deviations[:1] == 0).all()) and not bool((state.deviations[1:] == 0).any())
    _compare(jstate, state)


def test_start_epoch_gate_matches_jax():
    """start_epoch 1: no collection in epoch 0; after finalize_epoch the
    step count since the start runs and a collection follows every 2."""
    jmethod, jstate, method, state, _ = _setup(start_epoch=1)
    batches = _batches(6)
    jstate, state = _run(jmethod, jstate, method, state, batches[:3])
    assert int(state.updates) == 0 and int(state.steps_since_start) == 0
    _compare(jstate, state)
    jstate, state = jmethod.finalize_epoch(jstate), method.finalize_epoch(state)
    assert int(state.epoch) == 1
    jstate, state = _run(jmethod, jstate, method, state, batches[3:])
    assert int(state.updates) == 1 and int(state.steps_since_start) == 3
    _compare(jstate, state)


def test_steps_from_a_converted_mid_run_state_match_jax():
    """Three JAX updates; their state (parameters, the optimizer's trace and
    count, the moments, ring and counters) converted into a fresh port
    state; three more updates on each side."""
    jmethod, jstate, method, state, _ = _setup(start_epoch=0, interval=1)
    batches = _batches(6)
    update = jax.jit(jmethod.update)
    for x, y in batches[:3]:
        jstate, _ = update(jstate, jax.random.key(0), (jnp.asarray(x), jnp.asarray(y)))
    state.load_state_dict(state_from_jax(state.params, jstate, CONFIG["lr"]))
    assert int(state.opt_state[0].count) == 3 and int(state.updates) == 3 and state.step == 3
    jstate, state = _run(jmethod, jstate, method, state, batches[3:])
    assert int(state.opt_state[0].count) == 6 and int(state.updates) == 6
    _compare(jstate, state)


@pytest.mark.parametrize("ring", ["fp32", "bf16"])
def test_sample_with_jax_draws_matches_jax(ring):
    """Six collections held against JAX, then JAX's state loaded into the
    port and one draw with JAX's own z1 and z2 (``split(key)``, in JAX's
    flat order; z2 handed to the port in its order); the ``__mle`` parameter
    keeps its current value. The bf16 ring: the ring held to JAX's at
    bf16, the draw contracted in fp32."""
    jring, tring = (jnp.bfloat16, torch.bfloat16) if ring == "bf16" else (jnp.float32, torch.float32)
    jmethod, jstate, method, state, params = _setup(start_epoch=0, interval=1, jax_ring=jring, ring=tring)
    jstate, state = _run(jmethod, jstate, method, state, _batches(6))
    assert state.deviations.dtype == tring and int(state.updates) == 6
    _compare(jstate, state, ring_rtol=2**-7 if ring == "bf16" else 0.0)

    state.load_state_dict(state_from_jax(state.params, jstate, CONFIG["lr"]))
    key = jax.random.key(11)
    want, _ = jmethod.sample(jstate, key)
    k1, k2 = jax.random.split(key)
    z1 = np.asarray(jax.random.normal(k1, (K,)))
    z2 = np.asarray(jax.random.normal(k2, jstate.mean.shape))
    z2_port = _port_flat(state.params, params_from_jax(_unravel_sorted(params, z2)))
    noise = NoiseSource(given=[torch.from_numpy(z1), z2_port])
    got, _ = method.sample(state, noise, 0)
    assert noise.draws == 2
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k].numpy(), want[k].numpy(), rtol=0, atol=2e-6, err_msg=k)
    assert torch.equal(got["scale__mle"], state.params.scale__mle.detach())
    assert not torch.equal(got["Dense_0.kernel"], state.params.Dense_0.kernel.detach())


def test_sampled_mapping_runs_through_the_model():
    """``Model.apply`` runs a SWAG draw (a name -> tensor mapping) through
    the module, the live parameters untouched."""
    built = cifar.build({**cifar.DEFAULT_CONFIG, "model": "swag"}, torch.Generator().manual_seed(0), 1, device="cpu")
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in built.state.params.state_dict().items()}
    with torch.no_grad():
        params, ms = built.method.sample(built.state, NoiseSource.seeded(0), 0)
        sampled = built.apply_fn(params, ms, None, x)
        live = built.apply_fn(built.state.params, ms, None, x)
        moved = {k: v.clone() for k, v in params.items()}
        for name, p in built.state.params.named_parameters():
            p.copy_(moved[name])
        copied = built.apply_fn(built.state.params, ms, None, x)
        built.state.params.load_state_dict(before)
    assert torch.equal(sampled, copied) and not torch.equal(sampled, live)
    assert all(torch.equal(v, before[k]) for k, v in built.state.params.state_dict().items())


def test_ring_options():
    with pytest.raises(TypeError, match="ring_sharding"):  # not a rings.RingSharding
        swag_method(_port_loss, None, update_interval=1, ring_sharding=object())
    assert rings.pad_flat(torch.ones(5)).shape == (5,)
    stored = rings.store(torch.tensor([1.0 + 2**-10]), torch.bfloat16)
    assert stored.dtype == torch.bfloat16 and rings.load(stored).dtype == torch.float32
    assert float(rings.load(stored)) == 1.0
