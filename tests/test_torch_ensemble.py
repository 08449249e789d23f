"""PyTorch port, methods/ensemble.py (``deep_ensemble``, ``predict`` over an
ensemble), held against the JAX package on the CPU with the same weights
(carried over by ``models/jax_convert.py``) and the same batches.

Tolerances:
  * ``deep_ensemble(map_method)``, M = 2 plain ResNet-20s, three jitted
    updates at batch 4 without augmentation under the CIFAR optax chain (the
    port's SGD): parameters atol 2e-6 (fp32 steps of lr 0.05, the sums
    taken in other orders), metrics and ``*_per_member`` rtol 1e-5;
  * ``deep_ensemble(bbb_method)`` of a two-layer BBB MLP with the JAX
    draws given (jitted, so one set of draws serves every step, every MC
    sample of the scanned loop and, being drawn outside the member axis,
    every member): the same bounds;
  * ``predict`` over map members: 1e-6, member ``i % M`` for sample i."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import (  # noqa: F401 (one_cpu_thread: a fixture)
    assert_close, install_feed, nchw, one_cpu_thread, random_jax_params, to_numpy_tree)
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import GaussianPrior as JaxGaussianPrior
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import bbb_method as jax_bbb_method
from beyond_deep_ensembles_tpu.methods import deep_ensemble as jax_deep_ensemble
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu.methods import predict as jax_predict
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu.nn.bbb import BBBDense as JaxBBBDense
from beyond_deep_ensembles_tpu.tree import tree_stack as jax_tree_stack
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble, predict
from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior, LossOutput
from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
from beyond_deep_ensembles_tpu_torch.methods.map import map_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import particles_from_jax
from beyond_deep_ensembles_tpu_torch.nn.base import Model, add_auto_named
from beyond_deep_ensembles_tpu_torch.nn.bbb import BBBDense
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

MEMBERS = 2
CONFIG = {**jax_cifar.DEFAULT_CONFIG, "model": "map", "members": MEMBERS, "weight_decay": 3e-4, "epochs": 2,
          "dataset_size": 1000, "augment": False}


def _batches(n_steps, shape, classes, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((batch, *shape)).astype(np.float32), rng.randint(0, classes, batch))
            for _ in range(n_steps)]


def _load_members(state, stacked):
    for member, state_dict in zip(state.members, particles_from_jax(to_numpy_tree(stacked))):
        member.params.load_state_dict(state_dict, strict=True)


def _check_members(state, stacked, atol):
    for m, (member, ref) in enumerate(zip(state.members, particles_from_jax(to_numpy_tree(stacked)))):
        got = {k: p.detach().numpy() for k, p in member.params.named_parameters()}
        assert got.keys() == ref.keys()
        for k in ref:
            assert_close(got[k], ref[k].numpy(), atol=atol, rtol=0, err_msg=f"member {m} {k}")


def _check_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == np.shape(want[k])
        assert_close(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)


def test_three_map_ensemble_steps_match_jax():
    model = jax_cifar._resnet(CONFIG)
    method = jax_deep_ensemble(
        jax_map_method(jax_cifar._xent_loss_fn(model, augment=False), jax_cifar._base_tx(CONFIG, 1)), MEMBERS)
    stacked = jax_tree_stack([random_jax_params(model.module, (2, 32, 32, 3), seed=i) for i in range(MEMBERS)])
    state = method.init(jax.random.key(0), stacked, {})
    update = jax.jit(method.update)

    built = cifar.build(CONFIG, torch.Generator().manual_seed(0), 1, device="cpu")
    _load_members(built.state, stacked)
    for i, (x, y) in enumerate(_batches(3, (32, 32, 3), 10)):
        state, want = update(state, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        built.state, got = built.method.update(built.state, NoiseSource.seeded(i), (nchw(x), torch.from_numpy(y)))
        assert set(got) == {"loss", "acc", "loss_per_member", "acc_per_member"}
        _check_metrics(got, want)
    assert built.state.step == 3 and all(int(m.opt_state[0].count) == 3 for m in built.state.members)
    _check_members(built.state, state.params, atol=2e-6)


class _JaxTinyBBB(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        h = jnp.tanh(JaxBBBDense(8)(x, train=train))
        return JaxBBBDense(5)(h, train=train)


class _TinyBBB(torch.nn.Module):
    def __init__(self, generator):
        super().__init__()
        self.layers = (add_auto_named(self, BBBDense(12, 8, generator=generator)),
                       add_auto_named(self, BBBDense(8, 5, generator=generator)))

    def forward(self, x, noise, train=True):
        return self.layers[1](torch.tanh(self.layers[0](x, noise, train)), noise, train)


def _jax_xent(model):
    def loss_fn(params, model_state, key, batch):
        x, y = batch
        out, kl, _ = model.apply(params, model_state, key, x, train=True)
        logp = jax.nn.log_softmax(out, axis=-1)
        return JaxLossOutput(loss=-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), kl=kl)
    return loss_fn


def _port_xent(model):
    def loss_fn(params, model_state, noise, batch):
        x, y = batch
        out, kl, _ = model.apply(params, model_state, noise, x, train=True)
        return LossOutput(loss=-torch.mean(torch.gather(F.log_softmax(out, -1), 1, y[:, None])), kl=kl)
    return loss_fn


def test_bbb_ensemble_steps_match_jax_with_given_draws(monkeypatch):
    """Three jitted steps of ``deep_ensemble(bbb_method)`` (mc 2) with the
    JAX draws handed to the port: each member takes its draws in turn."""
    config = {**CONFIG, "lr": 0.1}
    jmodel = JaxModel(_JaxTinyBBB())
    jmethod = jax_deep_ensemble(jax_bbb_method(
        _jax_xent(jmodel), jax_cifar._base_tx(config, 1), JaxGaussianPrior(0.0, 1.0), dataset_size=100,
        mc_samples=2, kl_rescaling=0.2), MEMBERS)
    stacked = jax_tree_stack([random_jax_params(jmodel.module, (2, 12), seed=i) for i in range(MEMBERS)])
    state = jmethod.init(jax.random.key(0), stacked, {})
    feed = install_feed(monkeypatch, seed=5)
    update = jax.jit(jmethod.update)

    modules = [_TinyBBB(torch.Generator().manual_seed(i)) for i in range(MEMBERS)]
    method = deep_ensemble(bbb_method(
        _port_xent(Model(modules[0])), cifar._base_tx(config, 1), GaussianPrior(0.0, 1.0), dataset_size=100,
        mc_samples=2, kl_rescaling=0.2), MEMBERS)
    port = method.init(modules)
    _load_members(port, stacked)
    for i, (x, y) in enumerate(_batches(3, (12,), 5)):
        state, want = update(state, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        # one draw per layer: the MC loop is a scan, its body traced once,
        # so both samples of every member take the same two draws
        assert len(feed.draws) == 2
        noise = NoiseSource(given=[torch.from_numpy(d) for d in feed.draws] * 2 * MEMBERS)
        port, got = method.update(port, noise, (torch.from_numpy(x), torch.from_numpy(y)))
        assert noise.draws == 4 * MEMBERS
        _check_metrics(got, want)
    _check_members(port, state.params, atol=2e-6)


def test_member_noise_is_the_key_folded_with_the_index():
    """In key mode each member draws from ``fold_in(key, m)``, so members
    draw different noise and the same key draws the same noise again."""
    key = keys.as_key(keys.fold_in(3, 1), "cpu")
    noise = NoiseSource(key=key)
    a, b = noise.member(0), noise.member(1)
    assert int(a.key) == keys.fold_in(keys.fold_in(3, 1), 0) and int(b.key) == keys.fold_in(keys.fold_in(3, 1), 1)
    shape = (4, 6)
    za = a.normal(shape, "cpu", True, False)
    assert not torch.equal(za, b.normal(shape, "cpu", True, False))
    assert torch.equal(za, NoiseSource(key=key).member(0).normal(shape, "cpu", True, False))
    given = NoiseSource(given=[torch.zeros(1)])
    assert given.member(1) is given


@pytest.mark.parametrize("n_samples", [3, 7])
def test_predict_over_map_members_matches_jax(n_samples):
    """3 members of a linear model, S = 3 and 7 (cycling back): the stacked
    log-probs equal the JAX ``predict``'s, member i % 3 for sample i."""
    rng = np.random.RandomState(3)
    w = rng.standard_normal((3, 48, 5)).astype(np.float32)
    x = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)

    jmethod = jax_deep_ensemble(jax_map_method(None, optax.sgd(0.1)), 3)
    jstate = jmethod.init(jax.random.key(0), {"w": jnp.asarray(w)})
    ref = jax_predict(
        jmethod, jstate, lambda p, s, k, xb: jax.nn.log_softmax(xb.reshape(xb.shape[0], -1) @ p["w"]),
        jnp.asarray(x), n_samples=n_samples, key=jax.random.key(1),
    )

    modules = [torch.nn.Module() for _ in range(3)]
    for i, m in enumerate(modules):
        m.w = torch.nn.Parameter(torch.from_numpy(w[i].copy()))
    method = deep_ensemble(map_method(None, lambda p: (SGD(p, 0.1), None)), 3)
    state = method.init(modules)
    seen = []

    def apply_fn(params, model_state, noise, xb):
        seen.append(params)
        return F.log_softmax(xb.permute(0, 2, 3, 1).reshape(xb.shape[0], -1) @ params.w, dim=-1)

    with torch.no_grad():
        got = predict(method, state, apply_fn, torch.from_numpy(x).permute(0, 3, 1, 2), n_samples, noise=None)
    assert not method.sample_is_identity
    assert [modules.index(p) for p in seen] == [i % 3 for i in range(n_samples)]
    assert got.shape == (n_samples, 6, 5)
    assert_close(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6, err_msg="predict")


def test_ensemble_finalize_epoch_and_unported_arguments():
    modules = [torch.nn.Module() for _ in range(2)]
    for m in modules:
        m.w = torch.nn.Parameter(torch.zeros(3))
    method = deep_ensemble(map_method(None, lambda p: (SGD(p, 0.1), None)), 2)
    state = method.finalize_epoch(method.init(modules))
    assert [m.epoch for m in state.members] == [1, 1]
    with pytest.raises(ValueError):
        method.init(modules[:1])
    with pytest.raises(NotImplementedError):
        method.init(modules, model_state={"stacked": torch.zeros(2)})
