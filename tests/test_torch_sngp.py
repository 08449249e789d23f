"""PyTorch port, the SNGP slice: ``nn/spectral_norm.py``, ``nn/sngp.py``
(``RandomFourierFeatures``, ``SNGPHead``, ``recompute_covariance_and_reset``),
``methods/sngp.py`` and the CIFAR build's frozen head, held against the JAX
package on the CPU with JAX's parameters and state (spectral ``u``, RFF
``W`` and ``b``, precision, covariance) loaded into the port
(``models/jax_convert.py::buffers_from_jax``) and JAX's MC draws given.

Tolerances: spectral layers' outputs, ``u`` and gradients 1e-5 (relative
and absolute: power iteration and products in fp32, sums in other orders);
the head's logits and the precision 1e-5 relative, 1e-4 absolute on the
precision (sums of 16 outer products of entries near 1); the covariance
(a Cholesky inverse, LAPACK in both) 1e-4 relative and 1e-5 absolute; three
``sngp_method`` steps of the SNGP ResNet-20 at lr 0.01, where the JAX
package's own jitted and op-by-op updates part by 8.5e-6 in the parameters,
2.3e-3 in the precision (entries near 13) and 1e-5 relative in the loss:
parameters 2e-5 absolute, ``u`` 1e-5, the precision 1e-2 absolute (the
port's gap 6.3e-3: the RFF features move with the parameters), the
loss 1e-4 relative; the covariance after the boundary, from the port's
precision, 1e-4 relative; the frozen ``beta`` bit for bit."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close, flat_jax, nchw, record_jax_normals
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import predict as jax_predict
from beyond_deep_ensembles_tpu.methods import sngp_method as jax_sngp_method
from beyond_deep_ensembles_tpu.nn import sngp as jax_sngp
from beyond_deep_ensembles_tpu.nn import spectral_norm as jax_sn
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods import predict, sngp_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import buffers_from_jax, params_from_jax
from beyond_deep_ensembles_tpu_torch.nn.base import Model
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.nn.sngp import SNGPHead, recompute_covariance_and_reset
from beyond_deep_ensembles_tpu_torch.nn.spectral_norm import SpectralNormConv, SpectralNormDense
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

GEN = torch.Generator().manual_seed(0)
TOL = {"rtol": 1e-5, "atol": 1e-5}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, params, state):
    module.load_state_dict({**params_from_jax(_numpy(params)), **buffers_from_jax(_numpy(state))}, strict=True)
    return module


@pytest.mark.parametrize("scale", [30.0, 1e-3], ids=["capped", "uncapped"])
@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_spectral_norm_layer_matches_jax(kind, scale):
    """A training forward (``u`` advanced and stored, gradients through W in
    sigma) and an eval forward (``u`` not stored), from JAX's warmed-up
    ``u``; the kernel scaled so the bound of 1.5 binds, or not."""
    rng = np.random.RandomState(0)
    if kind == "dense":
        jmod = jax_sn.SpectralNormDense(5, norm_bound=1.5)
        x = rng.standard_normal((4, 6)).astype(np.float32)
        port = SpectralNormDense(6, 5, norm_bound=1.5, generator=GEN)
    else:
        jmod = jax_sn.SpectralNormConv(4, (3, 3), strides=2, padding=1, norm_bound=1.5)
        x = rng.standard_normal((2, 7, 7, 3)).astype(np.float32)
        port = SpectralNormConv(3, 4, (3, 3), strides=2, padding=1, norm_bound=1.5, generator=GEN)
    variables = jmod.init(jax.random.key(1), x)
    params = jax.tree.map(lambda v: v * scale if v.ndim > 1 else v + 0.1, variables["params"])
    state = {"spectral_norm": variables["spectral_norm"]}
    _load(port, params, state)
    cot = rng.standard_normal(jax.eval_shape(lambda: jmod.apply({"params": params, **state}, x, train=False)).shape)

    def loss(p, xx):
        out, new = jmod.apply({"params": p, **state}, xx, train=True, mutable=["spectral_norm"])
        return jnp.sum(out * cot), (out, new)

    (_, (want, new)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    got = port(xt, train=True)
    (got * nchw(cot.astype(np.float32))).sum().backward()
    assert_close(got.detach().numpy(), nchw(np.asarray(want)).numpy(), **TOL, err_msg="train output")
    assert_close(port.kernel_u.numpy(), np.asarray(new["spectral_norm"]["kernel_u"]), **TOL, err_msg="u")
    assert_close(xt.grad.numpy(), nchw(np.asarray(gx)).numpy(), **TOL, err_msg="input grad")
    ref = params_from_jax(_numpy(gp))
    for name, p in port.named_parameters():
        assert_close(p.grad.numpy(), ref[name].numpy(), **TOL, err_msg=name)

    u = port.kernel_u.clone()
    want_eval = jmod.apply({"params": params, **new}, x, train=False)
    with torch.no_grad():
        got_eval = port(nchw(x), train=False)
    assert torch.equal(port.kernel_u, u)
    assert_close(got_eval.numpy(), nchw(np.asarray(want_eval)).numpy(), **TOL, err_msg="eval output")


def test_spectral_norm_caps_sigma():
    """After power iterations the capped kernel's top singular value is the
    bound (JAX ``tests/test_sngp.py``'s check on the port)."""
    layer = SpectralNormDense(8, 8, norm_bound=1.5, generator=GEN)
    with torch.no_grad():
        layer.kernel.mul_(100.0)
    x = torch.randn(16, 8, generator=GEN)
    for _ in range(30):
        layer(x, train=True)
    with torch.no_grad():
        w = layer.kernel * layer._scale(False)
    assert abs(float(torch.linalg.matrix_norm(w, ord=2)) - 1.5) < 0.05 * 1.5


HEADS = {
    "cifar": {"num_random_features": 64, "num_gp_features": -1, "normalize_gp_features": False,
              "ridge_penalty": 1.0, "mean_field_factor": 20.0, "feature_scale": 1.0, "rff_init_std": 0.05},
    # the ridge of 1, not the head's default 1e-3: 16 examples of 48 features
    # leave the precision of rank 16 plus the ridge, and the inverse of a
    # matrix of condition 1e6 differs in fp32 from one LAPACK to the other
    "jl_layernorm": {"num_random_features": 48, "num_gp_features": 6, "normalize_gp_features": True,
                     "ridge_penalty": 1.0, "mean_field_factor": 0.25, "feature_scale": None, "rff_init_std": 1.0},
}


@pytest.mark.parametrize("head", list(HEADS))
def test_sngp_head_matches_jax(head, monkeypatch):
    """Training forward (logits, the precision and ``seen_data``), the
    epoch-boundary covariance, then eval: mean field at S = 1 and S = 3, and
    ``"mc"`` at S = 3 with JAX's draws given."""
    kw = HEADS[head]
    rng = np.random.RandomState(2)
    f = rng.standard_normal((16, 10)).astype(np.float32)
    jhead = jax_sngp.SNGPHead(outputs=3, **kw)
    variables = jhead.init({"params": jax.random.key(3), "noise": jax.random.key(4)}, f)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    port = _load(SNGPHead(10, 3, **kw, generator=GEN), params, state)
    assert sorted(dict(port.named_buffers())) == sorted(buffers_from_jax(_numpy(state)))

    want, new = jhead.apply({"params": params, **state}, f, train=True, mutable=["sngp"])
    got = port(torch.from_numpy(f), train=True)
    assert_close(got.detach().numpy(), np.asarray(want), **TOL, err_msg="train logits")
    assert_close(port.precision.numpy(), np.asarray(new["sngp"]["precision"]), rtol=1e-5, atol=1e-4,
                 err_msg="precision")
    assert int(port.seen_data) == int(new["sngp"]["seen_data"]) == 16

    reset = jax_sngp.recompute_covariance_and_reset(jax.tree.map(np.asarray, new["sngp"]), kw["ridge_penalty"])
    recompute_covariance_and_reset(port, kw["ridge_penalty"])
    assert_close(port.covariance.numpy(), np.asarray(reset["covariance"]), rtol=1e-4, atol=1e-5, err_msg="covariance")
    assert torch.equal(port.precision, kw["ridge_penalty"] * torch.eye(kw["num_random_features"]))
    assert int(port.seen_data) == 0
    # eval from JAX's covariance, so that the correction is compared alone
    state = {**state, "sngp": reset}
    port.covariance.copy_(torch.from_numpy(np.asarray(reset["covariance"])))
    with torch.no_grad():
        for n_samples in (1, 3):
            want = jhead.apply({"params": params, **state}, f, train=False, n_samples=n_samples)
            got = port(torch.from_numpy(f), train=False, n_samples=n_samples)
            assert got.shape == want.shape
            assert_close(got.numpy(), np.asarray(want), **TOL, err_msg=f"mean field S {n_samples}")

    jmc = jax_sngp.SNGPHead(outputs=3, sampling_mode="mc", **kw)
    draws = record_jax_normals(monkeypatch, jax_sngp)
    want = jmc.apply({"params": params, **state}, f, train=False, n_samples=3, rngs={"noise": jax.random.key(5)})
    jax.effects_barrier()
    mc = _load(SNGPHead(10, 3, sampling_mode="mc", **kw, generator=GEN), params, state)
    with torch.no_grad():
        got = mc(torch.from_numpy(f), NoiseSource(given=[torch.from_numpy(d) for d in draws]), train=False, n_samples=3)
    assert_close(got.numpy(), np.asarray(want), **TOL, err_msg="mc")


class JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True, n_samples: int = 1):
        h = fnn.relu(jax_sn.SpectralNormDense(8, norm_bound=2.0)(x, train=train))
        return jax_sngp.SNGPHead(outputs=3, **HEADS["cifar"])(h, train=train, n_samples=n_samples)


class TorchTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.SpectralNormDense_0 = SpectralNormDense(4, 8, norm_bound=2.0, generator=GEN)
        self.SNGPHead_0 = SNGPHead(8, 3, **HEADS["cifar"], generator=GEN)

    def forward(self, x, noise=None, train=True, n_samples=1):
        h = torch.relu(self.SpectralNormDense_0(x, train=train))
        return self.SNGPHead_0(h, noise, train=train, n_samples=n_samples)


@pytest.mark.parametrize("n_samples", [1, 4])
def test_predict_multisample_matches_jax(n_samples):
    """``predict`` of ``sngp_method``: one forward for all S samples, the
    samples axis restored at S = 1."""
    x = np.random.RandomState(6).standard_normal((5, 4)).astype(np.float32)
    jmodel = JaxModel(JaxTiny())
    params, ms = jmodel.init(jax.random.key(7), jnp.asarray(x))
    jmethod = jax_sngp_method(None, optax.sgd(0.1))
    jstate = jmethod.init(jax.random.key(8), params, ms)

    def japply(p, s, key, xx, n_samples=None):
        return jax.nn.log_softmax(jmodel.apply(p, s, key, xx, train=False, n_samples=n_samples)[0], axis=-1)

    want = jax_predict(jmethod, jstate, japply, jnp.asarray(x), n_samples, jax.random.key(9))

    model = Model(_load(TorchTiny(), params, ms))
    method = sngp_method(None, lambda p: (SGD(p, 0.1), None))

    def apply(p, s, noise, xx, n_samples=None):
        return torch.log_softmax(model.apply(p, s, noise, xx, train=False, n_samples=n_samples)[0], dim=-1)

    with torch.no_grad():
        got = predict(method, method.init(model.module), apply, torch.from_numpy(x), n_samples, NoiseSource.seeded(0))
    assert got.shape == (n_samples, 5, 3)
    assert_close(got.numpy(), np.asarray(want), **TOL, err_msg="predict")


# lr 0.01: at the config's 0.05 three steps on four noise images are chaotic
# (the JAX package's own jitted and op-by-op updates part by 1.2e-3 in the
# third loss; at 0.01 by 1e-5)
SNGP = {**jax_cifar.DEFAULT_CONFIG, "model": "sngp", "members": 1, "epochs": 2, "dataset_size": 1000, "augment": False,
        "lr": 0.01, "sngp": {**jax_cifar.DEFAULT_CONFIG["sngp"], "num_random_features": 32}}


def test_sngp_build_steps_finalize_eval_match_jax():
    """The CIFAR build (``SNGPResNet20``, the head frozen): three jitted
    ``sngp_method`` updates at batch 4, then ``finalize_epoch``, then
    ``eval_model``; the backbone's parameters, every spectral ``u``, the
    precision and ``seen_data`` after the steps, the covariance and the
    reset after the boundary, the eval metrics (within 1e-5, as
    ``test_torch_cifar_multix``); ``beta`` bit for bit at its init."""
    jbuilt = jax_cifar.build(SNGP, jax.random.key(0), 1)
    jstate = jbuilt.state
    built = cifar.build(SNGP, torch.Generator().manual_seed(0), 1, device="cpu")
    state = built.state
    state.params.load_state_dict({**params_from_jax(_numpy(jstate.params)),
                                  **buffers_from_jax(_numpy(jstate.model_state))}, strict=True)
    beta = {k: v.clone() for k, v in state.params.SNGPHead_0.beta.state_dict().items()}
    rng = np.random.RandomState(9)
    batches = [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32), rng.randint(0, 10, 4)) for _ in range(3)]
    update = jax.jit(jbuilt.method.update)
    for i, (x, y) in enumerate(batches):
        jstate, jm = update(jstate, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        state, m = built.method.update(state, NoiseSource.seeded(i), (nchw(x), torch.from_numpy(y)))
        assert_close(float(m["loss"]), float(jm["loss"]), rtol=1e-4, err_msg="loss")
    ref = flat_jax(jstate.params)
    for k, p in state.params.named_parameters():
        assert_close(p.detach().numpy(), ref[k], atol=2e-5, rtol=0, err_msg=k)
    for k, v in beta.items():
        assert torch.equal(getattr(state.params.SNGPHead_0.beta, k), v), f"beta.{k} moved"
        np.testing.assert_array_equal(np.asarray(jstate.params["SNGPHead_0"]["beta"][k]).T
                                      if k == "kernel" else np.asarray(jstate.params["SNGPHead_0"]["beta"][k]),
                                      v.numpy())
    buffers = buffers_from_jax(_numpy(jstate.model_state))
    for k, b in state.params.named_buffers():
        if k.endswith("kernel_u"):
            assert_close(b.numpy(), buffers[k].numpy(), **TOL, err_msg=k)
    head = state.params.SNGPHead_0
    assert_close(head.precision.numpy(), buffers["SNGPHead_0.precision"].numpy(), rtol=0, atol=1e-2,
                 err_msg="precision")
    assert int(head.seen_data) == 12

    # the boundary, held on the port's own precision (the trajectories' gap
    # above would otherwise dominate the inverse's)
    mine = {"SNGPHead_0": {"precision": head.precision.numpy().copy(), "covariance": np.eye(32, dtype=np.float32),
                           "seen_data": np.int32(12)}}
    jstate = jbuilt.method.finalize_epoch(jstate.replace(model_state={**jstate.model_state, "sngp": mine}))
    covariance = head.covariance
    state = built.method.finalize_epoch(state)
    assert state.epoch == 1 == int(jstate.epoch) and head.covariance is covariance  # written in place
    buffers = buffers_from_jax(_numpy(jstate.model_state))
    assert_close(head.covariance.numpy(), buffers["SNGPHead_0.covariance"].numpy(), rtol=1e-4, atol=1e-5,
                 err_msg="covariance")
    assert torch.equal(head.precision, buffers["SNGPHead_0.precision"]) and int(head.seen_data) == 0

    # eval_model of the two states (host loops): 24 images at eval batch 10,
    # S = 2 (mean field, one forward broadcast to both samples)
    jbuilt.state = jstate
    eval_config = {**SNGP, "eval_samples": 2, "eval_batch_size": 10}
    xt, yt = rng.standard_normal((24, 32, 32, 3)).astype(np.float32), rng.randint(0, 10, 24)
    want = jax_cifar.eval_model(jbuilt, eval_config, xt, yt).as_dict()
    got = cifar.eval_model(built, {**eval_config, "device_eval": False}, xt, yt).as_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_beta_opts_out_of_the_frozen_head():
    """``sngp_train_beta: True`` hands the SGD the head too: beta moves."""
    built = cifar.build({**SNGP, "sngp_train_beta": True}, torch.Generator().manual_seed(0), 1, device="cpu")
    beta = built.state.params.SNGPHead_0.beta.kernel.detach().clone()
    rng = np.random.RandomState(10)
    x, y = rng.standard_normal((4, 32, 32, 3)).astype(np.float32), rng.randint(0, 10, 4)
    built.method.update(built.state, NoiseSource.seeded(0), (nchw(x), torch.from_numpy(y)))
    assert not torch.equal(built.state.params.SNGPHead_0.beta.kernel, beta)
