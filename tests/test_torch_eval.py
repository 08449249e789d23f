"""PyTorch port, evals/classification.py + evals/calibration.py +
experiments/cifar.py::eval_model: BMA, analyze_output, ECE/MCE/ACE/signed
ECE on static and adaptive bins, the eval loop's padded last batch, and
``predict`` over SVGD particles (sample i evaluates particle i % n), held
against the JAX package on the same log-probs and parameters.

Tolerance: 1e-6 (fp32 sums over at most a few hundred points)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.evals import calibration as jax_cal
from beyond_deep_ensembles_tpu.evals import classification as jax_cls
from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
from beyond_deep_ensembles_tpu.methods import GaussianPrior as JaxGaussianPrior
from beyond_deep_ensembles_tpu.methods import bbb_method as jax_bbb_method
from beyond_deep_ensembles_tpu.methods import predict as jax_predict
from beyond_deep_ensembles_tpu.methods import svgd_method as jax_svgd_method
from beyond_deep_ensembles_tpu_torch.evals import calibration as cal
from beyond_deep_ensembles_tpu_torch.evals import classification as cls
from beyond_deep_ensembles_tpu_torch.experiments import cifar
from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior, MethodState
from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
from beyond_deep_ensembles_tpu_torch.methods.ensemble import predict
from beyond_deep_ensembles_tpu_torch.methods.svgd import svgd_method

TOL = dict(rtol=1e-6, atol=1e-6)


def _log_probs(s=5, b=200, c=10, seed=0):
    logits = 3.0 * np.random.RandomState(seed).standard_normal((s, b, c)).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def test_bma_and_analyze_output():
    lp = _log_probs()
    ref = jax_cls.bayesian_model_average(jnp.asarray(lp))
    got = cls.bayesian_model_average(torch.from_numpy(lp))
    assert_close(got.numpy(), np.asarray(ref), **TOL)

    target = np.random.RandomState(1).randint(0, 10, lp.shape[1])
    base = cls.bayesian_model_average(torch.from_numpy(_log_probs(seed=2)))
    jref = jax_cls.analyze_output(ref, jnp.asarray(target), jnp.asarray(base.numpy()))
    port = cls.analyze_output(got, torch.from_numpy(target), base)
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(jref[0]))
    for a, b in zip(port[1:], jref[1:]):
        assert_close(a.numpy(), np.asarray(b), **TOL)
    assert cls.analyze_output(got, torch.from_numpy(target))[3] is None


def _points(n, seed):
    rng = np.random.RandomState(seed)
    conf = rng.uniform(0.1, 1.0, n).astype(np.float32)
    conf[:3] = [0.0, 1.0, 0.5]  # bin edges, ends included
    correct = rng.rand(n) < conf
    return correct, conf


@pytest.mark.parametrize("bins", [1, 10, 15])
@pytest.mark.parametrize("n", [7, 100, 257])
def test_calibration_errors(bins, n):
    correct, conf = _points(n, seed=n + bins)
    jc, jf = jnp.asarray(correct), jnp.asarray(conf)
    tc, tf = torch.from_numpy(correct), torch.from_numpy(conf)
    for name in ("calculate_ece", "calculate_mce", "calculate_ace"):
        ref = getattr(jax_cal, name)(bins, jc, jf)
        assert_close(getattr(cal, name)(bins, tc, tf).numpy(), np.asarray(ref), err_msg=name, **TOL)
    ref = jax_cal.CalibrationResults.create(bins, jc, jf)
    got = cal.CalibrationResults.create(bins, tc, tf)
    for f in ("bin_counts", "bin_accuracys", "bin_confidences", "ece", "signed_ece"):
        assert_close(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f, **TOL)


def test_eval_result():
    correct, conf = _points(300, seed=5)
    ll = np.log(np.clip(conf, 1e-3, 1.0)).astype(np.float32)
    ref = jax_cls.EvalResult.create(jnp.asarray(correct), jnp.asarray(conf), jnp.asarray(ll), 10)
    got = cls.EvalResult.create(torch.from_numpy(correct), torch.from_numpy(conf), torch.from_numpy(ll), 10)
    a, b = got.as_dict(), ref.as_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert_close(a[k], b[k], err_msg=k, **TOL)


def test_eval_model_pads_and_trims_last_batch():
    """7 test points at eval batch 3: the last batch is padded with its last
    image and trimmed, on both sides, with a deterministic linear model so
    the noise streams play no part."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((7, 4, 4, 3)).astype(np.float32)
    y = rng.randint(0, 5, 7)
    w = rng.standard_normal((48, 5)).astype(np.float32)
    config = {"eval_batch_size": 3, "eval_samples": 2, "ece_bins": 10, "model": "bbb"}

    jmethod = jax_bbb_method(None, optax.sgd(0.1), JaxGaussianPrior(), dataset_size=1)
    jbuilt = jax_cifar.BuiltExperiment(
        model=None, method=jmethod, state=jmethod.init(jax.random.key(0), {"w": jnp.asarray(w)}),
        apply_fn=lambda p, s, k, xb: jax.nn.log_softmax(xb.reshape(xb.shape[0], -1) @ p["w"]),
    )
    ref = jax_cifar.eval_model(jbuilt, config, x, y).as_dict()

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w))
    method = bbb_method(None, lambda p: (None, None), GaussianPrior(), dataset_size=1)
    seen = []

    def apply_fn(params, model_state, noise, xb):
        seen.append(xb.shape[0])
        return F.log_softmax(xb.permute(0, 2, 3, 1).reshape(xb.shape[0], -1) @ params.w, dim=-1)

    built = cifar.BuiltExperiment(
        model=None, method=method, state=MethodState(module, {}, None), apply_fn=apply_fn,
        device=torch.device("cpu"),
    )
    got = cifar.eval_model(built, config, x, y).as_dict()
    assert seen == [3] * 6  # 3 batches x 2 samples, the last one padded to 3
    assert got.keys() == ref.keys()
    for k in got:
        assert_close(got[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("n_samples", [3, 7])
def test_predict_over_particles_matches_jax(n_samples):
    """4 particles of a linear model, S = 3 (fewer than the particles) and
    7 (cycling back): the stacked log-probs equal the JAX ``predict``'s."""
    rng = np.random.RandomState(3)
    w = rng.standard_normal((4, 48, 5)).astype(np.float32)
    x = rng.standard_normal((6, 4, 4, 3)).astype(np.float32)

    jmethod = jax_svgd_method(None, optax.sgd(0.1), particle_count=4, dataset_size=1)
    jstate = jmethod.init(jax.random.key(0), {"w": jnp.asarray(w)})
    ref = jax_predict(
        jmethod, jstate, lambda p, s, k, xb: jax.nn.log_softmax(xb.reshape(xb.shape[0], -1) @ p["w"]),
        jnp.asarray(x), n_samples=n_samples, key=jax.random.key(1),
    )

    particles = torch.nn.ModuleList(torch.nn.Module() for _ in range(4))
    for i, m in enumerate(particles):
        m.w = torch.nn.Parameter(torch.from_numpy(w[i].copy()))
    method = svgd_method(None, lambda p: (torch.optim.SGD(p, lr=0.1), None), particle_count=4, dataset_size=1)
    state = method.init(particles)
    seen = []

    def apply_fn(params, model_state, noise, xb):
        seen.append(params)
        return F.log_softmax(xb.permute(0, 2, 3, 1).reshape(xb.shape[0], -1) @ params.w, dim=-1)

    with torch.no_grad():
        got = predict(method, state, apply_fn, torch.from_numpy(x).permute(0, 3, 1, 2), n_samples, noise=None)
    assert [list(particles).index(p) for p in seen] == [i % 4 for i in range(n_samples)]
    assert got.shape == (n_samples, 6, 5)
    assert_close(got.numpy(), np.asarray(ref), **TOL)
