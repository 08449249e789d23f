"""PyTorch port, methods/laplace.py (last-layer Laplace: ``full``, ``diag``
and ``kron``) held against the JAX package on the CPU, on a 2-member
deep-ensemble state of a two-layer classifier (the GGN of its head, D = 16 x
4 + 4 = 68), fitted per member on the same 40 examples in batches of 16.

The JAX functions' intermediate values are read by wrapping its ``jax.jit``
(each jitted call's outputs recorded: the per-batch GGN, the 33-point
marginal-likelihood grid) and its ``jax.random.normal`` (the draws).

Tolerances:
  * the marginal likelihood at the 33 grid points: rtol 1e-5 for the port's
    function on JAX's curvature and log-likelihood; rtol 1e-4 end to end,
    each side on its own H (gap 3.1e-5 at pp 1e-4: there the curve reads
    H's null directions, the softmax GGN's, which are fp32 rounding, times
    1/pp);
  * the prior precision: the two fp32 curves are flat near their optimum,
    so the port's pp must score, on JAX's own curve, within 1e-5 relative of
    the best JAX value found (the curve's tolerance, the same measure);
  * given JAX's pp: H (and ``kron``'s eigenvalues and factors, compared as
    the matrices they rebuild, since eigenvectors carry signs) rtol 1e-5,
    atol 1e-6 of the largest entry; ``scale_tril`` / ``diag_scale`` rtol
    1e-4, atol 1e-6 (a Cholesky inverse of a matrix of condition ~1e3);
  * a draw with JAX's z from JAX's fitted state: atol 1e-6;
  * the CIFAR row's ``build`` -> ``train`` -> fit -> ``eval_model`` against
    the JAX package's: metrics within 1e-5 (as ``test_torch_cifar_multix``)."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import (PARITY, JaxShim, assert_close, random_jax_params,
                           record_jax_normals, run_both, to_numpy_tree)
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import deep_ensemble as jax_deep_ensemble
from beyond_deep_ensembles_tpu.methods import laplace as jax_laplace
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu.tree import tree_stack as jax_tree_stack
from beyond_deep_ensembles_tpu_torch.methods import deep_ensemble, laplace_method
from beyond_deep_ensembles_tpu_torch.methods import laplace as port_laplace
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.methods.ensemble import EnsembleState
from beyond_deep_ensembles_tpu_torch.methods.laplace import LaplaceState, last_layer_mask
from beyond_deep_ensembles_tpu_torch.methods.map import map_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import particles_from_jax, state_from_jax
from beyond_deep_ensembles_tpu_torch.models.layers import Dense
from beyond_deep_ensembles_tpu_torch.nn.base import Model, add_auto_named
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD

GEN = torch.Generator().manual_seed(0)
MEMBERS, BATCH = 2, 16


class JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        h = jax.nn.relu(fnn.Dense(16)(x))
        return fnn.Dense(4)(h)


class TorchNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        add_auto_named(self, Dense(5, 16, generator=GEN))
        add_auto_named(self, Dense(16, 4, generator=GEN))

    def forward(self, x, noise=None, train=True):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


@pytest.fixture
def recorded(monkeypatch):
    """JAX's jitted calls' outputs and draws, in call order:
    ``[("jit", outputs) | ("normal", array)]``."""
    calls = []

    def jit(fn, **kw):
        compiled = jax.jit(fn, **kw)

        def run(*args):
            out = compiled(*args)
            calls.append(("jit", jax.tree.map(np.asarray, out)))
            return out

        return run

    def normal(key, shape=(), dtype=jnp.float32):
        value = jax.random.normal(key, shape, dtype)
        calls.append(("normal", np.asarray(value)))
        return value

    monkeypatch.setattr(jax_laplace, "jax", JaxShim(jax, jit=jit, random=JaxShim(jax.random, normal=normal)))
    return calls


def _data():
    rng = np.random.RandomState(0)
    return rng.standard_normal((40, 5)).astype(np.float32), rng.randint(0, 4, 40)


def _jax_state():
    """A 2-member JAX ensemble state trained 10 SGD steps from random
    weights (so that the members' heads fit the data a little)."""
    model = JaxModel(JaxNet())

    def loss_fn(params, ms, key, batch):
        x, y = batch
        out, kl, ms = model.apply(params, ms, key, x, train=True)
        logp = jax.nn.log_softmax(out, axis=-1)
        return JaxLossOutput(loss=-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), kl=kl, model_state=ms)

    ens = jax_deep_ensemble(jax_map_method(loss_fn, optax.sgd(0.1)), MEMBERS)
    params = jax_tree_stack([random_jax_params(JaxNet(), (2, 5), seed=s) for s in range(MEMBERS)])
    state = ens.init(jax.random.key(0), params, {})
    x, y = _data()
    step = jax.jit(ens.update)
    for i in range(10):
        state, _ = step(state, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
    return model, state


def _port_state(jstate):
    model = Model(TorchNet())
    method = deep_ensemble(map_method(None, lambda p: (SGD(p, 0.1), None)), MEMBERS)
    members = []
    for sd in particles_from_jax(to_numpy_tree(jstate.params)):
        net = TorchNet()
        net.load_state_dict(sd)
        members.append(net)
    model.module = members[0]
    return model, method.init(members)


@pytest.mark.parametrize("hessian", ["full", "diag", "kron"])
def test_laplace_fit_per_member_matches_jax(hessian, recorded, monkeypatch):
    jmodel, jstate = _jax_state()
    x, y = _data()
    jlap = jax_laplace.laplace_method(jmodel, hessian=hessian, regression=False, batch_size=BATCH)
    recorded.clear()
    jfit = jlap.fit(jstate, (jnp.asarray(x), jnp.asarray(y)))
    grids = [out for kind, out in recorded if kind == "jit" and not isinstance(out, tuple) and out.shape == (33,)]
    assert len(grids) == MEMBERS and jfit.ll_mean.shape[0] == MEMBERS

    model, state = _port_state(jstate)
    lap = laplace_method(model, hessian=hessian, regression=False, batch_size=BATCH)
    curves, pps = [], []
    real = port_laplace.optimize_prior_prec

    def recording(marglik, **kw):
        grid = torch.logspace(-4, 4, 33, dtype=torch.float64).to(torch.float32)
        curves.append(marglik(grid).numpy())
        pps.append(real(marglik, **kw))
        return pps[-1]

    monkeypatch.setattr(port_laplace, "optimize_prior_prec", recording)
    fitted = lap.fit(state, (torch.from_numpy(x), torch.from_numpy(y)))
    assert isinstance(fitted, EnsembleState) and all(isinstance(m, LaplaceState) for m in fitted.members)

    jpps = np.asarray(jfit.prior_prec)
    grid = torch.logspace(-4, 4, 33, dtype=torch.float64).to(torch.float32)
    for m in range(MEMBERS):
        # the port's marginal likelihood on JAX's curvature and log-likelihood
        jmember = jax.tree.map(lambda leaf: leaf[m], jstate)
        curvature, jll, theta = _jax_curvature(jlap, jmember, jfit, m, x, y, hessian, recorded)
        mine = port_laplace.log_marginal_likelihood(torch.from_numpy(curvature), torch.tensor(jll),
                                                    torch.from_numpy(theta), hessian)
        assert_close(mine(grid).numpy(), grids[m], rtol=1e-5, err_msg=f"member {m} marglik on JAX's H")
        # end to end: each side's own H; below pp 1e-3 the curve reads H's
        # null directions (the softmax GGN's), which are fp32 rounding, times
        # 1/pp, so the whole curve is held to 1e-4
        assert_close(curves[m], grids[m], rtol=1e-4, err_msg=f"member {m} marglik grid")
        # pp: within the curve's tolerance of JAX's best value, on JAX's curve
        score = _score(curvature, jll, theta, hessian)
        best, port = score(float(jpps[m])), score(pps[m])
        assert port >= best - 1e-5 * abs(best), (m, pps[m], float(jpps[m]), port, best)
        print(f"\ngap pp member {m}: port {pps[m]:.7g}, JAX {float(jpps[m]):.7g}; JAX's marglik at them "
              f"{port:.9g}, {best:.9g}")
        np.testing.assert_array_equal(fitted.members[m].ll_mean.numpy(), np.asarray(jfit.ll_mean[m]))

    # given JAX's pp: the posterior of each member
    monkeypatch.setattr(port_laplace, "optimize_prior_prec", lambda marglik, **kw: float(jpps.pop(0)))
    jpps = list(np.asarray(jfit.prior_prec, np.float64))
    fitted = lap.fit(state, (torch.from_numpy(x), torch.from_numpy(y)))
    for m in range(MEMBERS):
        got = fitted.members[m]
        if hessian == "full":
            want = np.asarray(jfit.scale_tril[m])
            assert_close(got.scale_tril.numpy(), want, rtol=1e-4, atol=1e-6, err_msg=f"member {m} scale_tril")
        elif hessian == "diag":
            assert_close(got.diag_scale.numpy(), np.asarray(jfit.diag_scale[m]), rtol=1e-4, atol=1e-6,
                         err_msg=f"member {m} diag_scale")
        else:
            for s, u, name in (("kron_sa", "kron_ua", "A"), ("kron_sb", "kron_ub", "B")):
                ws, wu = np.asarray(getattr(jfit, s)[m]), np.asarray(getattr(jfit, u)[m])
                gs, gu = getattr(got, s).numpy(), getattr(got, u).numpy()
                assert_close(gs, ws, rtol=1e-5, atol=1e-6 * np.abs(ws).max(), err_msg=f"member {m} eigenvalues {name}")
                rebuilt, want = (gu * gs) @ gu.T, (wu * ws) @ wu.T
                assert_close(rebuilt, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=f"member {m} {name}")


def _jax_ggn(jlap, jmember, x, y, recorded):
    """JAX's H (summed over its batches) and log-likelihood for one member,
    from the outputs of its jitted per-batch GGN step."""
    recorded.clear()
    jlap.fit(jmember, (jnp.asarray(x), jnp.asarray(y)))
    steps = [out for kind, out in recorded if kind == "jit" and isinstance(out, tuple) and len(out) == 2]
    h = sum(np.asarray(hb, np.float64) for hb, _ in steps).astype(np.float32)
    return h, np.float32(sum(float(ll) for _, ll in steps))


def _jax_curvature(jlap, jmember, jfit, m, x, y, hessian, recorded):
    """(the curvature ``log_marginal_likelihood`` takes, the log-likelihood,
    theta) of member ``m``, from JAX's fit."""
    if hessian != "kron":
        h, loglik = _jax_ggn(jlap, jmember, x, y, recorded)
        return h, loglik, np.asarray(jfit.ll_mean[m])
    recorded.clear()
    jlap.fit(jmember, (jnp.asarray(x), jnp.asarray(y)))
    stats = [out for kind, out in recorded if kind == "jit" and isinstance(out, tuple) and len(out) == 3]
    loglik = np.float32(sum(float(ll) for _, _, ll in stats))
    sa, sb = np.asarray(jfit.kron_sa[m]), np.asarray(jfit.kron_sb[m])
    head = jmember.params["Dense_1"]
    theta = np.concatenate([np.asarray(head["kernel"]).reshape(-1), np.asarray(head["bias"])])
    return (sa[:, None] * sb[None, :]).reshape(-1), loglik, theta


def _score(curvature, loglik, theta, hessian):
    """JAX's marginal likelihood, in fp64, from JAX's curvature."""
    d, c = theta.shape[0], curvature.astype(np.float64)

    def score(pp):
        if hessian == "full":
            logdet = 2 * np.sum(np.log(np.diag(np.linalg.cholesky(c + pp * np.eye(d)))))
        else:
            logdet = np.sum(np.log(c + pp))
        return float(loglik - 0.5 * (pp * np.sum(theta.astype(np.float64) ** 2) + logdet - d * np.log(pp)))

    return score


@pytest.mark.parametrize("hessian,regression", [("full", False), ("diag", False), ("full", True), ("diag", True)],
                         ids=["full", "diag", "full_regression", "diag_regression"])
def test_ggn_matches_jax(hessian, regression, recorded):
    """The GGN of member 0 (``ggn``: ``[D, D]`` or its diagonal) and the
    log-likelihood at the MAP; classification (``diag p - p p^T``) and
    regression (``I / sigma^2``, the 4 outputs against normal targets)."""
    jmodel, jstate = _jax_state()
    x, y = _data()
    if regression:
        y = np.random.RandomState(1).standard_normal((40, 4)).astype(np.float32)
    jmember = jax.tree.map(lambda leaf: leaf[0], jstate)
    jlap = jax_laplace.laplace_method(jmodel, hessian=hessian, regression=regression, sigma_noise=0.5,
                                      batch_size=BATCH)
    jh, jll = _jax_ggn(jlap, jmember, x, y, recorded)

    model, state = _port_state(jstate)
    lap = laplace_method(model, hessian=hessian, regression=regression, sigma_noise=0.5, batch_size=BATCH)
    h, loglik = lap.ggn(state.members[0], (torch.from_numpy(x), torch.from_numpy(y)))
    assert h.shape == ((68, 68) if hessian == "full" else (68,))
    assert_close(h.numpy(), jh, rtol=1e-5, atol=1e-6 * np.abs(jh).max(), err_msg="H")
    assert_close(float(loglik), float(jll), rtol=1e-6, err_msg="loglik")


@pytest.mark.parametrize("hessian", ["full", "diag", "kron"])
def test_sample_matches_jax(hessian, recorded):
    """A draw of member 1 from JAX's fitted state (``state_from_jax``) with
    JAX's z given: ``ll_mean + scale_tril @ z`` (``diag``: ``diag_scale *
    z``; ``kron``: ``U_A (z / sqrt(s)) U_B^T`` added to the head), as the
    parameter mapping the eval runs."""
    jmodel, jstate = _jax_state()
    x, y = _data()
    jlap = jax_laplace.laplace_method(jmodel, hessian=hessian, regression=False, batch_size=BATCH)
    jfit = jlap.fit(jax.tree.map(lambda leaf: leaf[1], jstate), (jnp.asarray(x), jnp.asarray(y)))
    recorded.clear()
    want, _ = jlap.sample(jfit, jax.random.key(3))
    z = [out for kind, out in recorded if kind == "normal"]
    assert len(z) == 1

    model, state = _port_state(jstate)
    lap = laplace_method(model, hessian=hessian, regression=False, batch_size=BATCH)
    member = state.members[1]
    fitted = lap.fit(member, (torch.from_numpy(x[:16]), torch.from_numpy(y[:16])))
    held = {k: getattr(fitted, k) for k in ("ll_mean", "scale_tril", "diag_scale", "kron_ua")}
    fitted.load_state_dict(state_from_jax(member.params, jfit))
    # loaded in place: a captured eval graph holding these tensors reads the new values
    assert all(getattr(fitted, k) is t for k, t in held.items())
    got, _ = lap.sample(fitted, NoiseSource(given=[torch.from_numpy(z[0])]))
    ref = {k: v.numpy() for k, v in particles_from_jax(to_numpy_tree(jax_tree_stack([want])))[0].items()}
    assert got.keys() == ref.keys()
    for k in ref:
        assert_close(got[k].numpy(), ref[k], atol=1e-6, rtol=0, err_msg=k)


def test_last_layer_mask_picks_the_head():
    mask = last_layer_mask(TorchNet())
    assert [k for k, v in mask.items() if v] == ["Dense_1.kernel", "Dense_1.bias"]
    with pytest.raises(ValueError):
        last_layer_mask(torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="post-hoc"):
        laplace_method(Model(TorchNet()), regression=False).init(TorchNet())


def test_laplace_build_train_fit_eval_matches_jax(monkeypatch):
    """The CIFAR ``laplace`` row (``ll_hessian: full``): ``build`` ->
    ``train`` (4 MAP steps) -> the fit on the training split -> ``eval_model``
    (24 images, S = 4), each eval sample's z given from JAX's draws
    (``_torch_parity.run_both``), the port's fit at JAX's prior precision
    (the two fp32 optima part by 0.13 % on this flat curve, which moves the
    metrics by 3e-5; the pp is held to the curve above)."""
    record_jax_normals(monkeypatch, jax_laplace)
    jax_pps, real = [], jax_laplace._optimize_prior_prec
    monkeypatch.setattr(jax_laplace, "_optimize_prior_prec", lambda m, **kw: jax_pps.append(real(m, **kw)) or jax_pps[-1])
    monkeypatch.setattr(port_laplace, "optimize_prior_prec", lambda marglik, **kw: jax_pps[-1])

    def to_port(train, evals, module):
        assert not train
        return [torch.from_numpy(z) for z in evals]

    want, got, jbuilt, built = run_both({"model": "laplace", "ll_hessian": "full", **PARITY}, monkeypatch, to_port,
                                        fit_laplace=True)
    assert isinstance(built.state, LaplaceState) and built.state.scale_tril.shape == (650, 650)
    assert float(built.state.prior_prec) == np.float32(jbuilt.state.prior_prec)
    assert got.keys() == want.keys()
    for k in want:
        assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_grid_argmax_skips_candidates_without_a_value():
    """A grid point whose marginal likelihood is NaN (a failed Cholesky) is
    never the bracket's centre; the search then finds the maximum of a
    concave curve in log(pp) to far below a grid step."""

    def marglik(pp):
        value = -(torch.log(pp) - 1.0) ** 2
        return torch.where(pp < 1e-2, torch.full_like(value, float("nan")), value)

    best = port_laplace.optimize_prior_prec(marglik)
    assert abs(np.log(best) - 1.0) < 1e-4


def test_ggn_is_positive_semidefinite():
    """The GGN as a Gram matrix (``G^T G``, ``G = diag(sqrt p) (I - 1 p^T)
    J``): its smallest eigenvalue, that of the softmax's null directions,
    is rounding of either sign far below the prior precisions searched
    (1e-4 at least), so ``H + pp I`` has a Cholesky factor on the whole
    grid."""
    _, jstate = _jax_state()
    model, state = _port_state(jstate)
    x, y = _data()
    h, _ = laplace_method(model, hessian="full", regression=False, batch_size=BATCH).ggn(
        state.members[0], (torch.from_numpy(x), torch.from_numpy(y)))
    eig = torch.linalg.eigvalsh(h.double())
    assert float(eig.min()) > -1e-6 * float(eig.max()) and float(eig.min()) < 1e-4


def test_fit_laplace_from_checkpoint_is_the_method_fit(tmp_path):
    """``experiments/phases.py::fit_laplace_from_checkpoint`` on a restored
    MAP state: the post-hoc method and its fit of that state."""
    from beyond_deep_ensembles_tpu_torch.experiments import phases
    from beyond_deep_ensembles_tpu_torch.utils import checkpoint as ckpt

    _, jstate = _jax_state()
    model, state = _port_state(jstate)
    ckpt.save_final(tmp_path, "map", state.members[0])
    restored = ckpt.restore_final(tmp_path, "map", _port_state(jstate)[1].members[1])
    x, y = _data()
    data = (torch.from_numpy(x), torch.from_numpy(y))
    method, fitted = phases.fit_laplace_from_checkpoint(model, restored, data, hessian="diag")
    want = laplace_method(model, hessian="diag", regression=False).fit(state.members[0], data)
    assert torch.equal(fitted.ll_mean, want.ll_mean) and torch.equal(fitted.diag_scale, want.diag_scale)
    params, _ = method.sample(fitted, NoiseSource(given=[torch.zeros(68)]))
    assert all(torch.equal(params[k], v.detach()) for k, v in restored.params.named_parameters())
