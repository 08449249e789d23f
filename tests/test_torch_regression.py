"""PyTorch port, the UCI model and metrics held against the JAX package on
the CPU:

  * ``evals/regression.py``: ``gauss_logprob``, ``nll_loss`` (its variance
    clamp included), ``calc_quantile_frequencies`` (at S = 1000, where the
    nearest ranks fall on halves) and every field of
    ``RegressionResults.create``, ``sqce`` and ``average``, with JAX's normal
    draw given;
  * ``nn/gauss.py::GaussLayer`` and ``models/mlp.py::RegressionMLP``: plain
    (``learn_var`` on and off), ``bbb`` and ``rank1`` (JAX's draws given),
    MC-Dropout (JAX's masks given), train and eval, from the same weights:
    the outputs and the gradients of a weighted sum of them; the flax scope
    names.

Tolerances: the metrics 1e-6 relative (the quantile counts equal); the
model's outputs and gradients 1e-5 relative and 1e-5 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxShim, assert_close, to_numpy_tree
from beyond_deep_ensembles_tpu.evals import regression as jax_reg
from beyond_deep_ensembles_tpu.models.mlp import RegressionMLP as JaxMLP
from beyond_deep_ensembles_tpu.nn import bbb as jax_bbb
from beyond_deep_ensembles_tpu.nn import dropout as jax_dropout
from beyond_deep_ensembles_tpu.nn import rank1 as jax_rank1
from beyond_deep_ensembles_tpu_torch.evals import regression as reg
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.mlp import RegressionMLP
from beyond_deep_ensembles_tpu_torch.nn.gauss import GaussLayer
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

FIELDS = ("mse_of_means", "mean_mse", "log_likelihood", "average_log_likelihood", "lml", "average_lml",
          "observed_cdf", "quantile_ps", "qce")


def _outputs(samples, points, seed=0, small_std=False):
    rng = np.random.RandomState(seed)
    mean = rng.standard_normal((samples, points, 1)).astype(np.float32)
    std = np.exp(rng.standard_normal((samples, points, 1)) * 0.5).astype(np.float32)
    if small_std:
        std[:, : points // 2] *= 1e-3  # var below the 1e-4 clamp
    y = rng.standard_normal((points, 1)).astype(np.float32)
    return np.stack([mean, std], -1), y


def test_gauss_logprob_and_nll_loss_match_jax():
    out, y = _outputs(1, 40, small_std=True)
    out, y = out[0], y
    assert_close(reg.nll_loss(torch.from_numpy(out), torch.from_numpy(y)).numpy(),
                 np.asarray(jax_reg.nll_loss(jnp.asarray(out), jnp.asarray(y))), rtol=1e-6, err_msg="nll_loss")
    m, v = out[..., 0], out[..., 1] ** 2
    assert_close(reg.gauss_logprob(*map(torch.from_numpy, (m, v, y))).numpy(),
                 np.asarray(jax_reg.gauss_logprob(*map(jnp.asarray, (m, v, y)))), rtol=1e-6, err_msg="gauss_logprob")


def test_quantile_frequencies_match_jax():
    """At S = 1000 the nearest rank p (S - 1) of every odd level is a half
    (round half to even on both sides, ``_linspace01`` as ``jnp.linspace``)."""
    out, y = _outputs(1000, 30, seed=1)
    key = jax.random.key(3)
    z = np.asarray(jax.random.normal(key, out.shape[:-1], jnp.float32))
    want = jax_reg.calc_quantile_frequencies(jnp.asarray(out[..., 0]), jnp.asarray(out[..., 1]), jnp.asarray(y),
                                             10, key)
    got = reg.calc_quantile_frequencies(torch.from_numpy(out[..., 0]), torch.from_numpy(out[..., 1]),
                                        torch.from_numpy(y), 10, z=torch.from_numpy(np.array(z)))
    # the same counts (a frequency is a count over 30 points, its mean
    # rounded in the last bit on either side)
    assert np.array_equal(np.rint(got.numpy() * 30), np.rint(np.asarray(want) * 30))
    assert_close(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7, err_msg="observed_cdf")
    assert np.array_equal(reg._linspace01(19, "cpu").numpy(), np.asarray(jnp.linspace(0.0, 1.0, 19)))


@pytest.mark.parametrize("samples", [1, 7])
def test_regression_results_match_jax(samples):
    results = []
    for seed in range(3):
        out, y = _outputs(samples, 25, seed=seed)
        key = jax.random.key(seed)
        want = jax_reg.RegressionResults.create(jnp.asarray(out), jnp.asarray(y), key=key, target_mean=1.5,
                                                target_std=2.5)
        z = np.asarray(jax.random.normal(key, out.shape[:-1], jnp.float32))
        got = reg.RegressionResults.create(torch.from_numpy(out), torch.from_numpy(y), z=torch.from_numpy(np.array(z)),
                                           target_mean=1.5, target_std=2.5)
        for f in FIELDS:
            assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-6, err_msg=f)
        assert_close(float(got.sqce), float(want.sqce), rtol=1e-6, atol=1e-7, err_msg="sqce")
        results.append((want, got))
    want = jax_reg.RegressionResults.average([w for w, _ in results])
    got = reg.RegressionResults.average([g for _, g in results])
    for f in FIELDS:
        assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-6, atol=1e-7,
                     err_msg=f"average {f}")


def test_quantile_draw_from_a_key_is_device_independent():
    out, y = _outputs(6, 20, seed=4)
    a = reg.RegressionResults.create(torch.from_numpy(out), torch.from_numpy(y), key=43)
    b = reg.RegressionResults.create(torch.from_numpy(out), torch.from_numpy(y), key=43)
    c = reg.RegressionResults.create(torch.from_numpy(out), torch.from_numpy(y), key=44)
    assert torch.equal(a.observed_cdf, b.observed_cdf)
    z = reg.quantile_draw(43, (6, 20, 1), "cpu")
    assert abs(float(z.mean())) < 0.2 and abs(float(z.std()) - 1) < 0.2
    assert torch.isfinite(c.qce) and 0.0 <= float(c.qce) <= 1.0


class Feed:
    """Stands in for ``jax.random.normal`` / ``bernoulli`` / ``eval_noise``
    in the JAX layers: draws from a seeded numpy generator, recorded in call
    order."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.draws = []

    def normal(self, key, shape=(), dtype=jnp.float32):
        del key
        eps = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        self.draws.append(eps)
        return jnp.asarray(eps, dtype)

    def eval_noise(self, module, shape, train, freeze_on_eval, stream="noise"):
        frozen = not train and freeze_on_eval
        eps = self.normal(None, tuple(shape[1:]) if frozen else tuple(shape))
        return jnp.broadcast_to(eps, shape) if frozen else eps

    def bernoulli(self, key, p=0.5, shape=None):
        del key
        mask = self.rng.rand(*shape) < p
        self.draws.append(mask)
        return jnp.asarray(mask)


VARIANTS = [
    ("plain", {"learn_var": True}),
    ("plain", {"learn_var": False, "std_init": 0.3}),
    ("bbb", {"learn_var": True}),
    ("rank1", {"learn_var": True, "components": 2}),
    ("mcd", {"learn_var": True, "dropout_p": 0.3}),
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind, knobs", VARIANTS)
def test_mlp_outputs_and_gradients_match_jax(kind, knobs, train, monkeypatch):
    in_dim, batch = 6, 9
    dense = "plain" if kind == "mcd" else kind
    jmodel = JaxMLP(dense_kind=dense, **knobs)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((batch, in_dim)).astype(np.float32)
    w = rng.standard_normal((batch, 1, 2)).astype(np.float32)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.key(0), "noise": jax.random.key(1),
                                             "dropout": jax.random.key(2)}, jnp.zeros((1, in_dim)), train=False))()
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                          to_numpy_tree(variables["params"]))
    feed = Feed(3)
    monkeypatch.setattr(jax_bbb, "eval_noise", feed.eval_noise)
    monkeypatch.setattr(jax_rank1, "jax", JaxShim(jax, random=JaxShim(jax.random, normal=feed.normal)))
    monkeypatch.setattr(jax_dropout, "jax", JaxShim(jax, random=JaxShim(jax.random, bernoulli=feed.bernoulli)))
    kwargs = {"component": 1} if kind == "rank1" else {}

    def f(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), train=train,
                           rngs={"noise": jax.random.key(4), "dropout": jax.random.key(5)}, **kwargs)
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)

    net = RegressionMLP(in_dim, dense_kind=dense, generator=torch.Generator(), **knobs)
    net.load_state_dict(params_from_jax(params), strict=True)
    noise = NoiseSource(given=[torch.from_numpy(np.array(d)) for d in feed.draws])
    out = net(torch.from_numpy(x), noise, train=train, **kwargs)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert noise.draws == len(feed.draws) and out.shape == (batch, 1, 2)
    assert_close(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=f"{kind} output")
    ref = params_from_jax(to_numpy_tree(grads))
    for name, p in net.named_parameters():
        assert_close(p.grad.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{kind} d{name}")


def test_mlp_scope_names():
    gen = torch.Generator()
    names = {kind: [n for n, _ in RegressionMLP(4, dense_kind=kind, learn_var=True, generator=gen).named_parameters()]
             for kind in ("plain", "bbb", "rank1")}
    assert names["plain"] == ["Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel", "Dense_1.bias",
                              "GaussLayer_0.rho__mle"]
    assert names["bbb"][0].startswith("BBBDense_0.") and names["bbb"][-2].startswith("BBBDense_1.")
    assert names["rank1"][0].startswith("Rank1Dense_0.")
    mcd = RegressionMLP(4, dropout_p=0.1, generator=gen)
    assert [n for n, _ in mcd.named_children()] == ["Dense_0", "FixableDropout_0", "Dense_1", "GaussLayer_0"]
    assert not list(GaussLayer(1.0, learn_var=False).parameters())
    out = GaussLayer(2.0, learn_var=False)(torch.zeros(3, 1))
    assert torch.allclose(out[..., 1], torch.full((3, 1), 2.0))
