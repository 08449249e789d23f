"""PyTorch port, methods/api.py: priors, KL collection, labels and L2,
held against the JAX package on the same numpy arrays.

Tolerances: fp32 sums over a few hundred terms, 1e-5 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.methods import api as jax_api
from beyond_deep_ensembles_tpu_torch.methods import api

RTOL = 1e-5


def _tree(seed=0):
    rng = np.random.RandomState(seed)

    def a(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "BBBConv_0": {"kernel__gmean": a(3, 3, 2, 4, scale=0.1), "kernel__grho": a(3, 3, 2, 4) - 3.0,
                      "bias__gmean": a(4), "bias__grho": a(4) - 3.0},
        "Norm_0": {"scale": a(4), "bias": a(4)},
        "Head_0": {"kernel__gmean": a(5, 3), "kernel__grho": a(5, 3) - 2.0, "rho__mle": a(3)},
        "orphan__gmean": a(2),
    }


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + (k,))] = v
    return out


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("prior", [(0.0, 1.0), (0.3, 0.1)])
def test_gaussian_prior_kl(prior):
    rng = np.random.RandomState(1)
    mu = rng.standard_normal(64).astype(np.float32)
    sig = np.abs(rng.standard_normal(64)).astype(np.float32) + 0.05
    ref = jax_api.GaussianPrior(*prior).kl_divergence(jnp.asarray(mu), jnp.asarray(sig))
    got = api.GaussianPrior(*prior).kl_divergence(torch.from_numpy(mu), torch.from_numpy(sig))
    assert_close(got.numpy(), np.asarray(ref), rtol=RTOL)
    lp_ref = jax_api.GaussianPrior(*prior).log_prob(jnp.asarray(mu))
    assert_close(
        api.GaussianPrior(*prior).log_prob(torch.from_numpy(mu)).numpy(), np.asarray(lp_ref), rtol=RTOL
    )


def test_mixture_prior_clamps_and_kl():
    # values far in the tails hit the [-23, 0] clamp of the narrow component
    x = np.asarray([0.0, 1e-3, 0.05, 0.5, 3.0, -7.0, 40.0], np.float32)
    ref = jax_api.MixturePrior().log_prob(jnp.asarray(x))
    got = api.MixturePrior().log_prob(torch.from_numpy(x))
    assert_close(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)
    kl_ref = jax_api.MixturePrior(0.25, 2.0, 0.1).kl_divergence(jnp.asarray(x), None)
    kl = api.MixturePrior(0.25, 2.0, 0.1).kl_divergence(torch.from_numpy(x), None)
    assert_close(kl.numpy(), np.asarray(kl_ref), rtol=RTOL)


def test_sigma_and_gaussian_kl():
    rng = np.random.RandomState(2)
    rho = rng.standard_normal(32).astype(np.float32) - 2.0
    assert_close(
        api.to_sigma(torch.from_numpy(rho)).numpy(), np.asarray(jax_api.to_sigma(jnp.asarray(rho))), rtol=RTOL
    )
    sig = np.abs(rho) + 0.1
    assert_close(
        api.softplus_inverse(torch.from_numpy(sig)).numpy(),
        np.asarray(jax_api.softplus_inverse(jnp.asarray(sig))), rtol=RTOL,
    )
    mq, mp = rho + 1.0, rho * 0.5
    ref = jax_api.gaussian_kl(*(jnp.asarray(v) for v in (mq, sig, mp, sig[::-1].copy())))
    got = api.gaussian_kl(*(torch.from_numpy(v) for v in (mq, sig, mp, sig[::-1].copy())))
    assert_close(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_labels_and_mask():
    tree = _tree()
    ref = _flat(jax_api.split_gaussian_labels(tree))
    assert api.split_gaussian_labels(_torch(tree)) == ref
    ref_mask = _flat(jax_api.non_mle_mask(tree))
    assert api.non_mle_mask(_torch(tree)) == ref_mask
    assert sorted(set(ref.values())) == ["gmean", "grho", "mle", "plain"]


@pytest.mark.parametrize("prior", [jax_api.GaussianPrior(0.0, 1.0), jax_api.MixturePrior()])
def test_collect_gaussian_kl(prior):
    tree = _tree(3)
    ref = jax_api.collect_gaussian_kl(tree, prior)
    port_prior = getattr(api, type(prior).__name__)(*vars(prior).values())
    got = api.collect_gaussian_kl(_torch(tree), port_prior)
    assert_close(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_collect_gaussian_kl_on_module():
    module = torch.nn.Module()
    module.register_parameter("w__gmean", torch.nn.Parameter(torch.zeros(3)))
    module.register_parameter("w__grho", torch.nn.Parameter(torch.full((3,), -3.0)))
    kl = api.collect_gaussian_kl(module, api.GaussianPrior())
    ref = jax_api.collect_gaussian_kl(
        {"w__gmean": jnp.zeros(3), "w__grho": jnp.full((3,), -3.0)}, jax_api.GaussianPrior()
    )
    assert_close(kl.detach().numpy(), np.asarray(ref), rtol=RTOL)
    kl.backward()
    assert module.w__grho.grad is not None


def test_l2_of_plain_params():
    tree = _tree(4)
    ref = jax_api.l2_of_plain_params(tree)
    assert_close(api.l2_of_plain_params(_torch(tree)).numpy(), np.asarray(ref), rtol=RTOL)


def test_method_contract_defaults():
    out = api.LossOutput(loss=torch.tensor(1.0))
    assert out.kl == 0.0 and out.model_state is None and out.metrics == {}
    state = api.MethodState(params=torch.nn.Linear(1, 1), model_state={}, opt_state=None)
    assert api.default_finalize_epoch(state).epoch == 1 and state.step == 0
