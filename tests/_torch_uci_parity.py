"""Shared helpers for the UCI parity tests (``tests/test_torch_uci*.py``):
``run_both`` runs the JAX package's and the port's ``build`` -> ``train``
-> (Laplace fit) -> ``evaluate`` of one ``configs/uci.yaml`` model on the
CPU from the JAX package's initial state, JAX's draws given to the port."""
import jax
import numpy as np
import torch

from _torch_parity import RECORDED, JaxShim, assert_close, record_jax_normals, to_numpy_tree
from beyond_deep_ensembles_tpu import tree as jax_tree
from beyond_deep_ensembles_tpu.evals import regression as jax_regression
from beyond_deep_ensembles_tpu.experiments import uci as jax_uci
from beyond_deep_ensembles_tpu.methods import ivon as jax_ivon
from beyond_deep_ensembles_tpu.methods import laplace as jax_laplace
from beyond_deep_ensembles_tpu.methods import swag as jax_swag
from beyond_deep_ensembles_tpu.nn import dropout as jax_dropout
from beyond_deep_ensembles_tpu.nn import gaussian as jax_gaussian
from beyond_deep_ensembles_tpu.nn import rank1 as jax_rank1
from beyond_deep_ensembles_tpu_torch.data.uci import UCIDataset
from beyond_deep_ensembles_tpu_torch.experiments import uci
from beyond_deep_ensembles_tpu_torch.models.jax_convert import (
    _port_flat, _unravel_sorted, params_from_jax, particles_from_jax, state_from_jax)
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

# configs/uci.yaml's DEFAULT, cut to one epoch of 4 steps at batch 16 and
# S = 4 over 24 test points
YAML_DEFAULT = {"members": 1, "std_init": 1.0, "learn_var": True, "normalize": True, "lr": 0.01}
CUT = {"dataset": "yacht", "epochs": 1, "batch_size": 16, "eval_samples": 4, "seed": 0}
N_TRAIN, N_TEST = 64, 24
METRICS = ("avg_ll", "avg_lml", "mse", "qce", "sqce")


def _recorded_bernoulli(key, p=0.5, shape=None):
    value = jax.random.bernoulli(key, p, shape)
    jax.debug.callback(lambda v: RECORDED.append(np.asarray(v)), value, ordered=True)
    return value


def _recorded_normal_like(key, t):
    value = jax_tree.normal_like(key, t)
    jax.debug.callback(lambda v: RECORDED.append(to_numpy_tree(v)), value, ordered=True)
    return value


def _site_major_to_sample_major(draws, sites, samples):
    """JAX's vmapped predict records the samples of one draw site together;
    the port's predict takes each sample's sites in turn."""
    assert len(draws) == sites * samples, (len(draws), sites, samples)
    return [draws[site * samples + s] for s in range(samples) for site in range(sites)]


def _arrays():
    ds = UCIDataset("yacht")
    x, y = ds.get_arrays("train")
    xt, yt = ds.get_arrays("test")
    return ds, (x[:N_TRAIN], y[:N_TRAIN]), (xt[:N_TEST], yt[:N_TEST])


def config_for(model, **extra):
    return {**uci.DEFAULT_CONFIG, **YAML_DEFAULT, **CUT, "model": model, "in_dim": 6, **extra}


def run_both(model, monkeypatch, **extra):
    """JAX's and the port's build -> train -> (Laplace fit) -> evaluate from
    JAX's initial state, JAX's draws given to the port in the port's order.
    Returns (JAX's results, the port's, JAX's final params, the port's
    built experiment)."""
    config = config_for(model, **extra)
    ds, (x, y), (xt, yt) = _arrays()
    record_jax_normals(monkeypatch, jax_gaussian, jax_rank1, jax_swag, jax_laplace, jax_regression)
    monkeypatch.setattr(jax_dropout, "jax", JaxShim(jax, random=JaxShim(jax.random, bernoulli=_recorded_bernoulli)))
    monkeypatch.setattr(jax_ivon, "tree", JaxShim(jax_tree, normal_like=_recorded_normal_like))

    jbuilt = jax_uci.build(config, N_TRAIN, jax.random.key(0))
    built = uci.build(config, N_TRAIN, torch.Generator().manual_seed(0), device="cpu")
    module = built.state.params
    built.state.load_state_dict(state_from_jax(module, jbuilt.state, lr=config["lr"], var_lr=config["var_lr"]))
    jparams0 = to_numpy_tree(jbuilt.state.params)

    RECORDED.clear()
    jbuilt = jax_uci.train(jbuilt, config, x, y, seed=0)
    jax.effects_barrier()
    train_draws = list(RECORDED)
    if model == "laplace":
        jbuilt = jax_uci.fit_laplace(jbuilt, config, x, y)
    RECORDED.clear()
    want = jax_uci.evaluate(jbuilt, config, xt, yt, ds)
    jax.effects_barrier()
    eval_draws, quantile = list(RECORDED[:-1]), RECORDED[-1]

    s = config["eval_samples"]

    def flat(tree):  # an eps tree of the JAX iVON -> the port's flat draw
        return _port_flat(module, params_from_jax(tree))

    if model == "ivon":
        given = [flat(d) for d in train_draws + eval_draws]
    elif model == "swag":
        z1, z2 = eval_draws[:s], eval_draws[s:]
        given = [torch.from_numpy(d) for z in zip(z1, z2) for d in
                 (z[0], _port_flat(module, params_from_jax(_unravel_sorted(jparams0, z[1]))).numpy())]
    else:
        sites = {"bbb": 2, "bbb_fixed_kl": 2, "rank1": 4}.get(model, 1)
        if eval_draws:
            eval_draws = _site_major_to_sample_major(eval_draws, sites, s)
        given = [torch.from_numpy(np.array(d)) for d in train_draws + eval_draws]
    noise = NoiseSource(given=given)
    monkeypatch.setattr(uci, "NoiseSource", lambda **kw: noise)
    built = uci.train(built, config, x, y, seed=0)
    if model == "laplace":
        built = uci.fit_laplace(built, config, x, y)
    got = uci.evaluate(built, config, xt, yt, ds, z=torch.from_numpy(np.array(quantile)))
    assert noise.draws == len(given), (noise.draws, len(given))
    return uci.result_dict(want), uci.result_dict(got), to_numpy_tree(jbuilt.state.params), built




def check_matches_jax(model, monkeypatch, rtol=1e-5, atol=1e-5):
    """``run_both``, then the trained parameters and the five metrics within
    ``rtol`` and ``atol``."""
    want, got, jparams, built = run_both(model, monkeypatch)
    if model == "svgd":
        ref = {f"{i}.{k}": v for i, sd in enumerate(particles_from_jax(jparams)) for k, v in sd.items()}
    else:
        ref = params_from_jax(jparams)
    mine = dict(built.state.params.named_parameters())
    assert mine.keys() == ref.keys()
    for name, value in ref.items():
        assert_close(mine[name].detach().numpy(), value.numpy(), rtol=rtol, atol=atol, err_msg=f"{model} {name}")
    for k in METRICS:
        assert_close(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{model} {k}")
    assert all(np.isfinite(v) for v in got.values())
