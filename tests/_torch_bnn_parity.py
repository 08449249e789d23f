"""Shared helpers of the bnn-hmc parity tests (``tests/test_torch_hmc.py``,
``test_torch_sgmcmc_vi.py``, ``test_torch_bnn_hmc_experiment.py``,
``test_torch_wilson*.py``): a 2-layer MLP (the zoo's ``MLP``, 4 -> 16 -> 3)
over 64 blobs, built on both sides from JAX's initial weights, the
comparison of flat vectors, and Wilson HMC pickles written from JAX
``WilsonResNet20`` trees under haiku's names."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.data import wilson as jax_wilson
from beyond_deep_ensembles_tpu.models.resnet import WilsonResNet20 as JaxWilson
from beyond_deep_ensembles_tpu.models.zoo import MLP as JaxMLP
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.models.jax_convert import model_params_from_jax
from beyond_deep_ensembles_tpu_torch.models.zoo import MLP
from beyond_deep_ensembles_tpu_torch.nn.base import Model

N, PRIOR_STD = 64, 1.0


def close(got, want, what):
    """Within rtol 1e-5 and 2e-5 of the JAX vector's largest magnitude."""
    want = np.asarray(want)
    finite = np.abs(want[np.isfinite(want)])
    scale = float(finite.max()) if finite.size else 0.0
    assert_close(np.asarray(got), want, rtol=1e-5, atol=2e-5 * scale, err_msg=what)


def blobs(n=N, d=4, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n)
    centers = 2.0 * rng.randn(classes, d)
    x = centers[y] + 0.5 * rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int64)


def setup(seed=0):
    """JAX's model, params and loss; the port's module with those params,
    its model and loss; the batch on both sides."""
    jmodel = JaxModel(JaxMLP(layer_dims=(16,), out_dim=3))
    x, y = blobs(seed=seed)
    params, _ = jax.jit(jmodel.init)(jax.random.key(seed), jnp.asarray(x[:2]))
    module = MLP(4, (16,), 3, generator=torch.Generator().manual_seed(0))
    module.load_state_dict(model_params_from_jax(module, params), strict=True)
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    return jmodel, params, jbatch, module, Model(module), batch


def jax_inits(n, seed=0):
    module = JaxWilson(classes=10, activation="swish")
    init = jax.jit(module.init)
    return [jax.tree.map(np.asarray, init(jax.random.key(seed + i), jnp.zeros((1, 32, 32, 3)))["params"])
            for i in range(n)]


def to_haiku(flax_params, prefix_every=3):
    """A flax WilsonResNet20 tree under haiku's names and layouts; every
    ``prefix_every``-th module key behind the transform prefix."""
    out = {}
    for i, (scope, leaves) in enumerate(sorted(flax_params.items())):
        name = "linear" if scope == "linear" else jax_wilson._haiku_module_name(scope)
        if scope.startswith("frn_"):
            tree = {k: np.asarray(v).reshape(1, 1, 1, -1) for k, v in leaves.items()}
        else:
            tree = {"w": np.asarray(leaves["kernel"]), "b": np.asarray(leaves["bias"])}
        out[f"res_net/~/{name}" if i % prefix_every == 0 else name] = tree
    return out


def write_published(root, chains_per_file):
    """``state-<i>.pkl`` for each list of per-chain haiku trees, leaves
    stacked on a leading chain axis."""
    d = os.path.join(root, "wilson_hmc", "cifar10")
    os.makedirs(d)
    for i, chains in enumerate(chains_per_file):
        stacked = jax.tree.map(lambda *ls: np.stack(ls), *chains)
        with open(os.path.join(d, f"state-{i}.pkl"), "wb") as f:
            pickle.dump({"params": stacked, "net_state": {}, "iteration": i}, f)
