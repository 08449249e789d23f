"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX layers draw their noise through ``eval_noise``; :class:`NoiseFeed`
stands in for it (installed with pytest's ``monkeypatch`` on the names that
``nn/bbb.py`` and ``nn/frn.py`` imported), draws each array from a seeded
numpy generator and records it. ``torch_noise`` turns the record into the
port's given-mode noise, NHWC -> NCHW. :func:`assert_close` prints the gap
of each comparison before it asserts.
"""
import os

import jax.numpy as jnp
import numpy as np
import torch

from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource


class NoiseFeed:
    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.draws = []

    def __call__(self, module, shape, train, freeze_on_eval, stream="noise"):
        del module, stream
        frozen = not train and freeze_on_eval
        draw_shape = tuple(shape[1:]) if frozen else tuple(shape)
        eps = self.rng.standard_normal(draw_shape).astype(np.float32)
        self.draws.append(eps)
        return jnp.broadcast_to(eps, shape) if frozen else jnp.asarray(eps)


def install_feed(monkeypatch, seed: int = 0) -> NoiseFeed:
    from beyond_deep_ensembles_tpu.nn import bbb as jax_bbb
    from beyond_deep_ensembles_tpu.nn import frn as jax_frn

    feed = NoiseFeed(seed)
    monkeypatch.setattr(jax_bbb, "eval_noise", feed)
    monkeypatch.setattr(jax_frn, "eval_noise", feed)
    return feed


def nchw(a: np.ndarray) -> torch.Tensor:
    """A JAX-layout array in the port's layout: rank 4 NHWC -> NCHW, rank 3
    (one HWC row) -> CHW, lower ranks as they are."""
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    elif a.ndim == 3:
        a = a.transpose(2, 0, 1)
    return torch.from_numpy(np.array(a, order="C"))


def torch_noise(draws) -> NoiseSource:
    return NoiseSource(given=[nchw(d) for d in draws])


def random_jax_params(module, example_shape, seed: int = 0):
    """Flax params for ``module`` drawn with numpy: the tree's shapes come
    from ``jax.eval_shape`` (no compile), the values near what init gives
    (means N(0, 0.1), gamma means near 1, rho near -3)."""
    import jax

    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                            jnp.zeros(example_shape), train=True)
    )["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("__grho"):
            return -3.0 + 0.3 * z
        if name.startswith("gamma"):
            return 1.0 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_numpy_tree(params):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in params.items()}


def load_jax_params(module: torch.nn.Module, jax_params) -> torch.nn.Module:
    module.load_state_dict(params_from_jax(to_numpy_tree(jax_params)), strict=True)
    return module


def flat_jax(tree):
    """Nested flax tree -> {dotted name: numpy array in the port's layout}."""
    return {k: v.numpy() for k, v in params_from_jax(to_numpy_tree(tree)).items()}


def assert_close(actual, desired, rtol=1e-7, atol=0.0, err_msg=""):
    """``np.testing.assert_allclose`` (same defaults) that first prints the
    largest gap it sees, so a run lists what each port test measured
    against the JAX package:

        JAX_PLATFORMS=cpu python -m pytest -s -p no:xdist tests/test_torch_*.py | grep '^gap '

    "rel" is the gap over the JAX value's magnitude."""
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    diff = np.abs(a - d)
    rel = diff / np.maximum(np.abs(d), 1e-30)
    test = os.environ.get("PYTEST_CURRENT_TEST", "?").split(" ")[0].split("[")[0]
    print(f"\ngap {test} {err_msg}: max abs {diff.max(initial=0.0):.3g}, "
          f"max rel {rel.max(initial=0.0):.3g} (rtol {rtol:g}, atol {atol:g})")
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol, err_msg=err_msg)
