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
import pytest
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


RECORDED = []  # the JAX draws of the running test, in the order the program made them


def recorded_normal(key, shape=(), dtype=jnp.float32):
    import jax

    value = jax.random.normal(key, shape, dtype)
    jax.debug.callback(lambda v: RECORDED.append(np.asarray(v)), value, ordered=True)
    return value


class JaxShim:
    """Stands in for a module's ``jax`` (or ``jax.random``) name: every
    attribute is the real one's but ``random.normal``."""

    def __init__(self, real, **overrides):
        self._real, self._overrides = real, overrides

    def __getattr__(self, name):
        if name in self._overrides:
            return self._overrides[name]
        return getattr(self._real, name)


def record_jax_normals(monkeypatch, *modules) -> list:
    """Wraps ``jax.random.normal`` as ``modules`` (JAX-package modules that
    import ``jax``) see it, so that each draw is also recorded in
    :data:`RECORDED`, in program order (an ordered ``jax.debug.callback``:
    under ``jit`` each run appends its draws; under ``vmap`` the callback
    runs once per sample, the samples of one draw site together). Returns
    :data:`RECORDED`, emptied; call ``jax.effects_barrier()`` before reading
    it."""
    import jax

    RECORDED.clear()
    shim = JaxShim(jax, random=JaxShim(jax.random, normal=recorded_normal))
    for module in modules:
        monkeypatch.setattr(module, "jax", shim)
    return RECORDED


# the CIFAR comparisons of build -> train -> eval_model: 4 steps of 16, 24 test
# images at eval batch 10 (the last batch padded), S = 4, no augmentation
PARITY = {"members": 1, "augment": False, "epochs": 1, "subsample": 64, "test_subsample": 24, "batch_size": 16,
          "eval_batch_size": 10, "eval_samples": 4}


def run_both(config, monkeypatch, to_port_draws, fit_laplace=False):
    """The JAX package's and the port's ``build`` -> ``train`` ->
    ``eval_model`` (host loops) of ``config`` from JAX's initial weights,
    JAX's draws (``RECORDED``, made by the recorders the caller installed)
    given to the port through ``to_port_draws(train_draws, eval_draws,
    module) -> [tensors]``, with ``laplace``'s fit between train and eval
    when ``fit_laplace``. Returns (JAX's metrics, the port's)."""
    import jax
    from beyond_deep_ensembles_tpu.experiments import cifar as jax_cifar
    from beyond_deep_ensembles_tpu_torch.experiments import cifar

    config, (x, y), (xt, yt) = cifar._load_data({**jax_cifar.DEFAULT_CONFIG, **config})
    steps = x.shape[0] // config["batch_size"]
    jbuilt = jax_cifar.build(config, jax.random.key(config["seed"]), steps)
    built = cifar.build(config, torch.Generator().manual_seed(0), steps, device="cpu")
    jparams = to_numpy_tree(jbuilt.state.params)
    built.state.params.load_state_dict(params_from_jax(jparams), strict=True)
    if hasattr(built.state, "mean"):  # iVON: the state's mean holds the parameters too
        built.state.mean.copy_(built.state.flat)

    RECORDED.clear()
    jbuilt = jax_cifar.train(jbuilt, config, x, y)
    jax.effects_barrier()
    train_draws = list(RECORDED)
    RECORDED.clear()
    if fit_laplace:
        from beyond_deep_ensembles_tpu.methods import laplace_method as jax_laplace_method

        lap = jax_laplace_method(jbuilt.model, hessian=config["ll_hessian"], regression=False, inner=jbuilt.method)
        jbuilt.state = lap.fit(jbuilt.state, (jax.numpy.asarray(x), jax.numpy.asarray(y)))
        jbuilt.method = lap
    want = jax_cifar.eval_model(jbuilt, config, xt, yt).as_dict()
    jax.effects_barrier()
    eval_draws = list(RECORDED)

    given = NoiseSource(given=to_port_draws(train_draws, eval_draws, built.state.params))
    monkeypatch.setattr(cifar, "NoiseSource", lambda **kw: given)
    built = cifar.train(built, config, x, y)
    if fit_laplace:
        cifar._fit_laplace(built, config, x, y)
    got = cifar.eval_model(built, {**config, "device_eval": False}, xt, yt).as_dict()
    assert given.draws == len(given._given), (given.draws, len(given._given))
    return want, got, jbuilt, built



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


@pytest.fixture
def one_cpu_thread():
    """Runs a test on one intra-op thread. The suite runs several workers on
    the host's cores, and torch's default of one thread per core in each of
    them makes the threads contend: a CIFAR test of a few seconds alone
    then takes minutes. Use with ``pytest.mark.usefixtures``, after
    importing this fixture into the test module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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
