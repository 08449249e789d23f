"""PyTorch port, the loss surface (``evals/surface.py``) and the plots and
tables (``evals/plotting.py``), held against the JAX package:

* ``plane_basis`` of three parameter trees of a tiny MLP (4 -> 8 -> 3):
  ``u``, ``v`` and the anchors' coordinates within rtol 1e-5, atol 1e-6 (the
  vectors in JAX's leaf order, each leaf converted to the port's layout);
  ``loss_surface`` (grid 5, margin 0.2, the loss evaluated in chunks by
  ``vmap``) on the MLP's cross-entropy: the axes within 1e-5 and the values
  within rtol 1e-5, atol 1e-5; a flat-vector input likewise;
* under the Agg backend, ``reliability_diagram`` (CalibrationResults from
  the same points on both sides) and ``regression_calibration_plot`` (the
  same arrays, tensors on the port's side): every line's x and y data
  within 1e-6, the texts and annotations equal; ``regression_table``'s
  text (orgtbl and the LaTeX rows) equal, and its file written.
"""
import types

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from _torch_parity import assert_close  # noqa: E402
from beyond_deep_ensembles_tpu.evals import calibration as jax_calibration  # noqa: E402
from beyond_deep_ensembles_tpu.evals import plotting as jax_plotting  # noqa: E402
from beyond_deep_ensembles_tpu.evals import surface as jax_surface  # noqa: E402
from beyond_deep_ensembles_tpu.models.zoo import MLP as JaxMLP  # noqa: E402
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel  # noqa: E402
from beyond_deep_ensembles_tpu_torch import tree  # noqa: E402
from beyond_deep_ensembles_tpu_torch.evals import calibration, plotting, surface  # noqa: E402
from beyond_deep_ensembles_tpu_torch.models.jax_convert import model_params_from_jax  # noqa: E402
from beyond_deep_ensembles_tpu_torch.models.zoo import MLP  # noqa: E402
from beyond_deep_ensembles_tpu_torch.nn.base import Model  # noqa: E402

TOL = {"rtol": 1e-5, "atol": 1e-6}


def _setup():
    jmodel = JaxModel(JaxMLP(layer_dims=(8,), out_dim=3))
    rng = np.random.RandomState(0)
    x = rng.standard_normal((16, 4)).astype(np.float32)
    y = rng.randint(0, 3, 16)
    anchors = [jmodel.init(jax.random.key(i), jnp.asarray(x[:2]))[0] for i in range(3)]
    module = MLP(4, (8,), 3, generator=torch.Generator().manual_seed(0))
    ported = [model_params_from_jax(module, a) for a in anchors]
    return jmodel, anchors, Model(module), ported, (x, y)


def _flat_jax(module, jax_vector, template):
    """A JAX flat vector (its sorted leaves, JAX layouts) in the port's
    sorted order and layouts."""
    from beyond_deep_ensembles_tpu_torch.models.jax_convert import _unravel_sorted, sorted_flat_from_jax

    tree_np = jax.tree.map(np.asarray, template)
    return sorted_flat_from_jax(module, _unravel_sorted(tree_np, np.asarray(jax_vector)))


def test_plane_basis_and_loss_surface_match_jax():
    jmodel, anchors, model, ported, (x, y) = _setup()
    ju, jv, jcoords = jax_surface.plane_basis(*anchors)
    u, v, coords = surface.plane_basis(*ported)
    assert_close(u.numpy(), _flat_jax(model.module, ju, anchors[0]).numpy(), **TOL, err_msg="u")
    assert_close(v.numpy(), _flat_jax(model.module, jv, anchors[0]).numpy(), **TOL, err_msg="v")
    assert_close(coords.numpy(), np.asarray(jcoords), **TOL, err_msg="anchor coordinates")

    def jax_loss(p):
        out, _, _ = jmodel.apply(p, {}, None, jnp.asarray(x), train=False, mutable_state=False)
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(16), jnp.asarray(y)])

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss(p):
        out, _, _ = model.apply(p, {}, None, xt, train=False)
        return -torch.mean(torch.log_softmax(out, -1)[torch.arange(16), yt])

    want = jax_surface.loss_surface(jax_loss, *anchors, grid=5)
    got = surface.loss_surface(loss, *ported, grid=5)
    for name, g, w in zip(("xs", "ys", "values", "coords"), got, want):
        assert_close(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"loss_surface {name}")

    flats = [tree.ravel(tree.sorted_named(p)) for p in ported]
    unravel = tree.make_unravel(tree.sorted_named(ported[0]))
    flat_got = surface.loss_surface(lambda vec: loss(unravel(vec)), *flats, grid=5)
    for g, w in zip(flat_got, got):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _lines(ax):
    return [(np.asarray(line.get_xdata(), np.float64), np.asarray(line.get_ydata(), np.float64))
            for line in ax.get_lines()]


def _texts(ax):
    return [t.get_text() for t in ax.texts]


def _same_axes(got, want, what):
    assert len(_lines(got)) == len(_lines(want))
    for i, ((gx, gy), (wx, wy)) in enumerate(zip(_lines(got), _lines(want))):
        assert_close(gx, wx, rtol=1e-6, atol=1e-6, err_msg=f"{what} line {i} x")
        assert_close(gy, wy, rtol=1e-6, atol=1e-6, err_msg=f"{what} line {i} y")
    assert _texts(got) == _texts(want)
    assert (got.get_xlabel(), got.get_ylabel(), got.get_xlim(), got.get_ylim()) == (
        want.get_xlabel(), want.get_ylabel(), want.get_xlim(), want.get_ylim())


def test_plots_match_jax():
    rng = np.random.RandomState(1)
    correct = rng.rand(200) < 0.7
    conf = rng.uniform(0.2, 1.0, 200).astype(np.float32)
    jres = jax_calibration.CalibrationResults.create(10, jnp.asarray(correct), jnp.asarray(conf))
    res = calibration.CalibrationResults.create(10, torch.from_numpy(correct), torch.from_numpy(conf))
    fig, (a, b) = plt.subplots(1, 2)
    _same_axes(plotting.reliability_diagram(res, ax=a, title="port"),
               jax_plotting.reliability_diagram(jres, ax=b, title="port"), "reliability")
    plt.close(fig)

    ps = np.linspace(0, 1, 10).astype(np.float32)
    cdf = np.sort(rng.uniform(0, 1, 10)).astype(np.float32)
    jreg = types.SimpleNamespace(quantile_ps=jnp.asarray(ps), observed_cdf=jnp.asarray(cdf), qce=jnp.float32(0.1))
    reg = types.SimpleNamespace(quantile_ps=torch.from_numpy(ps), observed_cdf=torch.from_numpy(cdf),
                                qce=torch.tensor(0.1))
    fig, (a, b) = plt.subplots(1, 2)
    _same_axes(plotting.regression_calibration_plot(reg, ax=a, title="energy"),
               jax_plotting.regression_calibration_plot(jreg, ax=b, title="energy"), "regression calibration")
    plt.close(fig)


def test_regression_table_matches_jax(tmp_path):
    rng = np.random.RandomState(2)

    def reps(n, tensor):
        wrap = torch.tensor if tensor else jnp.float32
        return [types.SimpleNamespace(**{k: wrap(float(rng.standard_normal())) for k in
                                         ("average_lml", "mse_of_means", "qce", "sqce")}) for _ in range(n)]

    rng_state = rng.get_state()
    want = jax_plotting.regression_table("yacht", [("map", reps(3, False)), ("bbb", reps(5, False))], latex=True)
    rng.set_state(rng_state)
    path = tmp_path / "table.txt"
    got = plotting.regression_table("yacht", [("map", reps(3, True)), ("bbb", reps(5, True))],
                                    filename=str(path), latex=True)
    assert got == want
    assert path.read_text() == want
