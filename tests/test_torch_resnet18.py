"""PyTorch port, models/resnet.py's ``ResNet18`` and experiments/
wilds_task.py's ``PovertyNet`` against the JAX package's, on PovertyMap's 8
channels: the plain kind (static batch norms, the same forward at train and
eval; outputs under relu and swish, gradients under swish, as a ReLU input
at rounding distance of zero takes another side of the kink in each
framework) and the spectral featurizer (``features_only``, train and eval)
on 32x32 inputs from JAX's weights and draws
(``_torch_resnet50_parity.check_case``), the other kinds in
tests/test_torch_resnet18_kinds.py; the full-width parameter trees against
``jax.eval_shape`` of JAX's ``init`` (plain, BBB, and ``PovertyNet`` with
its ``GaussLayer_0.rho__mle``); and ``PovertyNet``'s regression loss, its
gradients and its ``(mean, std)`` prediction from one set of weights.

Tolerances: outputs 1e-4, parameter gradients 1e-4 of the largest gradient
(fp32 sums in another order on each side); the NLL 1e-5 and ``rho__mle``'s
gradient 1e-4 relative (both divide squared residuals by the variance,
0.01 at ``init_std`` 0.1, so the forward's fp32 gap reaches them a hundred
times larger: 1.4e-6 and 1.5e-6 measured); the structure exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, nchw, random_jax_params
from _torch_resnet50_parity import check_case
from _torch_wilds_parity import swish_resnets
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.models.resnet import ResNet18 as JaxResNet18
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet18
from beyond_deep_ensembles_tpu_torch.nn.base import Model

POVERTY = {**jax_wilds.DEFAULT_CONFIG, "tiny": True}


@pytest.mark.parametrize("case,train", [("plain", True), ("spectral-features", True), ("spectral-features", False)],
                         ids=["plain", "spectral-features-train", "spectral-features-eval"])
def test_resnet18_matches_jax(case, train, monkeypatch):
    check_case(case, train, monkeypatch, arch="resnet18")


def _shapes(variables):
    """A flax tree as {port name: port shape} (conv kernels HWIO -> OIHW,
    dense kernels [in, out] -> [out, in])."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if hasattr(value, "items"):
                walk(value, path + (str(key),))
                continue
            shape = tuple(value.shape)
            if key.startswith("kernel") and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            elif key.startswith("kernel") and len(shape) == 2:
                shape = shape[::-1]
            out[".".join(path + (str(key),))] = shape

    walk(variables, ())
    return out


def _init_shapes(module, size=224):
    variables = jax.eval_shape(lambda: module.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                                                   jnp.zeros((2, size, size, 8)), train=True))
    return _shapes(variables["params"])


@pytest.mark.parametrize("kind", ["plain", "bbb", "poverty"])
def test_full_width_structure_matches_jax(kind):
    """Names and shapes at 224x224x8, and the counts: 11,174,209 parameters
    plain, 22,340,738 BBB (a mean and a rho per weight, the shortcuts
    without bias), and PovertyNet's one more (``rho__mle``)."""
    if kind == "poverty":
        want = _init_shapes(jax_wilds._make_backbone("poverty", POVERTY, "plain").module)
        net = wilds_task._make_backbone("poverty", POVERTY, torch.Generator())
    else:
        want = _init_shapes(JaxResNet18(classes=1, conv_kind=kind))
        net = ResNet18(1, conv_kind=kind, generator=torch.Generator())
    got = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == {"plain": 11_174_209, "bbb": 22_340_738,
                                                     "poverty": 11_174_210}[kind]


def _poverty_pair(seed=0):
    """JAX's PovertyNet params (numpy draws near init) and the port's net
    holding them, with an example batch and its targets."""
    jmodel = jax_wilds._make_backbone("poverty", POVERTY, "plain")
    params = random_jax_params(jmodel.module, (2, 32, 32, 8), seed=seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1.0 + leaf if getattr(path[-1], "key", None) == "scale" else leaf, params)
    params = jax.tree.map(np.asarray, params)
    net = wilds_task._make_backbone("poverty", POVERTY, torch.Generator())
    net.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.RandomState(seed + 1)
    x = rng.standard_normal((6, 32, 32, 8)).astype(np.float32)
    y = rng.standard_normal((6, 1)).astype(np.float32)
    return jmodel, params, net, x, y


def test_poverty_loss_gradients_and_prediction_match_jax(monkeypatch):
    """``_loss_fn_for(regression=True)``: GaussLayer's NLL (no metric), its
    gradients (under swish, as the other gradients here), ``rho__mle``'s
    among them; ``_predict_fn``: the raw ``(mean, std)`` output ``[B, 1,
    2]``, the std ``softplus(rho)`` everywhere."""
    swish_resnets(monkeypatch)
    jmodel, params, net, x, y = _poverty_pair()
    jloss = jax_wilds._loss_fn_for(jmodel, True)
    (want, jout), grads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o.loss, o.metrics))(jloss(p, {}, jax.random.key(0), (jnp.asarray(x), jnp.asarray(y)))),
        has_aux=True))(params)
    assert jout == {}
    model = Model(net)
    out = wilds_task._loss_fn_for(model, True)(net, {}, None, (nchw(x), torch.from_numpy(y)))
    assert out.metrics == {}
    out.loss.backward()
    assert_close(float(out.loss.detach()), float(want), rtol=1e-5, err_msg="poverty nll")
    want_g = params_from_jax(jax.tree.map(np.asarray, grads))
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    worst = max(float((p.grad - want_g[n]).abs().max()) for n, p in net.named_parameters())
    assert_close(worst, 0.0, rtol=0, atol=1e-4 * scale, err_msg="poverty gradients")
    assert_close(net.GaussLayer_0.rho__mle.grad.numpy(), want_g["GaussLayer_0.rho__mle"], rtol=1e-4,
                 err_msg="rho__mle gradient")

    jpred = jax.jit(lambda p: jax_wilds._predict_fn(jmodel, True)(p, {}, jax.random.key(0), jnp.asarray(x)))(params)
    with torch.no_grad():
        pred = wilds_task._predict_fn(model, True)(net, {}, None, nchw(x))
    assert pred.shape == (6, 1, 2) == jpred.shape
    assert_close(pred.numpy(), np.asarray(jpred), rtol=0, atol=1e-4, err_msg="poverty (mean, std)")


def test_not_ported_options_raise():
    with pytest.raises(NotImplementedError):
        ResNet18(1, dtype=torch.bfloat16, generator=torch.Generator())
    with pytest.raises(ValueError):
        ResNet18(1, activation="gelu", generator=torch.Generator())
