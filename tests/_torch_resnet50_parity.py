"""The tiny ResNet-50 (stage sizes (1, 1)) on 3 channels and the full
ResNet-18 on PovertyMap's 8 through the JAX package's ``ResNet50`` /
``ResNet18`` and the port's ``models/resnet.py`` from JAX's weights and
draws, on 32x32 inputs: logits and parameter gradients
(tests/test_torch_resnet50.py, tests/test_torch_resnet50_kinds.py,
tests/test_torch_resnet18.py, tests/test_torch_resnet18_kinds.py).

Outputs and parameter gradients are compared under swish; the plain and
torchvision nets' outputs also under the tasks' relu. A ReLU input within
rounding of zero (a few in 1e5 of them at this size) falls on the other side
of the kink in each framework and moves a parameter gradient by a whole
activation's share: seen at 1.3 % of the largest gradient in the plain
case's first block, where the port's fp32 gradient agrees with its float64
one to 1e-6 and JAX's takes the other branch. Swish has no kink, so the
gradients are held under it; ``F.relu`` and ``nn.relu`` agree everywhere
but at 0.

Tolerances: outputs 1e-4 and parameter gradients 1e-4 of the largest
gradient (fp32 through 9 convolutions and 8 batch norms whose sums run in
another order on each side), as the DenseNet's (tests/_torch_densenet_parity.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close, nchw, random_jax_params
from _torch_wilds_parity import RECORDED, record_draws
from beyond_deep_ensembles_tpu.models.resnet import ResNet18 as JaxResNet18
from beyond_deep_ensembles_tpu.models.resnet import ResNet50 as JaxResNet50
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.models.jax_convert import buffers_from_jax, params_from_jax
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet18, ResNet50
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

STAGES = (1, 1)
CLASSES, BATCH = 5, 4

# (conv kind, dropout_p, dropout_freeze_eval, component, other module fields)
CASES = {
    "plain": ("plain", None, True, None, {}),
    "torchvision": ("plain", None, True, None, {"torchvision": True}),
    "bbb": ("bbb", None, True, None, {}),
    "rank1-c0": ("rank1", None, True, 0, {}),
    "rank1-c1": ("rank1", None, True, 1, {}),
    "spectral-features": ("spectral", None, True, None, {"features_only": True}),
    "mcd-rescaled": ("plain", 0.3, False, None, {}),
    "mcd-frozen": ("plain", 0.3, True, None, {}),
}
# (the JAX module, the port's, input channels): ResNet-18 has no stage
# sizes, torchvision topology or eval-dropout switch (its masks freeze at
# eval, FixableDropout's default)
ARCHS = {"resnet50": (JaxResNet50, ResNet50, 3), "resnet18": (JaxResNet18, ResNet18, 8)}
# the cases whose outputs are also held under relu (one more JAX compile)
RELU_CASES = ("plain", "torchvision")


def example(seed=0, channels=3):
    return np.random.RandomState(seed).standard_normal((BATCH, 32, 32, channels)).astype(np.float32)


def _kwargs(case, activation="relu", arch="resnet50"):
    kind, dropout_p, freeze, _, extra = CASES[case]
    kw = dict(classes=CLASSES, conv_kind=kind, head_kind=kind, components=2 if kind == "rank1" else 1,
              dropout_p=dropout_p, activation=activation, **extra)
    if arch == "resnet50":
        kw.update(dropout_freeze_eval=freeze, stage_sizes=STAGES)
    return kw


@functools.lru_cache(maxsize=None)
def jax_weights(case, arch="resnet50"):
    """JAX's params (drawn with numpy near init: means N(0, 0.1), rho near
    -3, the norms' scales near 1) and model state (the spectral norm's ``u``
    from JAX's init)."""
    jax_cls, _, channels = ARCHS[arch]
    module = jax_cls(**_kwargs(case, arch=arch))
    params, state = random_jax_params(module, (2, 32, 32, channels), seed=4), {}
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1.0 + leaf if getattr(path[-1], "key", None) == "scale" else leaf, params)
    if arch == "resnet18":
        params = jax.tree_util.tree_map_with_path(_rank1_factor_near_init, params)
    if case.startswith("spectral"):
        _, state = jax.jit(lambda k: JaxModel(module).init(k, jnp.zeros((2, 32, 32, channels))))(jax.random.key(1))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, dict(state))


def _rank1_factor_near_init(path, leaf):
    """A Rank-1 factor's means at +-(1 + |0.1 z|), near ``sign_mean_init``'s
    +-1, the others as drawn. With means of 0.1 z every one of the full
    ResNet-18's 20 rank-1 layers scales its signal by about 0.01 before a
    static batch norm over 16 values a channel (batch 4 at 2x2) scales it
    back, and both frameworks' fp32 outputs land 2.6e-4 (the port) and 4e-3
    (JAX) of their largest entry from a float64 forward."""
    if getattr(path[-1], "key", None) in ("s__gmean", "r__gmean"):
        return np.sign(leaf) * (1.0 + np.abs(leaf))
    return leaf


def _run(case, train, activation, arch):
    """One case under ``activation``, JAX's draws recorded (``record_draws``
    installed): (JAX's outputs, gradients by port name; the port's outputs,
    its module)."""
    component = CASES[case][3]
    jax_cls, port_cls, channels = ARCHS[arch]
    params, state = jax_weights(case, arch)
    x = example(channels=channels)
    module = jax_cls(**_kwargs(case, activation, arch))
    model = JaxModel(module)
    kwargs = {} if component is None else {"component": component}
    features = 512 if arch == "resnet18" else 256 * 2 ** (len(STAGES) - 1)
    width = CLASSES if not module.features_only else features
    w = np.random.RandomState(9).standard_normal((BATCH, width)).astype(np.float32)

    def loss(p):
        out, _, _ = model.apply(p, state, jax.random.key(7), jnp.asarray(x), train=train, **kwargs)
        return jnp.sum(out * w), out

    RECORDED.clear()
    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jax.effects_barrier()
    draws = [nchw(a) for _, a in RECORDED]

    extra = {"in_channels": channels} if arch == "resnet18" else {}
    net = port_cls(**_kwargs(case, activation, arch), **extra, generator=torch.Generator())
    net.load_state_dict({**params_from_jax(params), **buffers_from_jax(state)}, strict=True)
    noise = NoiseSource(given=draws)
    out = net(nchw(x), noise, train=train, component=component)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert noise.draws == len(draws)
    return np.asarray(ref), params_from_jax(jax.tree.map(np.asarray, grads)), out.detach().numpy(), net


def check_case(case, train, monkeypatch, arch="resnet50"):
    """One case's outputs (logits, or features under ``features_only``)
    and parameter gradients under swish, and its outputs under relu for
    :data:`RELU_CASES`, JAX's against the port's."""
    record_draws(monkeypatch)
    if case in RELU_CASES:
        ref, _, out, _ = _run(case, train, "relu", arch)
        assert_close(out, ref, rtol=0, atol=1e-4, err_msg=f"{case} outputs (relu)")
    ref, want, out, net = _run(case, train, "swish", arch)
    assert_close(out, ref, rtol=0, atol=1e-4, err_msg=f"{case} outputs (swish)")
    assert want.keys() == dict(net.named_parameters()).keys()
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(float((p.grad - want[n]).abs().max()) for n, p in net.named_parameters())
    assert_close(worst, 0.0, rtol=0, atol=1e-4 * scale, err_msg=f"{case} gradients (swish)")
