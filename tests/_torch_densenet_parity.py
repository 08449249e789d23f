"""The tiny DenseNet through the JAX package's ``DenseNetClassifier`` and the
port's ``models/densenet.py`` from JAX's weights and draws: logits and
parameter gradients (tests/test_torch_densenet.py,
tests/test_torch_densenet_kinds.py).

Tolerances: logits 1e-4 and parameter gradients 1e-4 of the largest
gradient (fp32 through 12 convolutions and 10 batch norms whose sums run in
another order on each side)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close, nchw, random_jax_params
from _torch_wilds_parity import RECORDED, record_draws
from beyond_deep_ensembles_tpu.models.densenet import DenseNetClassifier as JaxDenseNet
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu_torch.models.densenet import DenseNetClassifier
from beyond_deep_ensembles_tpu_torch.models.jax_convert import buffers_from_jax, params_from_jax
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

TINY = dict(growth_rate=4, block_config=(2, 2), init_features=8, bn_size=2)
CLASSES, BATCH = 5, 4


def example(seed=0):
    return np.random.RandomState(seed).standard_normal((BATCH, 32, 32, 3)).astype(np.float32)


# (conv kind, dropout_p, dropout_freeze_eval, component)
CASES = {
    "plain": ("plain", None, True, None),
    "bbb": ("bbb", None, True, None),
    "rank1-c0": ("rank1", None, True, 0),
    "rank1-c1": ("rank1", None, True, 1),
    "spectral": ("spectral", None, True, None),
    "mcd-frozen": ("plain", 0.3, True, None),
    "mcd-rescaled": ("plain", 0.3, False, None),
}


def _jax_module(kind, dropout_p, freeze):
    return JaxDenseNet(classes=CLASSES, conv_kind=kind, head_kind=kind, components=2 if kind == "rank1" else 1,
                       dropout_p=dropout_p, dropout_freeze_eval=freeze, **TINY)


@functools.lru_cache(maxsize=None)
def jax_weights(case):
    """JAX's params (drawn with numpy near init: means N(0, 0.1), rho near
    -3, the norms' scales near 1) and model state (the spectral norm's ``u``
    from JAX's init)."""
    kind, p, freeze, _ = CASES[case]
    module = _jax_module(kind, p, freeze)
    params, state = random_jax_params(module, (2, 32, 32, 3), seed=4), {}
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: 1.0 + leaf if getattr(path[-1], "key", None) == "scale" else leaf, params)
    if kind == "spectral":
        _, state = jax.jit(lambda k: JaxModel(module).init(k, jnp.zeros((2, 32, 32, 3))))(jax.random.key(1))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, dict(state))


def check_case(case, train, monkeypatch):
    """One case's logits and gradients, JAX's against the port's."""
    kind, dropout_p, freeze, component = CASES[case]
    params, state = jax_weights(case)
    x, w = example(), np.random.RandomState(9).standard_normal((BATCH, CLASSES)).astype(np.float32)
    model = JaxModel(_jax_module(kind, dropout_p, freeze))
    kwargs = {} if component is None else {"component": component}

    def loss(p):
        out, _, _ = model.apply(p, state, jax.random.key(7), jnp.asarray(x), train=train, **kwargs)
        return jnp.sum(out * w), out

    record_draws(monkeypatch)
    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    jax.effects_barrier()
    draws = [nchw(a) for _, a in RECORDED]

    net = DenseNetClassifier(CLASSES, head_kind=kind, conv_kind=kind, components=2 if kind == "rank1" else 1,
                             dropout_p=dropout_p, dropout_freeze_eval=freeze, generator=torch.Generator(), **TINY)
    net.load_state_dict({**params_from_jax(params), **buffers_from_jax(state)}, strict=True)
    noise = NoiseSource(given=draws)
    out = net(nchw(x), noise, train=train, component=component)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert noise.draws == len(draws)
    assert_close(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4, err_msg=f"{case} logits")
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max(float((p.grad - want[n]).abs().max()) for n, p in net.named_parameters())
    assert_close(worst, 0.0, rtol=0, atol=1e-4 * scale, err_msg=f"{case} gradients")


