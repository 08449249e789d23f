"""The five backbones at a bf16 compute dtype through the JAX package and the
port from one set of weights and draws (tests/test_torch_bf16_models*.py).

:func:`check_model` runs JAX's module at fp32 and at bf16 and the port's at
fp32 and at bf16, at eval, each JAX draw recorded and handed to the port,
and holds:

* the dtype of every block's and layer's output, in call order (a forward
  hook on the port's modules, flax's ``capture_intermediates`` on JAX's,
  over the classes in :data:`TRACED`): equal to JAX's;
* the logits: fp32 on both sides;
* the port's bf16 drift from its own fp32 logits under the bound of JAX's
  ``tests/test_bf16_backbones.py`` (0.15 of the logits' scale for
  DistilBERT, 0.2 for the others);
* max |port bf16 - JAX fp32| <= 2 max |JAX bf16 - JAX fp32| + 2^-8 scale,
  the scale the largest JAX fp32 logit: the port in bf16 lies no farther
  from the fp32 answer than twice JAX's own bf16 error, plus a bf16
  rounding of the scale (the two frameworks round at other places: the
  port's K1 adds bias and noise in fp32 and rounds once where JAX's BBB
  layer does it in bf16 arithmetic; sums run in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close, nchw
from _torch_wilds_parity import RECORDED, record_draws
from beyond_deep_ensembles_tpu_torch.models.jax_convert import buffers_from_jax, params_from_jax
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

# the modules whose outputs' dtypes are compared (the same class names in
# both packages)
TRACED = {
    "Conv", "Dense", "BBBConv", "BBBDense", "Rank1Conv", "Rank1Dense", "SpectralNormConv", "SpectralNormDense",
    "FilterResponseNorm", "VariationalFilterResponseNorm", "StaticBatchNorm", "LayerNorm", "Embed",
    "BasicBlock", "Bottleneck", "DenseLayer", "DenseNet", "TransformerBlock", "DistilBertEncoder",
}
DRIFT = {"bert": 0.15}  # JAX tests/test_bf16_backbones.py; 0.2 for the others


def weights(module, x, seed=4):
    """JAX params near init, drawn with numpy (means N(0, 0.1), rho near -3,
    norm scales and FRN gammas near 1, Rank-1 factor means near +-1), and the
    model state of JAX's init (the spectral norms' ``u``)."""
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1), "dropout": jax.random.key(2)}
    variables = jax.eval_shape(lambda: module.init(rngs, jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("__grho"):
            return -3.0 + 0.3 * z
        if name.startswith("gamma") or name == "scale":
            return 1.0 + 0.1 * z
        if name in ("s__gmean", "r__gmean"):
            return np.sign(z) * (1.0 + np.abs(0.1 * z))
        return 0.1 * z

    params = jax.tree_util.tree_map_with_path(leaf, variables["params"])
    state = {}
    if len(variables) > 1:
        init = jax.jit(lambda k: module.init({"params": k, "noise": k, "dropout": k}, jnp.asarray(x), train=False))
        state = {c: v for c, v in init(jax.random.key(1)).items() if c != "params"}
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def jax_forward(module, params, state, x, **kwargs):
    """JAX's eval forward, jitted: (logits, [(class, dtype)] in post-order,
    draws). flax asks the ``capture_intermediates`` filter as each call
    returns, so the filter keeps the call order (a jitted output's dicts
    come back sorted by key)."""
    RECORDED.clear()
    calls = []

    def traced(mdl, method):
        if method == "__call__" and type(mdl).__name__ in TRACED:
            calls.append((mdl.scope.path, type(mdl).__name__))
            return True
        return False

    apply = jax.jit(lambda variables, x: module.apply(
        variables, x, train=False, rngs={"noise": jax.random.key(7), "dropout": jax.random.key(8)},
        mutable=["intermediates", "kl", *state.keys()], capture_intermediates=traced, **kwargs))
    out, mutated = apply({"params": params, **state}, jnp.asarray(x))
    jax.effects_barrier()
    draws = [a for _, a in RECORDED]
    order = []
    for path, name in calls:
        node = mutated["intermediates"]
        for key in path:
            node = node[key]
        order.append((name, jnp.dtype(node["__call__"][0].dtype).name))
    return np.asarray(out, np.float32), out.dtype, order, draws


def port_forward(net, x, draws, **kwargs):
    """The port's eval forward on JAX's draws: (logits, [(class, dtype)] in
    the order the modules return)."""
    order, hooks = [], []
    for m in net.modules():
        if type(m).__name__ in TRACED:
            hooks.append(m.register_forward_hook(
                lambda mod, args, out: order.append((type(mod).__name__, str(out.dtype).replace("torch.", "")))))
    noise = NoiseSource(given=[nchw(d) for d in draws])
    try:
        with torch.no_grad():
            out = net(x, noise, train=False, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    assert noise.draws == len(draws), (noise.draws, len(draws))
    return out, order


def load(net, params, state, bert=False):
    from beyond_deep_ensembles_tpu_torch.models.jax_convert import bert_from_jax

    sd = bert_from_jax(params) if bert else {**params_from_jax(params), **buffers_from_jax(state)}
    net.load_state_dict(sd, strict=True)
    return net


def check_model(monkeypatch, arch, jax_module, port_net, x_jax, x_port, fp32_module, fp32_net, expect_bf16=True,
                **kwargs):
    """``jax_module``/``port_net`` at bf16 and ``fp32_module``/``fp32_net``
    the same at fp32, on the same weights (``port_net`` and ``fp32_net`` are
    loaded here): every hold of the module docstring."""
    record_draws(monkeypatch)
    params, state = weights(fp32_module, x_jax)
    is_bert = arch == "bert"
    load(port_net, params, state, is_bert)
    load(fp32_net, params, state, is_bert)
    ref32, dt32, order32, draws32 = jax_forward(fp32_module, params, state, x_jax, **kwargs)
    ref16, dt16, order16, draws16 = jax_forward(jax_module, params, state, x_jax, **kwargs)
    assert dt32 == jnp.float32 and dt16 == jnp.float32
    assert len(draws32) == len(draws16) and all(np.array_equal(a, b) for a, b in zip(draws32, draws16))
    got32, port_order32 = port_forward(fp32_net, x_port, draws32, **kwargs)
    got16, port_order16 = port_forward(port_net, x_port, draws16, **kwargs)
    assert got16.dtype == torch.float32 and got32.dtype == torch.float32
    assert port_order16 == order16, f"bf16 dtypes by layer differ:\nport {port_order16}\njax  {order16}"
    assert port_order32 == order32
    # a model of rank-1 or spectral layers gets no compute dtype: fp32 throughout
    assert any(dt == "bfloat16" for _, dt in order16) == expect_bf16
    got16, got32 = got16.numpy(), got32.numpy()
    scale = max(float(np.abs(ref32).max()), 1e-3)
    assert_close(got32, ref32, rtol=0, atol=1e-4 * max(scale, 1.0), err_msg=f"{arch} fp32 logits")
    drift = DRIFT.get(arch, 0.2)
    assert np.isfinite(got16).all()
    assert_close(got16, got32, rtol=0, atol=drift * scale, err_msg=f"{arch} bf16 drift from the port's fp32")
    jax_err = float(np.abs(ref16 - ref32).max())
    assert_close(got16, ref32, rtol=0, atol=2 * jax_err + 2.0**-8 * scale,
                 err_msg=f"{arch} bf16 against JAX's fp32 (JAX's bf16 error {jax_err:.3g})")
