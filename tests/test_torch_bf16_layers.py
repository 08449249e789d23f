"""PyTorch port, the layers at a bf16 compute dtype against the JAX package's
(flax) layers at bf16, on one set of numpy weights and inputs and, for the
BBB layers, JAX's own noise handed to the port: ``Dense`` (and an fp32 head
``Dense`` on a bf16 input, which promotes to fp32), ``Conv`` (a 3x3 and a
strided 1x1, which JAX lowers to a dot), ``BBBDense`` and ``BBBConv`` (train
and frozen eval), ``FilterResponseNorm`` on bf16 input (its fp32 ``gamma``
promotes the output to fp32), ``StaticBatchNorm`` (fp32 statistics, bf16
out), flax's ``LayerNorm`` and ``Embed``.

Holds: the output dtype equal to JAX's; the output within 2^-7 of its
largest magnitude; every parameter gradient within 2^-6 of the largest
parameter gradient (bf16 keeps 8 bits: one rounding is 2^-9 relative, and
the frameworks round at other places: JAX's BBB layer adds the bias and the
noise in bf16 arithmetic where the port's K1 does it in fp32 and rounds
once; XLA's and torch's bf16 products and reductions sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from _torch_parity import assert_close, nchw
from _torch_wilds_parity import RECORDED, record_draws
from beyond_deep_ensembles_tpu.models.layers import Conv as JaxConv
from beyond_deep_ensembles_tpu.nn.bbb import BBBConv as JaxBBBConv
from beyond_deep_ensembles_tpu.nn.bbb import BBBDense as JaxBBBDense
from beyond_deep_ensembles_tpu.nn.frn import FilterResponseNorm as JaxFRN
from beyond_deep_ensembles_tpu.nn.norm import StaticBatchNorm as JaxStaticBN
from beyond_deep_ensembles_tpu_torch.models.bert import Embed
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax
from beyond_deep_ensembles_tpu_torch.nn.bbb import BBBConv, BBBDense
from beyond_deep_ensembles_tpu_torch.nn.frn import FilterResponseNorm
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.nn.norm import StaticBatchNorm
from beyond_deep_ensembles_tpu_torch.nn.plain import Conv, Dense, LayerNorm

BF16 = jnp.bfloat16
OUT_TOL = 2.0**-7  # of the output's largest magnitude
GRAD_TOL = 2.0**-6  # of the largest parameter gradient
G = torch.Generator()  # the port's init, overwritten by JAX's weights


def _bf16_values(shape, seed):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


def _params(module, x, kwargs, seed=3):
    """numpy params near init: rho near -3, scales and gammas near 1, the
    rest N(0, 0.3)."""
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    shapes = jax.eval_shape(lambda: module.init(rngs, x, **kwargs))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("__grho"):
            return -3.0 + 0.3 * z
        if name in ("scale", "gamma"):
            return 1.0 + 0.1 * z
        return 0.3 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


BF = torch.bfloat16
CASES = {
    # name: (JAX module, port module, input shape (JAX layout), JAX input dtype, JAX call kwargs)
    "dense": (lambda: fnn.Dense(8, dtype=BF16), lambda: Dense(6, 8, dtype=BF, generator=G), (4, 6), BF16, {}),
    "dense-fp32-head": (lambda: fnn.Dense(8), lambda: Dense(6, 8, generator=G), (4, 6), BF16, {}),
    "conv3x3": (lambda: JaxConv(8, (3, 3), padding=[(1, 1), (1, 1)], dtype=BF16),
                lambda: Conv(3, 8, (3, 3), padding=1, dtype=BF, generator=G), (2, 6, 6, 3), BF16, {}),
    "conv1x1-stride2": (lambda: JaxConv(8, (1, 1), strides=(2, 2), padding=[(0, 0), (0, 0)], use_bias=False,
                                        dtype=BF16),
                        lambda: Conv(3, 8, (1, 1), strides=2, padding=0, use_bias=False, dtype=BF, generator=G),
                        (2, 6, 6, 3), BF16, {}),
    "bbb-dense-train": (lambda: JaxBBBDense(8, dtype=BF16), lambda: BBBDense(6, 8, dtype=BF, generator=G),
                        (4, 6), BF16, {"train": True}),
    "bbb-dense-frozen": (lambda: JaxBBBDense(8, dtype=BF16), lambda: BBBDense(6, 8, dtype=BF, generator=G),
                         (4, 6), BF16, {"train": False}),
    "bbb-conv-train": (lambda: JaxBBBConv(8, (3, 3), padding=1, dtype=BF16),
                       lambda: BBBConv(3, 8, (3, 3), padding=1, dtype=BF, generator=G), (2, 6, 6, 3), BF16,
                       {"train": True}),
    "bbb-conv-frozen": (lambda: JaxBBBConv(8, (3, 3), strides=2, padding=1, dtype=BF16),
                        lambda: BBBConv(3, 8, (3, 3), strides=2, padding=1, dtype=BF, generator=G), (2, 6, 6, 3),
                        BF16, {"train": False}),
    "frn": (lambda: JaxFRN(), lambda: FilterResponseNorm(5), (2, 4, 4, 5), BF16, {}),
    "static-bn": (lambda: JaxStaticBN(), lambda: StaticBatchNorm(5), (4, 3, 3, 5), BF16, {}),
    "layer-norm": (lambda: fnn.LayerNorm(dtype=BF16), lambda: LayerNorm(16, dtype=BF), (3, 5, 16), BF16, {}),
}


def _port_call(name, layer, x, noise, kwargs):
    if name in ("static-bn", "layer-norm"):
        return layer(x)
    return layer(x, noise, train=kwargs.get("train", True))


@pytest.mark.parametrize("name", list(CASES))
def test_layer_bf16_matches_jax(name, monkeypatch):
    jax_make, port_make, shape, in_dtype, kwargs = CASES[name]
    module = jax_make()
    x_np = _bf16_values(shape, seed=1)
    x = jnp.asarray(x_np, in_dtype)
    params = jax.tree.map(np.asarray, _params(module, x, kwargs))
    record_draws(monkeypatch)

    def forward(p):
        return module.apply({"params": p}, x, rngs={"noise": jax.random.key(5)}, **kwargs)

    want, vjp = jax.vjp(forward, params)
    jax.effects_barrier()
    draws = [a for _, a in RECORDED]
    cot = _bf16_values(want.shape, seed=2)
    want_grads = params_from_jax(jax.tree.map(np.asarray, vjp(jnp.asarray(cot, want.dtype))[0]))

    layer = port_make()
    layer.load_state_dict(params_from_jax(params), strict=True)
    to_port = nchw if len(shape) == 4 else torch.from_numpy
    xt = to_port(x_np).to(torch.bfloat16)
    out = _port_call(name, layer, xt, NoiseSource(given=[nchw(d) for d in draws]), kwargs)
    assert str(out.dtype).replace("torch.", "") == jnp.dtype(want.dtype).name, (out.dtype, want.dtype)
    (out.float() * to_port(cot)).sum().backward()
    got = out.detach().float()
    if len(shape) == 4:
        got = got.permute(0, 2, 3, 1)
    want = np.asarray(want, np.float32)
    assert_close(got.numpy(), want, rtol=0, atol=OUT_TOL * float(np.abs(want).max()), err_msg=f"{name} output")
    grads = dict(layer.named_parameters())
    assert grads.keys() == want_grads.keys()
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for key, p in grads.items():
        assert_close(p.grad.numpy(), want_grads[key].numpy(), rtol=0, atol=GRAD_TOL * scale,
                     err_msg=f"{name} d{key}")


def test_embed_bf16_matches_jax():
    """flax ``nn.Embed(dtype=bf16)``: the table cast to bf16, then looked up;
    the gradient of the fp32 table."""
    module = fnn.Embed(50, 16, dtype=BF16)
    ids = np.random.RandomState(0).randint(0, 50, (3, 7))
    table = 0.3 * np.random.RandomState(1).standard_normal((50, 16)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: module.apply({"params": {"embedding": t}}, jnp.asarray(ids)), jnp.asarray(table))
    cot = _bf16_values(want.shape, seed=2)
    (want_grad,) = vjp(jnp.asarray(cot, want.dtype))
    layer = Embed(50, 16, dtype=torch.bfloat16, generator=torch.Generator())
    layer.load_state_dict({"embedding": torch.from_numpy(table)})
    out = layer(torch.from_numpy(ids))
    assert out.dtype == torch.bfloat16 and want.dtype == BF16
    (out.float() * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want, np.float32)
    assert_close(out.detach().float().numpy(), want, rtol=0, atol=OUT_TOL * float(np.abs(want).max()),
                 err_msg="embed output")
    want_grad = np.asarray(want_grad, np.float32)
    assert_close(layer.embedding.grad.numpy(), want_grad, rtol=0, atol=GRAD_TOL * float(np.abs(want_grad).max()),
                 err_msg="embed d embedding")
