"""PyTorch port, bf16 operands of K1 (ops/sampling.py) and K3
(ops/attention.py): the plain versions against the JAX package at bf16 on
the CPU, and (on a card only) the kernels against the plain versions.

K3's plain version at bf16 (``_PlainBf16``: products of bf16 operands in
fp32, P_drop and dS rounded to bf16 where the TPU kernels round them,
outputs in bf16) against the JAX Pallas kernels run by the TPU interpreter
on bf16 q, k, v, at p = 0 and at keep-all (the interpreter's random bits are
all zero: at p = 0.4 it keeps everything). Tolerances: the output within
2^-7 of its largest magnitude, dQ, dK and dV within 2^-6 of theirs (one
bf16 rounding of the result is 2^-9 relative; the frameworks sum in other
orders and XLA's bf16 dot rounds its own way).

K1's plain version at bf16 (the planes and bias vectors read in bf16, the
arithmetic in fp32, one rounding) against the JAX layers' bf16 epilogue
(``nn/bbb.py:89-95``, ``:163-170``: the bias added, the square root and the
noise applied in bf16 arithmetic, the noise rounded to bf16) on the same
noise: outputs within 2^-7 of the largest output, the gradients of both
planes within 2^-6 of the largest.

On the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_bf16_kernels.py``): K3a and K3b on bf16 against the plain
version (output 2^-7, gradients 2^-6 of their scale) at (2, 128, 3, 64) and
ragged L = 300, 65, 5, with no mask, a given mask, and Philox, whose mask
must be the fp32 kernel's bit for bit (the plain version is fed the mask the
fp32 kernel realizes with the same seed); a device seed equal to the host
seed bit for bit; and at the kernels' tile edges (L = 1, 63, 64, 127, 128,
129, 192, 512; B H = 1 and B H = 144, more panels than the card's 132 SMs)
with a ragged key mask (a row padded inside a tile, one by whole tiles, one
fully padded), where at L = 1 dQ and dK, 0 in exact arithmetic, are held to
the same fraction of the terms they cancel (``_cancelled_scale``); K3b
called alone, drawing the keep bits itself, equal to K3b in training, which
reads K3a's, bit for bit. K1 on bf16 planes against its plain version within
one bf16 ulp, forward and backward, with given noise and with Philox noise
(the z of a seed as the bf16 kernels draw it, read back by ``noise_bf16``); in
the forward beyond what the fp32 sum may differ before its rounding (the
kernel's fused multiply-add against the plain version's rounded product:
2^-22 of |a| + |std z|, ``_bf16_ulps``)."""
import numpy as np
import pytest
import torch

from beyond_deep_ensembles_tpu_torch.ops import attention as att
from beyond_deep_ensembles_tpu_torch.ops import sampling

BF16_OUT = 2.0**-7  # outputs: a fraction of their largest magnitude
BF16_GRAD = 2.0**-6  # gradients: a fraction of their largest magnitude


@pytest.fixture
def cuda_device():
    """The card, for kernel cases; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA and Triton kernels have no CPU mode")
    return torch.device("cuda")


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as fp32 values."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _hold_scaled(got, want, frac, what):
    """|got - want| within ``frac`` of want's largest magnitude (printed)."""
    from _torch_parity import assert_close

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert_close(got, want, rtol=0, atol=frac * scale, err_msg=f"{what} (atol {frac:g} x scale {scale:.3g})")


# --------------------------------------------------------------------------
# K3 on the CPU: the plain bf16 version against the interpreted Pallas kernel
# --------------------------------------------------------------------------

SHAPE = (2, 8, 2, 4)


def _attention_inputs(shape=SHAPE, seed=0):
    b, l, h, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, cot = (_bf16(rng.standard_normal(shape).astype(np.float32)) for _ in range(4))
    mask = np.ones((b, l), np.int32)
    mask[0, 3 * l // 4:] = 0
    return q, k, v, cot, mask


@pytest.mark.parametrize("dropout_p,regime", [(0.0, "none"), (0.4, "keep_all")])
def test_k3_plain_bf16_matches_interpreted_pallas_kernel(dropout_p, regime):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from beyond_deep_ensembles_tpu.ops.attention import fused_dropout_attention

    q, k, v, cot, mask = _attention_inputs()

    def jax_fn(q, k, v):
        return fused_dropout_attention(q, k, v, jnp.asarray(mask), jnp.array([7], jnp.int32), dropout_p=dropout_p,
                                       interpret=pltpu.InterpretParams())

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16

    b, l, h, _ = SHAPE
    keep = None if regime == "none" else torch.ones((b, h, l, l), dtype=torch.bool)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v)]
    out = att.fused_dropout_attention(*leaves, torch.from_numpy(mask), dropout_p=dropout_p, keep=keep)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)
    _hold_scaled(out.float().detach().numpy(), np.asarray(want, np.float32), BF16_OUT, f"output, {regime}")
    for name, t, w in zip("qkv", leaves, want_grads):
        _hold_scaled(t.grad.float().numpy(), np.asarray(w, np.float32), BF16_GRAD, f"d{name}, {regime}")


def test_k3_plain_bf16_rounds_where_the_tpu_kernel_rounds():
    """The plain bf16 version is the fp32 plain version's math with P_drop
    rounded to bf16 before P_drop V and the output rounded: equal to that
    expression bit for bit, and within one bf16 rounding of the fp32 plain
    version on the same (bf16-valued) inputs."""
    q, k, v, _, mask = (torch.from_numpy(a) for a in _attention_inputs((2, 16, 2, 8), seed=1))
    keep = torch.from_numpy(np.random.RandomState(2).rand(2, 2, 16, 16) >= 0.3)
    got = att.dropout_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, keep, dropout_p=0.3)
    _, p_drop = att._bf16_probs(q.bfloat16(), k.bfloat16(), mask, keep, 0.3)
    want = torch.einsum("bhlm,bmhd->blhd", p_drop.bfloat16().float(), v).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    _hold_scaled(got.float().numpy(), att.dropout_attention_plain(q, k, v, mask, keep, dropout_p=0.3).numpy(),
                 2.0**-8, "against fp32")


def test_k3_input_checks_at_bf16():
    q, k, v, _, mask = (torch.from_numpy(a) for a in _attention_inputs())
    with pytest.raises(TypeError):  # one dtype for all three
        att.fused_dropout_attention(q.bfloat16(), k, v.bfloat16(), mask)
    with pytest.raises(TypeError):  # fp16 is neither
        att.fused_dropout_attention(q.half(), k.half(), v.half(), mask)


# --------------------------------------------------------------------------
# K1 on the CPU: the plain bf16 version against the JAX layers' bf16 epilogue
# --------------------------------------------------------------------------


def _to_port(a):
    """JAX layout (channels last) -> port layout (channels at dim 1)."""
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    elif a.ndim == 3:  # one HWC row
        a = a.transpose(2, 0, 1)
    return torch.from_numpy(np.array(a, order="C"))


@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize("shape,bias", [((2, 6, 6, 5), True), ((3, 4, 4, 7), False), ((4, 10), True)])
def test_k1_plain_bf16_matches_jax_bf16_epilogue(shape, bias, frozen):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    c = shape[-1]
    mean = _bf16(0.5 * rng.standard_normal(shape).astype(np.float32))
    var = _bf16((0.25 * rng.rand(*shape) + 1e-4).astype(np.float32))
    b_mean = _bf16(rng.standard_normal(c).astype(np.float32)) if bias else None
    b_var = _bf16((rng.rand(c) + 1e-3).astype(np.float32)) if bias else None
    eps = rng.standard_normal(shape[1:] if frozen else shape).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)

    def jax_fn(m, v, bm, bv):
        # JAX nn/bbb.py:89-95 with acc_t = bf16: bias, sqrt and noise in bf16
        if bm is not None:
            m = m + bm
            v = v + bv
        return m + jnp.sqrt(v) * jnp.broadcast_to(jnp.asarray(eps), shape).astype(jnp.bfloat16)

    args = [jnp.asarray(a, jnp.bfloat16) if a is not None else None for a in (mean, var, b_mean, b_var)]
    want, vjp = jax.vjp(lambda m, v: jax_fn(m, v, args[2], args[3]), args[0], args[1])
    want_dm, want_dv = vjp(jnp.asarray(cot, jnp.bfloat16))

    planes = [_to_port(a).bfloat16().requires_grad_(True) for a in (mean, var)]
    bias_t = [torch.from_numpy(a).bfloat16() if a is not None else None for a in (b_mean, b_var)]
    out = sampling.gaussian_sample(*planes, *bias_t, eps=_to_port(eps))
    assert out.dtype == torch.bfloat16
    (out.float() * _to_port(cot)).sum().backward()
    assert all(p.grad.dtype == torch.bfloat16 for p in planes)
    nhwc = (lambda t: t.permute(0, 2, 3, 1)) if len(shape) == 4 else (lambda t: t)
    _hold_scaled(nhwc(out.detach().float()).numpy(), np.asarray(want, np.float32), BF16_OUT, "sample")
    for name, p, w in zip(("d act_mean", "d act_var"), planes, (want_dm, want_dv)):
        _hold_scaled(nhwc(p.grad.float()).numpy(), np.asarray(w, np.float32), BF16_GRAD, name)


def test_k1_plain_bf16_rounds_once():
    """The bf16 plain version is the fp32 expression on the planes' values,
    rounded once: bit for bit; its backward likewise; and the checks refuse
    mixed types."""
    gen = torch.Generator().manual_seed(3)
    mean = (0.5 * torch.randn(3, 4, 5, 5, generator=gen)).bfloat16()
    var = (0.25 * torch.rand(3, 4, 5, 5, generator=gen) + 1e-4).bfloat16()
    b_mean, b_var = torch.randn(4, generator=gen).bfloat16(), torch.rand(4, generator=gen).bfloat16()
    eps = torch.randn(3, 4, 5, 5, generator=gen)
    got = sampling.gaussian_sample(mean, var, b_mean, b_var, eps=eps)
    want = sampling.gaussian_sample_plain(mean.float(), var.float(), b_mean.float(), b_var.float(), eps).bfloat16()
    assert torch.equal(got, want)
    g = torch.randn(3, 4, 5, 5, generator=gen).bfloat16()
    d_var = sampling.gaussian_sample_backward(g, var, b_var, eps=eps)
    want_d = sampling.gaussian_sample_backward(g.float(), var.float(), b_var.float(), eps=eps).bfloat16()
    assert d_var.dtype == torch.bfloat16 and torch.equal(d_var, want_d)
    with pytest.raises(TypeError):
        sampling.gaussian_sample(mean, var.float(), eps=eps)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(mean, var, b_mean.float(), b_var.float(), eps=eps)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


def _card_attention(device, shape, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, cot = (torch.randn(shape, device=device, generator=gen).bfloat16() for _ in range(4))
    mask = torch.ones(shape[:2], dtype=torch.int32, device=device)
    mask[0, min(77, shape[1] - 1):] = 0
    if shape[1] > 64:
        mask[1, 64:] = 0
    return q, k, v, cot, mask


def _grads(fn, q, k, v, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad((out.float() * cot.float()).sum(), leaves)
    return out.detach(), grads


def _hold_card(got, want, frac, scale=None):
    """|got - want| within ``frac`` of want's largest magnitude, or of
    ``scale`` where one is given."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max()) if scale is None else scale
    assert err <= frac * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [128, 300, 65, 5])
@pytest.mark.parametrize("mode", ["none", "given", "philox"])
def test_k3_bf16_kernel_matches_plain(cuda_device, length, mode):
    shape = (2, length, 3, 64)
    q, k, v, cot, mask = _card_attention(cuda_device, shape)
    b, l, h, _ = shape
    p = 0.0 if mode == "none" else 0.1
    if mode == "philox":
        # the fp32 kernel's realized mask for the same seed
        _, probs = att.fused_dropout_attention_debug(q.float(), k.float(), v.float(), mask, dropout_p=p, seed=123)
        keep, kw = probs > 0, {"seed": 123}
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        keep = torch.rand(b, h, l, l, device=cuda_device, generator=gen) >= p if mode == "given" else None
        kw = {"keep": keep}
    before = att.attention_forward.launches, att.attention_backward.launches
    got, grads = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw), q, k, v, cot)
    assert (att.attention_forward.launches, att.attention_backward.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    again, grads2 = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw), q, k, v, cot)
    assert torch.equal(got, again) and all(torch.equal(a, c) for a, c in zip(grads, grads2))
    ref, ref_grads = _grads(lambda *t: att.dropout_attention_plain(*t, mask, keep, dropout_p=p), q, k, v, cot)
    _hold_card(got, ref, BF16_OUT)
    for g, r in zip(grads, ref_grads):
        _hold_card(g, r, BF16_GRAD)


def _card_operands(device, shape, seed):
    """q, k, v and an output gradient ``[B, L, H, 64]`` in bf16, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, device=device, generator=gen).bfloat16() for _ in range(4)]


def _ragged_mask(device, b, l):
    """A key mask with ragged padding: batch row 0 padded inside a tile (from
    L - L // 3, at least one key kept), row 1 by whole tiles (from 64, where L
    > 64), row 2 fully padded (its softmax is 1 / L at every key); the rest
    attend to every key."""
    mask = torch.ones(b, l, dtype=torch.int32, device=device)
    mask[0, max(1, l - l // 3):] = 0
    if b > 1 and l > 64:
        mask[1, 64:] = 0
    if b > 2:
        mask[2] = 0
    return mask


def _cancelled_scale(q, k, v, cot, p):
    """The size of what dQ and dK sum where they are 0 in exact arithmetic: at
    L = 1 each row's softmax is its one key, so dS = P (dP - rowsum(dP P)) = 0
    and the kernels' dQ and dK are the rounding left of that difference (delta
    comes from the bf16 O); the terms that cancel are |dP| / (1 - p) = |dO
    V^T| / (1 - p), times |K| (dQ) or |Q| (dK) and the scale 1 / 8."""
    dp = float(torch.einsum("blhd,bmhd->bhlm", cot.float(), v.float()).abs().max()) / (1.0 - p)
    return [dp * float(k.float().abs().max()) / 8, dp * float(q.float().abs().max()) / 8]


# (B, L, H): L at and around the kernels' tile edges (64-row tiles, 128-row
# blocks), one panel (B H = 1) and more panels than the card's 132 SMs
EDGE_SHAPES = [(3, 1, 2), (3, 63, 2), (3, 64, 2), (3, 127, 2), (3, 128, 2), (3, 129, 2), (3, 192, 2), (3, 512, 2),
               (1, 129, 1), (12, 65, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "given", "philox"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "B{}-L{}-H{}".format(*s))
def test_k3_bf16_kernel_tile_edges(cuda_device, shape, mode):
    """K3a and K3b on bf16 at the tile edges with a ragged key mask (a row
    padded inside a tile, one by whole tiles, one fully padded) against the
    plain version (output 2^-7, gradients 2^-6 of their scale); repeats bit
    for bit; with Philox the fp32 kernel's mask, and a device seed equal to
    the host seed bit for bit."""
    b, l, h = shape
    q, k, v, cot = _card_operands(cuda_device, (b, l, h, 64), seed=l + b)
    mask = _ragged_mask(cuda_device, b, l)
    p = 0.0 if mode == "none" else 0.1
    if mode == "philox":
        _, probs = att.fused_dropout_attention_debug(q.float(), k.float(), v.float(), mask, dropout_p=p, seed=123)
        keep, kw = probs > 0, {"seed": 123}
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(l)
        keep = torch.rand(b, h, l, l, device=cuda_device, generator=gen) >= p if mode == "given" else None
        kw = {"keep": keep}
    before = att.attention_forward.launches, att.attention_backward.launches
    got, grads = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw), q, k, v, cot)
    assert (att.attention_forward.launches, att.attention_backward.launches) == (before[0] + 1, before[1] + 1)
    again, grads2 = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw), q, k, v, cot)
    assert torch.equal(got, again) and all(torch.equal(a, c) for a, c in zip(grads, grads2))
    if mode == "philox":
        key = torch.full((), 100, dtype=torch.int64, device=cuda_device)
        device_seed = sampling.DeviceSeed(key, 23)  # 100 + 23: the host seed
        seeded = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, seed=device_seed), q, k, v, cot)
        assert torch.equal(seeded[0], got) and all(torch.equal(a, c) for a, c in zip(seeded[1], grads))
    ref, ref_grads = _grads(lambda *t: att.dropout_attention_plain(*t, mask, keep, dropout_p=p), q, k, v, cot)
    _hold_card(got, ref, BF16_OUT)
    scales = _cancelled_scale(q, k, v, cot, p) + [None] if l == 1 else [None, None, None]
    for g, r, scale in zip(grads, ref_grads, scales):
        assert bool(torch.isfinite(g.float()).all())
        _hold_card(g, r, BF16_GRAD, scale)


@pytest.mark.cuda
def test_k3_bf16_kernel_device_seed_equals_host_seed(cuda_device):
    q, k, v, cot, mask = _card_attention(cuda_device, (2, 64, 2, 64), seed=3)

    def run(seed):
        out, grads = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=0.3, seed=seed), q, k, v, cot)
        return [out, *grads]

    key = torch.full((), 77, dtype=torch.int64, device=cuda_device)
    device = run(sampling.DeviceSeed(key, 3 << 20))
    host = run(77 + (3 << 20))
    assert all(torch.equal(a, c) for a, c in zip(device, host))
    assert not torch.equal(run(sampling.DeviceSeed(key + 1, 3 << 20))[0], device[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 3), (1, 64, 1)], ids=["L300", "L64"])
@pytest.mark.parametrize("device_seed", [False, True], ids=["host", "device"])
def test_k3_bf16_backward_alone_draws_the_forward_mask(cuda_device, shape, device_seed):
    """K3b called alone draws the keep bits itself (its first launch); in
    training it reads the ones K3a left. Both give the same dQ, dK, dV bit
    for bit, with a host seed and with a device seed."""
    b, l, h = shape
    q, k, v, cot = _card_operands(cuda_device, (b, l, h, 64), seed=l)
    mask = _ragged_mask(cuda_device, b, l)
    seed = sampling.DeviceSeed(torch.full((), 40, dtype=torch.int64, device=cuda_device), 2) if device_seed else 42
    _, trained = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=0.1, seed=seed), q, k, v, cot)
    bias = att.key_bias(mask)
    with torch.no_grad():
        o, lse, _ = att.attention_forward(q, k, v, bias, 0.1, seed, None)
        # the gradient the autograd path hands K3b: d(sum(out * cot)) / d out = cot, in bf16
        alone = att.attention_backward(q, k, v, bias, 0.1, seed, None, o, lse, cot.float().bfloat16().contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(alone, trained))


def _bf16_ulps(got, want, terms=None):
    """|got - want| in units of want's bf16 spacing, less what the fp32
    arithmetic may differ before the one rounding: the kernel contracts
    ``a + std z`` into one fused multiply-add where the plain version rounds
    the product, which moves the fp32 sum by up to 2^-23 of the terms'
    magnitude ``terms`` (|a| + |std z|); where they cancel, that is many
    bf16 spacings of the small result."""
    got, want = got.detach().double(), want.detach().double()
    # 2^(e - 8) for |want| = m 2^e, m in [0.5, 1): log2 on the card reads a
    # power of two as just below it, which halved the spacing there
    spacing = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs().clamp_min(2.0**-126))[1] - 8)
    err = (got - want).abs()
    if terms is not None:
        err = (err - 2.0**-22 * terms.double()).clamp_min(0.0)
    return float((err / spacing).max())


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["full", "row"])
@pytest.mark.parametrize("shape,bias", [((128, 16, 32, 32), True), ((128, 32, 16, 16), False), ((128, 10), True)])
@pytest.mark.parametrize("noise", ["given", "philox"])
def test_k1_bf16_kernel_within_one_ulp_of_plain(cuda_device, shape, bias, frozen, noise):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mean = (0.5 * torch.randn(shape, device=cuda_device, generator=gen)).bfloat16()
    var = (0.25 * torch.rand(shape, device=cuda_device, generator=gen) + 1e-4).bfloat16()
    b_mean = torch.randn(shape[1], device=cuda_device, generator=gen).bfloat16() if bias else None
    b_var = torch.rand(shape[1], device=cuda_device, generator=gen).bfloat16() if bias else None
    g = torch.randn(shape, device=cuda_device, generator=gen).bfloat16()
    if noise == "given":
        z = torch.randn(shape[1:] if frozen else shape, device=cuda_device, generator=gen)
        kw = {"eps": z}
    else:
        # z of seed 5 as the bf16 kernels draw it, read back from their noise mode
        z = sampling.noise_bf16(mean, 5, frozen=frozen)
        kw = {"seed": 5, "frozen": frozen}
    planes = [t.clone().requires_grad_(True) for t in (mean, var)]
    before = sampling.gaussian_sample.launches, sampling.gaussian_sample_backward.launches
    out = sampling.gaussian_sample(*planes, b_mean, b_var, **kw)
    out.backward(g)
    assert (sampling.gaussian_sample.launches, sampling.gaussian_sample_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16 and planes[1].grad.dtype == torch.bfloat16
    ref = sampling.gaussian_sample_plain(mean, var, b_mean, b_var, z)
    ref_dvar = sampling.gaussian_sample_backward(g.cpu(), var.cpu(), None if b_var is None else b_var.cpu(),
                                                 eps=z.cpu())
    a = sampling._add_bias(mean.float(), None if b_mean is None else b_mean.float())
    std = torch.sqrt(sampling._add_bias(var.float(), None if b_var is None else b_var.float()))
    assert _bf16_ulps(out, ref, a.abs() + (std * z).abs()) <= 1.0
    assert _bf16_ulps(planes[1].grad.cpu(), ref_dvar) <= 1.0
    assert torch.equal(planes[0].grad, g)
