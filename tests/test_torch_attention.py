"""PyTorch port, ops/attention.py (K3a and K3b, the fused dropout attention):
the plain version against the JAX Pallas kernel run by the TPU interpreter,
against the JAX explicit-mask math with a given mask, the CPU seed path, the
wrapper's input checks, and (on a card only) the CUDA kernels against the
plain version.

The interpreter models the TPU's random bits as all zero, i.e. u = 0.5: at
p = 0.4 it keeps every probability (scaled by 1 / 0.6), at p = 0.6 it drops
every one. The port's plain version is fed the matching all-ones or
all-zeros keep mask; at p = 0 it takes no mask.

Tolerances: against the interpreted kernel the JAX test's own (outputs 2e-5;
gradients atol 3e-5, rtol 3e-4); against the JAX explicit-mask math, the same
fp32 operations in another library, 1e-5. On the card, K3a and K3b against
the plain version at (2, 128, 3, 64) and at the ragged lengths 300, 65, 5
and 96, and with a seed read from device memory (a ``DeviceSeed``) equal to
the host seed of the same value, bit for bit: outputs 1e-5 and gradients atol 3e-5, rtol 3e-4: the kernels sum over
64-wide tiles in another order, rescale with an online softmax, take
rowsum(dP * P) as rowsum(dO * O), each rounding about 1e-7 relative per
step, and take every product as split TF32 on the tensor cores (three
products of the operands' high and low parts, about 2^-22 relative each;
the emulation below settles that this holds the tolerances and that a
single TF32 product does not).

The kernel cases (marker ``cuda``) run on a card with
``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``; JAX
is imported only inside the tests that compare with it."""
import numpy as np
import pytest
import torch

from beyond_deep_ensembles_tpu_torch.ops import attention as att
from beyond_deep_ensembles_tpu_torch.ops import sampling

SHAPE = (2, 8, 2, 4)  # the JAX test's interpreted shape: B, L, H, D


@pytest.fixture
def cuda_device():
    """The card, for kernel cases; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape=SHAPE, seed=0, pad_from=None):
    """q, k, v, a cotangent, and a key mask whose row 0 pads the keys from
    ``pad_from`` (3L/4 by default, as the JAX test pads)."""
    b, l, h, d = shape
    rng = np.random.RandomState(seed)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    mask = np.ones((b, l), np.int32)
    mask[0, (3 * l // 4 if pad_from is None else pad_from):] = 0
    return q, k, v, cot, mask


def _port(q, k, v, cot, mask, **kw):
    """The port's output and its q, k, v gradients under the cotangent."""
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = att.fused_dropout_attention(*leaves, torch.from_numpy(mask), **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize(
    "dropout_p,regime", [(0.0, "none"), (0.4, "keep_all"), (0.6, "drop_all")]
)
def test_plain_matches_interpreted_pallas_kernel(dropout_p, regime):
    import jax
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from jax.experimental.pallas import tpu as pltpu

    from beyond_deep_ensembles_tpu.ops.attention import fused_dropout_attention

    q, k, v, cot, mask = _inputs()

    def jax_fn(q, k, v):
        return fused_dropout_attention(
            q, k, v, jnp.asarray(mask), jnp.array([7], jnp.int32), dropout_p=dropout_p,
            interpret=pltpu.InterpretParams(),
        )

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))
    keep = None
    if regime != "none":
        b, l, h, _ = SHAPE
        keep = torch.full((b, h, l, l), regime == "keep_all")
    got, grads = _port(q, k, v, cot, mask, dropout_p=dropout_p, keep=keep)
    assert_close(got, np.asarray(want), rtol=2e-5, atol=2e-5, err_msg=f"output, {regime}")
    if regime == "drop_all":
        assert not got.any()
    for name, g, w in zip("qkv", grads, want_grads):
        assert_close(g, np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=f"d{name}, {regime}")


@pytest.mark.parametrize("dropout_p,regime", [(0.0, "none"), (0.4, "keep_all")])
def test_fully_padded_key_row_matches_interpreted_pallas_kernel(dropout_p, regime):
    """Batch row 0 with every key padded: the JAX kernel's -1e30 bias on every
    key makes that row's softmax uniform, 1 / L. The plain version gives the
    interpreted Pallas kernel's output and dQ, dK, dV there (the tolerances of
    the test above) and probabilities of exactly 1 / L."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from jax.experimental.pallas import tpu as pltpu

    from beyond_deep_ensembles_tpu.ops.attention import fused_dropout_attention

    q, k, v, cot, mask = _inputs(pad_from=0)
    assert not mask[0].any() and mask[1:].all()

    def jax_fn(q, k, v):
        return fused_dropout_attention(
            q, k, v, jnp.asarray(mask), jnp.array([7], jnp.int32), dropout_p=dropout_p,
            interpret=pltpu.InterpretParams(),
        )

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))
    b, l, h, _ = SHAPE
    keep = None if regime == "none" else torch.ones((b, h, l, l), dtype=torch.bool)
    got, grads = _port(q, k, v, cot, mask, dropout_p=dropout_p, keep=keep)
    assert_close(got, np.asarray(want), rtol=2e-5, atol=2e-5, err_msg=f"output, {regime}")
    for name, g, w in zip("qkv", grads, want_grads):
        assert_close(g, np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=f"d{name}, {regime}")
    probs = att._plain_probs(*(torch.from_numpy(a) for a in (q, k)), torch.from_numpy(mask), None, 0.0)
    assert torch.equal(probs[0], torch.full_like(probs[0], 1.0 / l))


def _against_jax_explicit_mask_math(shape, seed, p_drop=0.3):
    """The port's plain version against the explicit realized-mask math of
    tests/test_fused_attention.py, with a random keep mask, for the output
    and dQ, dK, dV."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import assert_close

    q, k, v, cot, mask = _inputs(shape, seed=seed)
    b, l, h, _ = shape
    keep = np.random.RandomState(seed + 1).rand(b, h, l, l) >= p_drop

    def explicit(q, k, v):
        s = jnp.einsum("blhd,bmhd->bhlm", q, k, preferred_element_type=jnp.float32) / jnp.sqrt(
            jnp.float32(q.shape[-1])
        )
        s = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, s, -1e30)
        pr = jax.nn.softmax(s, axis=-1) * jnp.asarray(keep, jnp.float32) / (1.0 - p_drop)
        return jnp.einsum("bhlm,bmhd->blhd", pr, v)

    want, vjp = jax.vjp(explicit, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))
    got, grads = _port(q, k, v, cot, mask, dropout_p=p_drop, keep=torch.from_numpy(keep))
    assert_close(got, np.asarray(want), rtol=1e-5, atol=1e-5, err_msg="output")
    for name, g, w in zip("qkv", grads, want_grads):
        assert_close(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def test_given_mask_matches_jax_explicit_mask_math():
    _against_jax_explicit_mask_math((2, 16, 3, 8), seed=1)


@pytest.mark.parametrize("length", [44, 300])
def test_ragged_lengths_match_jax_explicit_mask_math(length):
    """Lengths that are no multiple of the kernels' 64-wide tile (300 is
    CivilComments'), at the kernels' head dimension."""
    _against_jax_explicit_mask_math((2, length, 2, 64), seed=length)


# --------------------------------------------------------------------------
# Split TF32: the kernels' arithmetic emulated in plain torch
# --------------------------------------------------------------------------


def _tf32(x):
    """fp32 rounded to TF32's 10-bit mantissa, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``), by integer arithmetic on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tensor_core_product(a, b, passes):
    """``a @ b`` as the tensor cores take it: TF32 operands, fp32
    accumulation. ``passes`` 3: split TF32, each operand hi = tf32(x) and
    lo = tf32(x - hi), the small terms first; 1: the high parts alone."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _emulated_kernels(q, k, v, cot, mask, keep, p_drop, passes):
    """The forward and backward math of K3a and K3b (scores in base 2, delta
    = rowsum(dO * O), the three gradients) with every product through
    ``_tensor_core_product``; q, k, v, cot ``[B, L, H, D]``."""
    qh, kh, vh, do = (t.permute(0, 2, 1, 3) for t in (q, k, v, cot))  # [B, H, L, D]
    scale = 1.0 / np.sqrt(q.shape[-1])
    log2e = 1.4426950408889634
    bias = att.key_bias(mask)[:, None, None, :]
    s2 = _tensor_core_product(qh * np.float32(scale * log2e), kh.transpose(-1, -2), passes) + bias
    m = s2.max(-1, keepdim=True).values
    ex = torch.exp2(s2 - m)
    lse = m + torch.log2(ex.sum(-1, keepdim=True))
    prob = torch.exp2(s2 - lse)
    kept = keep.to(torch.float32) / (1.0 - p_drop) if keep is not None else torch.ones_like(prob)
    out = _tensor_core_product(ex * (kept > 0), vh, passes) / (ex.sum(-1, keepdim=True) * (1.0 - p_drop))
    delta = (do * out).sum(-1, keepdim=True)
    dp = _tensor_core_product(do, vh.transpose(-1, -2), passes) * kept
    ds = prob * (dp - delta)
    dq = _tensor_core_product(ds, kh, passes) * np.float32(scale)
    dk = _tensor_core_product(ds.transpose(-1, -2), qh, passes) * np.float32(scale)
    dv = _tensor_core_product((prob * kept).transpose(-1, -2), do, passes)
    return tuple(t.permute(0, 2, 1, 3) for t in (out, dq, dk, dv))


@pytest.mark.parametrize("shape", [(2, 48, 3, 16), (1, 512, 2, 64)])
def test_split_tf32_holds_the_fp32_tolerances_and_single_tf32_misses(shape):
    """The tolerances the card's kernels are held to against the plain
    version (output 1e-5; gradients 3e-5 + 3e-4 |ref|): the split-TF32
    emulation stays inside them, the single-pass TF32 emulation does not."""
    q, k, v, cot, mask = (torch.from_numpy(a) for a in _inputs(shape, seed=4))
    b, l, h, _ = shape
    p_drop = 0.1
    keep = torch.from_numpy(np.random.RandomState(5).rand(b, h, l, l) >= p_drop)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = att.dropout_attention_plain(*leaves, mask, keep, dropout_p=p_drop)
    ref_grads = torch.autograd.grad(ref, leaves, cot)
    ref = ref.detach()

    def worst(passes):
        out, *grads = _emulated_kernels(q, k, v, cot, mask, keep, p_drop, passes)
        out_err = float((out - ref).abs().max())
        grad_excess = max(float(((g - r).abs() - 3e-4 * r.abs()).max()) for g, r in zip(grads, ref_grads))
        return out_err, grad_excess

    out_err, grad_excess = worst(3)
    print(f"gap split TF32 {shape}: output {out_err:.3g}, gradients beyond 3e-4 |ref| {grad_excess:.3g}")
    assert out_err <= 1e-5 and grad_excess <= 3e-5
    out_err, grad_excess = worst(1)
    print(f"gap single TF32 {shape}: output {out_err:.3g}, gradients beyond 3e-4 |ref| {grad_excess:.3g}")
    assert out_err > 1e-5 and grad_excess > 3e-5


@pytest.mark.parametrize("dropout_p", [0.0, 0.25])
def test_padded_keys_get_zero_probability(dropout_p):
    q, k, v, _, mask = _inputs((2, 16, 2, 4))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    seed = 3 if dropout_p else None
    out, probs = att.fused_dropout_attention_debug(tq, tk, tv, torch.from_numpy(mask), dropout_p=dropout_p, seed=seed)
    assert probs.shape == (2, 2, 16, 16)
    assert not probs[0, :, :, 12:].any()
    if dropout_p == 0.0:
        torch.testing.assert_close(probs.sum(-1), torch.ones(2, 2, 16), rtol=0, atol=1e-6)
    # the output is the realized probabilities applied to V
    torch.testing.assert_close(out, torch.einsum("bhlm,bmhd->blhd", probs, tv), rtol=0, atol=1e-6)
    again = att.fused_dropout_attention(tq, tk, tv, torch.from_numpy(mask), dropout_p=dropout_p, seed=seed)
    assert torch.equal(again, out)


def test_cpu_seed_stream():
    """The CPU path's mask: the same seed draws the same mask, another seed
    another, at the keep rate 1 - p (6 sigma)."""
    q, k, v, _, mask = _inputs((2, 64, 4, 4))
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    p = 0.1
    _, p1 = att.fused_dropout_attention_debug(*args, dropout_p=p, seed=11)
    _, p2 = att.fused_dropout_attention_debug(*args, dropout_p=p, seed=11)
    _, p3 = att.fused_dropout_attention_debug(*args, dropout_p=p, seed=12)
    assert torch.equal(p1, p2) and not torch.equal(p1 > 0, p3 > 0)
    kept = (p1[:, :, :, :48] > 0).float()  # keys unpadded on every row
    sigma = (p * (1 - p) / kept.numel()) ** 0.5
    assert abs(float(kept.mean()) - (1 - p)) < 6 * sigma
    _, undropped = att.fused_dropout_attention_debug(*args)
    assert torch.equal(p1 > 0, att.cpu_keep_mask(p1.shape, 11, p) & (undropped > 0))


def test_input_checks():
    q, k, v, _, mask = _inputs()
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    b, l, h, _ = SHAPE
    with pytest.raises(ValueError):
        att.fused_dropout_attention(tq, tk[:, :4], tv, tm)
    with pytest.raises(TypeError):
        att.fused_dropout_attention(tq.double(), tk.double(), tv.double(), tm)
    with pytest.raises(ValueError):
        att.fused_dropout_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), tm)
    with pytest.raises(ValueError):
        att.fused_dropout_attention(tq, tk, tv, tm[:, :4])
    with pytest.raises(ValueError):
        att.fused_dropout_attention(tq, tk, tv, tm, dropout_p=1.0, seed=1)
    with pytest.raises(ValueError):  # neither a seed nor a mask
        att.fused_dropout_attention(tq, tk, tv, tm, dropout_p=0.1)
    with pytest.raises(ValueError):  # both
        att.fused_dropout_attention(tq, tk, tv, tm, dropout_p=0.1, seed=1, keep=torch.ones(b, h, l, l, dtype=torch.bool))
    with pytest.raises(ValueError):  # a mask with nothing to drop
        att.fused_dropout_attention(tq, tk, tv, tm, keep=torch.ones(b, h, l, l, dtype=torch.bool))
    with pytest.raises(ValueError):
        att.fused_dropout_attention(tq, tk, tv, tm, dropout_p=0.1, keep=torch.ones(b, h, l, l - 1, dtype=torch.bool))
    with pytest.raises(ValueError):  # the kernel wrappers take CUDA tensors only
        att.attention_forward(tq, tk, tv, att.key_bias(tm), 0.0, None, None)
    launches = att.attention_forward.launches, att.attention_backward.launches
    _port(q, k, v, np.ones_like(q), mask, dropout_p=0.2, seed=5)
    assert (att.attention_forward.launches, att.attention_backward.launches) == launches  # the CPU launches nothing


# --------------------------------------------------------------------------
# On the card: K3a and K3b against the plain version
# --------------------------------------------------------------------------

CARD_SHAPE = (2, 128, 3, 64)


def _card_inputs(device, shape=CARD_SHAPE, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, cot = (torch.randn(shape, device=device, generator=gen) for _ in range(4))
    mask = torch.ones(shape[:2], dtype=torch.int32, device=device)
    mask[0, 77:] = 0  # ragged, inside the second key tile
    mask[1, 64:] = 0  # a whole key tile padded
    return q, k, v, cot, mask


def _grads(fn, q, k, v, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad((out * cot).sum(), leaves)
    return out.detach(), grads


def _hold(got, want, atol, rtol):
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def _check_kernel_against_plain(device, shape, mode, seed=0):
    """K3a's output and K3b's dQ, dK, dV against the plain version, with one
    launch of each counted."""
    q, k, v, cot, mask = _card_inputs(device, shape, seed)
    b, l, h, _ = q.shape
    p = 0.1 if mode == "given" else 0.0
    keep = None
    if mode == "given":
        keep = torch.rand(b, h, l, l, device=device, generator=torch.Generator(device=device).manual_seed(9)) >= p
    before = att.attention_forward.launches, att.attention_backward.launches
    out, grads = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, keep=keep), q, k, v, cot)
    assert (att.attention_forward.launches, att.attention_backward.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_grads = _grads(lambda *t: att.dropout_attention_plain(*t, mask, keep, dropout_p=p), q, k, v, cot)
    _hold(out, ref, 1e-5, 1e-5)
    for g, r in zip(grads, ref_grads):
        _hold(g, r, 3e-5, 3e-4)


def _check_kernel_philox(device, shape, seed=1):
    """Keep rate within 6 sigma of 1 - p over the keys unpadded on every row;
    repeats equal bit for bit (output, probabilities, gradients); another
    seed another mask; nothing at a padded key; the output and gradients
    equal the plain version fed the realized mask."""
    q, k, v, cot, mask = _card_inputs(device, shape, seed)
    p = 0.1
    out, probs = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=p, seed=123)
    again, probs2 = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=p, seed=123)
    _, other = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=p, seed=124)
    assert torch.equal(out, again) and torch.equal(probs, probs2)
    assert not torch.equal(probs > 0, other > 0)
    assert not bool(probs[0, :, :, 77:].any()) and not bool(probs[1, :, :, 64:].any())
    kept = (probs[:, :, :, :64] > 0).float()  # keys 0..63 are unpadded on both rows
    sigma = (p * (1 - p) / kept.numel()) ** 0.5
    assert abs(float(kept.mean()) - (1 - p)) < 6 * sigma
    realized = probs > 0  # a kept probability that underflows to 0 counts nothing either way
    main, grads = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, seed=123), q, k, v, cot)
    _, grads2 = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, seed=123), q, k, v, cot)
    assert torch.equal(main, out)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    ref, ref_grads = _grads(lambda *t: att.dropout_attention_plain(*t, mask, realized, dropout_p=p), q, k, v, cot)
    _hold(out, ref, 1e-5, 1e-5)
    _hold(probs, att._plain_probs(q, k, mask, realized, p), 1e-6, 1e-5)
    for g, r in zip(grads, ref_grads):
        _hold(g, r, 3e-5, 3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "given"])
def test_kernel_matches_plain(cuda_device, mode):
    _check_kernel_against_plain(cuda_device, CARD_SHAPE, mode)


@pytest.mark.cuda
def test_kernel_philox_mask(cuda_device):
    _check_kernel_philox(cuda_device, CARD_SHAPE)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [300, 65, 5])
@pytest.mark.parametrize("mode", ["none", "given", "philox"])
def test_kernel_ragged_length(cuda_device, length, mode):
    """L not a multiple of the 64-wide tile (300 is CivilComments' length; 65
    leaves one row and one key in the last tile, and a mask whose rows are
    not 4-byte aligned; 5 is less than one tile)."""
    shape = (2, length, 3, 64)
    if mode == "philox":
        _check_kernel_philox(cuda_device, shape)
    else:
        _check_kernel_against_plain(cuda_device, shape, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [512, 300])
@pytest.mark.parametrize("mode", ["none", "given", "philox"])
def test_kernel_fully_padded_key_row(cuda_device, length, mode):
    """Batch row 0 with every key padded (row 1 ragged): K3a's output and
    K3b's dQ, dK, dV against the plain version, whose probabilities on that
    row are 1 / L (kept ones scaled by 1 / (1 - p)); with Philox, against the
    plain version fed the realized mask, and the debug probabilities too."""
    q, k, v, cot, mask = _card_inputs(cuda_device, (2, length, 3, 64))
    mask[0] = 0
    b, l, h, _ = q.shape
    p = 0.0 if mode == "none" else 0.1
    if mode == "philox":
        out, probs = att.fused_dropout_attention_debug(q, k, v, mask, dropout_p=p, seed=321)
        keep = probs > 0
        assert float(keep[0].float().mean()) > 0.8
        _hold(probs, att._plain_probs(q, k, mask, keep, p), 1e-6, 1e-5)
        kw = {"seed": 321}
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        keep = torch.rand(b, h, l, l, device=cuda_device, generator=gen) >= p if mode == "given" else None
        kw = {"keep": keep}
    got, grads = _grads(lambda *t: att.fused_dropout_attention(*t, mask, dropout_p=p, **kw), q, k, v, cot)
    ref, ref_grads = _grads(lambda *t: att.dropout_attention_plain(*t, mask, keep, dropout_p=p), q, k, v, cot)
    _hold(got, ref, 1e-5, 1e-5)
    for g, r in zip(grads, ref_grads):
        _hold(g, r, 3e-5, 3e-4)
    assert float(grads[0][0].abs().max()) > 0  # dQ of the padded row is not trivially 0


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda_device):
    _check_kernel_against_plain(cuda_device, (2, 96, 2, 64), "none")  # L = 96 runs: one and a half tiles
    q, k, v, _, mask = _card_inputs(cuda_device, shape=(2, 64, 2, 32))
    with pytest.raises(ValueError):  # head dimension 32
        att.fused_dropout_attention(q, k, v, mask)
    q, k, v, _, mask = _card_inputs(cuda_device, shape=(2, 64, 2, 64))
    with pytest.raises(ValueError):  # the kernel wrappers never take a CPU tensor
        att.attention_forward(q.cpu(), k.cpu(), v.cpu(), att.key_bias(mask).cpu(), 0.0, None, None)


@pytest.mark.cuda
def test_kernel_device_seed_equals_host_seed(cuda_device):
    """K3 with a DeviceSeed (the key read from device memory) = K3 with the
    equal host seed, bit for bit, output and dQ, dK, dV; another key, another
    mask."""
    q, k, v, cot, mask = (torch.from_numpy(a).to(cuda_device) for a in _inputs((2, 64, 2, 64), seed=3))

    def run(seed):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = att.fused_dropout_attention(*leaves, mask, dropout_p=0.3, seed=seed)
        (out * cot).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    key = torch.full((), 77, dtype=torch.int64, device=cuda_device)
    device = run(sampling.DeviceSeed(key, 3 << 20))
    host = run(77 + (3 << 20))
    assert all(torch.equal(a, b) for a, b in zip(device, host))
    assert not torch.equal(run(sampling.DeviceSeed(key + 1, 3 << 20))[0], device[0])
