"""PyTorch port, ops/sampling.py (K1): the plain version and its gradient
held against the JAX layers' epilogue math on the same noise, the CPU
generator mode, input checks, and (on a card only) the Triton kernel against
the plain version.

The JAX Pallas kernel cannot run on the CPU (tests/test_sampling_kernel.py),
so the hold is against the expression the JAX layers compute
(nn/bbb.py:89-95, :163-170). Tolerances: the same fp32 operations in the same
order, 1e-6 absolute on outputs; gradients 1e-5 relative (the bias
gradients are sums over N, H, W taken in another order). z recovered from the
output carries a few ulp(out)/std of error; that comparison holds each
gradient element to the bound ``recovery_bound`` derives from it.

The kernel cases (marker ``cuda``) run on a card with
``python -m pytest --noconftest -m cuda tests/test_torch_sampling.py``; JAX
is imported only inside the tests that compare with it, so the file also
loads where JAX is not installed."""
import numpy as np
import pytest
import torch

from beyond_deep_ensembles_tpu_torch.ops import sampling


@pytest.fixture
def cuda_device():
    """The card, for kernel cases; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Triton kernel has no CPU mode")
    return torch.device("cuda")


def _jax_epilogue(act_mean, act_var, b_mean, b_var, eps):
    """The JAX layers' epilogue in NHWC / [B, O] (bias on the last axis)."""
    import jax.numpy as jnp

    if b_mean is not None:
        act_mean = act_mean + b_mean
        act_var = act_var + b_var
    return act_mean + jnp.sqrt(act_var) * eps


# std = softplus(-6): the weight scale of a layer whose rho training has
# driven down, where the recovered z's relative error is largest
SMALL_VAR = float(np.log1p(np.exp(-6.0)) ** 2)


def _inputs(shape, bias, seed=0, small_var=False):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    mean = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    var = (0.25 * rng.rand(*shape) + 1e-4).astype(np.float32)
    b_mean = rng.standard_normal(c).astype(np.float32) if bias else None
    b_var = (rng.rand(c) + 1e-3).astype(np.float32) if bias else None
    if small_var:
        var = (SMALL_VAR * (0.5 + rng.rand(*shape))).astype(np.float32)
        b_var = np.full(c, SMALL_VAR, np.float32) if bias else None
    return mean, var, b_mean, b_var


def recovery_bound(out, mean, std, z, g):
    """Per element, how far d act_var from the z that the seeded backward
    recovers as (out - mean) / std may lie from d act_var = g*z/(2*std) at
    the true z: the output, the subtraction and the division each round
    once (2**-23 relative), and the gradient's product and quotient round
    on each side."""
    u = 2.0**-23
    dz = u * (out.abs() + mean.abs() + (std * z).abs()) / std + u * z.abs()
    return (g * dz / (2 * std)).abs() + 2 * u * (g * z / (2 * std)).abs()


def _to_port(a):
    """JAX layout (channels last) -> port layout (channels at dim 1)."""
    if a is None:
        return None
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    elif a.ndim == 3:
        a = a.transpose(2, 0, 1)
    return torch.from_numpy(np.array(a, order="C"))


CASES = [((2, 6, 6, 5), True), ((3, 4, 4, 7), False), ((4, 10), True)]


@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize("shape,bias", CASES)
def test_plain_matches_jax_epilogue_and_grad(shape, bias, frozen):
    import jax
    import jax.numpy as jnp
    from _torch_parity import assert_close

    mean, var, b_mean, b_var = _inputs(shape, bias)
    rng = np.random.RandomState(1)
    eps = rng.standard_normal(shape[1:] if frozen else shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def f(m, v, bm, bv):
        e = jnp.broadcast_to(eps, shape) if frozen else eps
        out = _jax_epilogue(m, v, bm, bv, e)
        return jnp.sum(out * g), out

    args = [jnp.asarray(a) if a is not None else None for a in (mean, var, b_mean, b_var)]
    argnums = (0, 1, 2, 3) if bias else (0, 1)
    (_, ref), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(*args)

    t = [_to_port(a) for a in (mean, var, b_mean, b_var)]
    for x in t:
        if x is not None:
            x.requires_grad_(True)
    out = sampling.gaussian_sample(*t, eps=_to_port(eps))
    assert_close(out.detach().numpy(), _to_port(np.asarray(ref)).numpy(), atol=1e-6, rtol=0)
    (out * _to_port(g)).sum().backward()
    for got, want in zip([x for x in t if x is not None], grads):
        assert_close(got.grad.numpy(), _to_port(np.asarray(want)).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("small_var", [False, True], ids=["var", "small-var"])
@pytest.mark.parametrize("shape,bias", CASES)
def test_generator_mode_recovers_z_in_backward(shape, bias, small_var):
    """Seeded mode saves no z: the backward recovers it from the output. Its
    gradients are held against those of the true draw fed as given noise:
    d act_mean and d b_mean exactly, d act_var within ``recovery_bound`` and
    d b_var within the bound's channel sums plus the sum's own rounding."""
    mean, var, b_mean, b_var = (_to_port(a) for a in _inputs(shape, bias, small_var=small_var))
    leaves = [x for x in (mean, var, b_mean, b_var) if x is not None]
    for x in leaves:
        x.requires_grad_(True)
    out = sampling.gaussian_sample(mean, var, b_mean, b_var, seed=1234)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    grads = torch.autograd.grad((out * g).sum(), leaves)

    z = sampling._cpu_noise(mean.detach(), 1234, False)
    out2 = sampling.gaussian_sample(mean, var, b_mean, b_var, eps=z)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    grads2 = torch.autograd.grad((out2 * g).sum(), leaves)
    with torch.no_grad():
        full_mean = sampling._add_bias(mean, b_mean)
        std = torch.sqrt(sampling._add_bias(var, b_var))
        bound = recovery_bound(out, full_mean, std, z, g)
    torch.testing.assert_close(grads[0], grads2[0], rtol=0, atol=0)
    assert bool(((grads[1] - grads2[1]).abs() <= bound).all())
    if bias:
        torch.testing.assert_close(grads[2], grads2[2], rtol=0, atol=0)
        terms = out.numel() // out.shape[1]
        sum_rounding = np.ceil(np.log2(terms)) * 2.0**-23 * sampling._channel_sum(grads2[1].abs())
        assert bool(((grads[3] - grads2[3]).abs() <= sampling._channel_sum(bound) + sum_rounding).all())


def test_generator_mode_draws():
    launches = sampling.gaussian_sample.launches
    mean = torch.zeros(64, 4, 8, 8)
    var = torch.ones_like(mean)
    a = sampling.gaussian_sample(mean, var, seed=7)
    torch.testing.assert_close(a, sampling.gaussian_sample(mean, var, seed=7), rtol=0, atol=0)
    assert not torch.equal(a, sampling.gaussian_sample(mean, var, seed=8))
    z = sampling.gaussian_sample(torch.zeros(1 << 20, 1), torch.ones(1 << 20, 1), seed=3)
    assert abs(float(z.mean())) < 5e-3 and abs(float(z.std()) - 1.0) < 5e-3
    frozen = sampling.gaussian_sample(mean, var, seed=9, frozen=True)
    assert torch.equal(frozen, frozen[:1].expand_as(frozen))
    assert sampling.gaussian_sample.launches == launches  # the CPU path launches nothing


def test_rejects_bad_inputs():
    m = torch.zeros(2, 3, 4, 4)
    v = torch.ones_like(m)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m, v)  # neither eps nor seed
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m, v, eps=torch.zeros_like(m), seed=1)
    with pytest.raises(TypeError):
        sampling.gaussian_sample(m.double(), v.double(), seed=1)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m, v[:, :2], seed=1)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m.transpose(2, 3), v, seed=1)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m, v, torch.zeros(3), None, seed=1)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m, v, torch.zeros(4), torch.zeros(4), seed=1)
    with pytest.raises(ValueError):
        sampling.gaussian_sample(m, v, eps=torch.zeros(3, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["full", "row"])
@pytest.mark.parametrize("shape,bias", [((128, 16, 32, 32), True), ((128, 32, 16, 16), False), ((128, 10), True)])
def test_kernel_given_noise_matches_plain(cuda_device, shape, bias, frozen):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mean = 0.5 * torch.randn(shape, device=cuda_device, generator=gen)
    var = 0.25 * torch.rand(shape, device=cuda_device, generator=gen) + 1e-4
    b_mean = torch.randn(shape[1], device=cuda_device, generator=gen) if bias else None
    b_var = torch.rand(shape[1], device=cuda_device, generator=gen) if bias else None
    eps = torch.randn(shape[1:] if frozen else shape, device=cuda_device, generator=gen)
    before = sampling.gaussian_sample.launches
    out = sampling.gaussian_sample(mean, var, b_mean, b_var, eps=eps)
    assert sampling.gaussian_sample.launches == before + 1
    ref = sampling.gaussian_sample_plain(mean, var, b_mean, b_var, eps)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_kernel_philox_moments_and_frozen_rows(cuda_device):
    mean = torch.zeros(1024, 16, 32, 32, device=cuda_device)
    z = sampling.gaussian_sample(mean, torch.ones_like(mean), seed=11)
    assert abs(float(z.mean())) < 2e-3 and abs(float(z.std()) - 1.0) < 2e-3
    assert not torch.equal(z, sampling.gaussian_sample(mean, torch.ones_like(mean), seed=12))
    rows = sampling.gaussian_sample(mean[:128], torch.ones_like(mean[:128]), seed=13, frozen=True)
    assert torch.equal(rows, rows[:1].expand_as(rows))
