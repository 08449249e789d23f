"""PyTorch port, ops/svgd_kernel.py (K2 and the Stein direction around it):
the plain Gram against the JAX Pallas ``_gram_pallas`` in interpret mode,
``pairwise_sq_dists``, ``_median_linear`` and ``rbf_phi`` against the JAX
functions (``use_pallas=False``), the wrapper's input checks, and (on a card
only) the CUDA kernel against its plain version.

Tolerances, each against the size of what cancels or sums:
  * G: 1e-5 of sum_p |x_ip| |x_jp|. Both sides sum at most 4097 fp32
    products in blocked orders (JAX: 512-column tiles, then the grid); their
    rounding grows like sqrt(depth) u in practice, about 4e-6 at 4097.
  * d^2: 1e-5 of the largest diagonal entry of G. d^2 = diag_i + diag_j -
    2 G cancels when particles lie close together, so the Gram's error, not
    d^2's size, sets the gap.
  * median: the same sort and interpolation in fp32, 1e-7 relative.
  * phi: 1e-5 of max |phi|, on spread particles: d^2 carries ~1e-6 relative
    error into h and K.
  * K2 on the card: every element within ``gram_error_bound`` (gamma_d of
    sum |x_i||x_j|, d the kernel's summation depth) of an fp64 product, and
    within that plus the plain fp32 product's own measured error of
    ``gram_plain``.

The kernel cases (marker ``cuda``) run on a card with
``python -m pytest --noconftest -m cuda tests/test_torch_svgd_kernel.py``;
JAX is imported only inside the tests that compare with it, so the file also
loads where JAX is not installed."""
import numpy as np
import pytest
import torch

from beyond_deep_ensembles_tpu_torch.ops import svgd_kernel as sk


@pytest.fixture
def cuda_device():
    """The card, for kernel cases; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _particles(n, p, seed=0, spread=1.0):
    """n rows of P: a shared centre plus ``spread`` times row noise."""
    rng = np.random.RandomState(seed)
    centre = rng.standard_normal(p)
    return (centre + spread * rng.standard_normal((n, p))).astype(np.float32)


def _abs_gram(x):
    a = np.abs(np.asarray(x, np.float64))
    return a @ a.T


@pytest.mark.parametrize("p", [700, 4097])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_gram_plain_matches_pallas_interpret(n, p):
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from beyond_deep_ensembles_tpu.ops.svgd_kernel import _gram_pallas

    x = _particles(n, p, seed=n + p)
    ref = np.asarray(_gram_pallas(jnp.asarray(x), interpret=True))
    launches = sk.gram.launches
    got = sk.gram(torch.from_numpy(x)).numpy()
    assert sk.gram.launches == launches  # the CPU path launches nothing
    scale = _abs_gram(x)
    assert_close(got / scale, ref / scale, rtol=0, atol=1e-5, err_msg="G / sum|x_i||x_j|")
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("spread", [1.0, 1e-2], ids=["spread", "clustered"])
@pytest.mark.parametrize("p", [700, 4097])
def test_pairwise_sq_dists_matches_jax(p, spread):
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from beyond_deep_ensembles_tpu.ops.svgd_kernel import pairwise_sq_dists as jax_d2

    x = _particles(5, p, seed=p, spread=spread)
    ref = np.asarray(jax_d2(jnp.asarray(x), use_pallas=False))
    got = sk.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    top = float(np.max(np.sum(x.astype(np.float64) ** 2, axis=1)))
    assert_close(got / top, ref / top, rtol=0, atol=1e-5, err_msg="d^2 / max diag")
    assert (got >= 0).all() and (np.diag(got) == 0).all()


@pytest.mark.parametrize("m", [1, 4, 25, 64])
def test_median_linear_matches_jax(m):
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from beyond_deep_ensembles_tpu.ops.svgd_kernel import _median_linear as jax_median

    values = np.random.RandomState(m).standard_normal(m).astype(np.float32).reshape(-1, 1)
    ref = float(jax_median(jnp.asarray(values)))
    got = float(sk._median_linear(torch.from_numpy(values)))
    assert_close(got, ref, rtol=1e-7)
    assert got == pytest.approx(float(np.quantile(values.astype(np.float64), 0.5)), rel=1e-6)


@pytest.mark.parametrize("h_override", [None, 30.0], ids=["median", "h_override"])
@pytest.mark.parametrize("p", [700, 4097])
def test_rbf_phi_matches_jax(p, h_override):
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from beyond_deep_ensembles_tpu.ops.svgd_kernel import rbf_phi as jax_rbf_phi

    particles = _particles(5, p, seed=p + 1)
    grads = np.random.RandomState(p + 2).standard_normal((5, p)).astype(np.float32)
    kw = dict(kernel_grad_scale=1.3, dataset_size=200, h_override=h_override)
    ref = np.asarray(jax_rbf_phi(jnp.asarray(particles), jnp.asarray(grads), use_pallas=False, **kw))
    got = sk.rbf_phi(torch.from_numpy(particles), torch.from_numpy(grads), **kw).numpy()
    top = float(np.abs(ref).max())
    assert_close(got / top, ref / top, rtol=0, atol=1e-5, err_msg="phi / max|phi|")


def test_gram_rejects_bad_inputs():
    x = torch.zeros(4, 10)
    with pytest.raises(TypeError):
        sk.gram(x.double())
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(10))  # rank 1
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(10, 4).T)  # not contiguous
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(sk.MAX_N + 1, 10))  # more rows than K2 takes
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(4, 0))
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(4, 10, device="meta"))
    assert sk.gram(torch.ones(sk.MAX_N, 3)).shape == (sk.MAX_N, sk.MAX_N)


def test_summation_depth_follows_the_launch_shape():
    # 2 columns per thread over 535 chunks, then 5 chunks per pass-2 thread
    assert sk.summation_depth(273_610) == (2 + 5 + 7) + (5 + 5 + 3)
    # capped at 2048 chunks: 12,208 columns a chunk, 48 per thread
    assert sk.summation_depth(25_000_000) == (48 + 5 + 7) + (16 + 5 + 3)
    x = torch.from_numpy(_particles(3, 4097))
    bound = sk.gram_error_bound(x)
    assert bound.dtype == torch.float64 and bound.shape == (3, 3) and bool((bound > 0).all())


def _hold_kernel(x):
    """K2 on ``x`` against an fp64 product and against ``gram_plain``."""
    before = sk.gram.launches
    out = sk.gram(x)
    assert sk.gram.launches == before + 1
    torch.cuda.synchronize()
    ref = x.double() @ x.double().T
    plain = sk.gram_plain(x).double()
    bound = sk.gram_error_bound(x)
    # the fp64 product's own rounding, at most P * 2^-53 of sum |x_i||x_j|
    bound64 = x.shape[1] * 2.0**-53 * (x.abs().double() @ x.abs().double().T)
    assert bool(((out.double() - ref).abs() <= bound + bound64).all())
    assert bool(((out.double() - plain).abs() <= bound + (plain - ref).abs() + 2 * bound64).all())
    assert torch.equal(out, out.T)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,p",
    [(5, 273_610), (1, 4097), (32, 4097), (17, 100_003), (3, 1_000_003), (8, 1), (2, 513)],
)
def test_kernel_matches_plain(cuda_device, n, p):
    gen = torch.Generator(device=cuda_device).manual_seed(n * p)
    x = torch.randn(n, p, device=cuda_device, generator=gen) + torch.randn(1, p, device=cuda_device, generator=gen)
    _hold_kernel(x)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(20, 300_007, device=cuda_device, generator=gen)
    first = sk.gram(x)
    for _ in range(3):
        assert torch.equal(sk.gram(x), first)


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda_device):
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(sk.MAX_N + 1, 16, device=cuda_device))
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(16, 4, device=cuda_device).T)
    with pytest.raises(TypeError):
        sk.gram(torch.zeros(4, 16, device=cuda_device, dtype=torch.float16))
