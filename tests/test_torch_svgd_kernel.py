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
        sk.gram(torch.zeros(4, 0))
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(4, 10, device="meta"))
    assert sk.gram(torch.ones(sk.MAX_N, 3)).shape == (sk.MAX_N, sk.MAX_N)
    # K2's row bound is the card's: the CPU path takes any n
    assert sk.gram(torch.ones(sk.MAX_N + 1, 3)).shape == (sk.MAX_N + 1, sk.MAX_N + 1)


def test_more_than_32_particles_on_the_cpu_match_jax():
    """n = 40 (beyond K2's 32 rows) on the CPU: d^2 and phi against the JAX
    functions (``use_pallas=False``), at the tolerances above."""
    import jax.numpy as jnp
    from _torch_parity import assert_close
    from beyond_deep_ensembles_tpu.ops.svgd_kernel import pairwise_sq_dists as jax_d2
    from beyond_deep_ensembles_tpu.ops.svgd_kernel import rbf_phi as jax_phi

    x = _particles(40, 700, seed=40)
    g = np.random.RandomState(41).standard_normal(x.shape).astype(np.float32)
    ref = np.asarray(jax_d2(jnp.asarray(x), use_pallas=False))
    got = sk.pairwise_sq_dists(torch.from_numpy(x)).numpy()
    top = float(np.max(np.sum(x.astype(np.float64) ** 2, axis=1)))
    assert_close(got / top, ref / top, rtol=0, atol=1e-5, err_msg="d^2 / max diag G, n = 40")
    ref = np.asarray(jax_phi(jnp.asarray(x), jnp.asarray(g), 1.0, 1000, use_pallas=False))
    got = sk.rbf_phi(torch.from_numpy(x), torch.from_numpy(g), 1.0, 1000).numpy()
    top = float(np.abs(ref).max())
    assert_close(got / top, ref / top, rtol=0, atol=1e-5, err_msg="phi / max|phi|, n = 40")


def test_summation_depth_follows_the_launch_shape():
    # 1664 columns a tile, 165 tiles over 132 blocks (1 per SM): 2 tiles of 7
    # columns a thread, the warp tree, 8 warps, 5 blocks a lane, the tree
    assert sk.summation_depth(5, 273_610) == 2 * 7 + 5 + 7 + 5 + 5
    # 1152 columns a tile (a ring of 2), 21,702 tiles over 132 blocks: 165
    # tiles of 18 columns a thread, the tree, 2 slices, 5 blocks a lane, the
    # tree
    assert sk.summation_depth(20, 25_000_000) == 165 * 18 + 5 + 1 + 5 + 5
    x = torch.from_numpy(_particles(3, 4097))
    bound = sk.gram_error_bound(x)
    assert bound.dtype == torch.float64 and bound.shape == (3, 3) and bool((bound > 0).all())


def _warp_work(n, plan, warp):
    """What warp ``warp`` of a K2 block accumulates, as csrc/svgd_gram.cu
    assigns it: the entries (i, j <= i) of G, and the tile's columns its
    lanes take (q, q + step, ...)."""
    pair, slice_ = warp % plan.pairs, warp // plan.pairs
    if n <= 8:
        entries = [(i, j) for i in range(n) for j in range(i + 1)]
    else:
        ta = 0
        while (ta + 1) * (ta + 2) // 2 <= pair:
            ta += 1
        tb = pair - ta * (ta + 1) // 2
        entries = [(8 * ta + u, 8 * tb + v) for u in range(8) for v in range(8)
                   if 8 * ta + u < n and 8 * tb + v < n and (ta > tb or v <= u)]
    return entries, [slice_ * 32 + lane for lane in range(32)], 32 * plan.slices


@pytest.mark.parametrize("p", [1, 127, 129, 4097, 273_610, 1_000_003])
def test_launch_plan_covers_columns_and_triangle(p):
    """For n = 1..32: the blocks' tiles cover [0, P) once; in a tile, the
    warps of each pair take every column once; over the pairs, every (i, j
    <= i) is summed once; the staged ring fits the shared memory of the
    kernel's path."""
    for n in range(1, sk.MAX_N + 1):
        plan = sk.launch_plan(n, p)
        assert plan.cols % 128 == 0 and (plan.tiles - 1) * plan.cols < p <= plan.tiles * plan.cols
        owned = [range(plan.tiles * b // plan.blocks, plan.tiles * (b + 1) // plan.blocks) for b in range(plan.blocks)]
        assert [t for r in owned for t in r] == list(range(plan.tiles)) and all(len(r) for r in owned)
        warps = plan.pairs * plan.slices
        if n <= 8:
            stages, smem_floats = sk._SMALL_STAGES, sk._SMALL_SMEM_FLOATS
        else:
            stages, smem_floats = sk._PAIR_STAGES, sk._PAIR_SMEM_FLOATS
        assert warps <= 12 and (stages * n + 1) * (plan.cols + 4) <= smem_floats
        # the SM's 228 KB hold the block, with 3 KB of static shared memory and 1 KB the system keeps
        assert 4 * smem_floats + 4096 <= 228 * 1024
        entries = {}
        columns = {}
        for w in range(warps):
            mine, firsts, step = _warp_work(n, plan, w)
            for e in mine:
                entries.setdefault(e, set()).add(w % plan.pairs)
            taken = columns.setdefault(w % plan.pairs, [])
            taken += [c for q in firsts for c in range(q, plan.cols, step)]
        assert sorted(entries) == [(i, j) for i in range(n) for j in range(i + 1)]
        assert all(len(pairs) == 1 for pairs in entries.values())
        assert all(sorted(cols) == list(range(plan.cols)) for cols in columns.values())


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
    [(5, 273_610), (1, 4097), (32, 4097), (17, 100_003), (3, 1_000_003), (8, 1), (2, 513),
     (9, 50_001), (20, 300_007), (8, 200_003), (32, 1_000_001)],
)
def test_kernel_matches_plain(cuda_device, n, p):
    gen = torch.Generator(device=cuda_device).manual_seed(n * p)
    x = torch.randn(n, p, device=cuda_device, generator=gen) + torch.randn(1, p, device=cuda_device, generator=gen)
    _hold_kernel(x)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_takes_rows_off_16_byte_boundaries(cuda_device, offset):
    """X starting 4, 8 or 12 bytes past a 16-byte boundary, odd P: every
    row's copies start before its first column."""
    gen = torch.Generator(device=cuda_device).manual_seed(offset)
    n, p = 7, 30_001
    x = torch.randn(n * p + offset, device=cuda_device, generator=gen)[offset:].view(n, p)
    assert x.data_ptr() % 16 == 4 * offset
    _hold_kernel(x)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 8, 9, 17, 20, 32])
def test_kernel_repeats_inside_a_cuda_graph(cuda_device, n):
    """One launch per call, within its bound, and the same bits eagerly and
    over replays of a CUDA graph (the ticket counter is back at 0 after
    every launch)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, 200_003, device=cuda_device, generator=gen) + 1.0
    first = _hold_kernel(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sk.gram(x)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert torch.equal(sk.gram(x), first)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(20, 300_007, device=cuda_device, generator=gen)
    first = sk.gram(x)
    for _ in range(3):
        assert torch.equal(sk.gram(x), first)


@pytest.mark.cuda
def test_kernel_rejects_33_rows(cuda_device):
    """K2 takes at most 32 rows; a CUDA tensor of 33 raises rather than
    taking the plain product."""
    launches = sk.gram.launches
    with pytest.raises(ValueError, match="32"):
        sk.gram(torch.ones(33, 4097, device=cuda_device))
    assert sk.gram.launches == launches


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda_device):
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(sk.MAX_N + 1, 16, device=cuda_device))
    with pytest.raises(ValueError):
        sk.gram(torch.zeros(16, 4, device=cuda_device).T)
    with pytest.raises(TypeError):
        sk.gram(torch.zeros(4, 16, device=cuda_device, dtype=torch.float16))
