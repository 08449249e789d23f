"""PyTorch port, K1 on bf16 planes (``ops/sampling.py`` over
``csrc/gaussian_sample_bf16.cu``): the draw's map, its launch geometry and
its plain twin on the CPU; the kernels against the twin and the plain
version on a card.

The bf16 kernels draw z_i as normal ``i % 8`` of the Philox-4x32-10 call at
counter ``i // 8`` (``philox_slot_bf16``), a Box-Muller pair per 32-bit
word split 20 / 12 between radius and angle. ``normals_bf16_plain`` is that
map in torch integer ops and float64; the CPU cases hold it to Philox's
published known-answer vectors, to the bit layout the kernel builds its
uniforms from, and to N(0, 1) over 2^22 draws (mean and variance within 5
standard errors, Kolmogorov-Smirnov distance below its 1 % critical value,
the counts beyond 3 and 4 sigma within 5 binomial standard deviations), and
hold the launch geometry (slots, the frozen grid, a shard's offset, the
channel divider) by enumeration. The kernel cases (marker ``cuda``) run on a
card with ``python -m pytest --noconftest -m cuda tests/test_torch_k1_bf16.py``
(this file imports no JAX)."""
import math

import numpy as np
import pytest
import torch

from beyond_deep_ensembles_tpu_torch.ops import sampling

DRAWS = 1 << 22


@pytest.fixture
def cuda_device():
    """The card, for kernel cases; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# Random123's kat_vectors for philox4x32_10: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_twin_reproduces_the_known_answers(counter, key, want):
    got = sampling.philox4x32_plain(*counter, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_twin_multiplies_exactly():
    """The 16-bit split of the 32 x 32 -> 64 product against Python's
    integers, at random words and at the edges."""
    rng = np.random.default_rng(0)
    c = np.concatenate([rng.integers(0, 2**32, 10_000, dtype=np.uint64), np.array([0, 1, 2**16, 2**32 - 1])])
    for m in sampling._PHILOX_M:
        hi, lo = sampling._mulhilo(m, torch.from_numpy(c.astype(np.int64)))
        want = [int(x) * m for x in c]
        assert hi.tolist() == [w >> 32 for w in want]
        assert lo.tolist() == [w & 0xFFFFFFFF for w in want]


# bf16 planes' element counts on the main paths (poverty's 512 x 14 x 14 and
# camelyon17's smallest at their batches, CIFAR's largest and its frozen
# eval's smallest) and ragged sizes around a group of 8 and a block of 2048;
# the map is the same arithmetic at poverty's largest planes (2e8 elements)
MAIN_PATH_SIZES = [64 * 512 * 14 * 14, 32 * 32 * 3 * 3, 128 * 16 * 32 * 32, 500 * 64 * 8 * 8, 128 * 10]
RAGGED_SIZES = [1, 7, 8, 9, 2047, 2049, 100_003]


@pytest.mark.parametrize("n", MAIN_PATH_SIZES + RAGGED_SIZES)
def test_philox_slot_bf16_is_a_bijection(n):
    """Every index of [0, n) gets its own (counter, lane); thread t of the
    flat launch (global elements 8 t .. 8 t + 7) draws at counter t, normal
    k, and a block's 256 threads cover 2048 contiguous elements."""
    i = np.arange(n, dtype=np.int64)
    counter, lane = sampling.philox_slot_bf16(i)
    assert ((lane >= 0) & (lane < 8)).all()
    assert ((counter >= 0) & (counter < -(-n // 8))).all()
    assert len(np.unique(counter * 8 + lane)) == n
    np.testing.assert_array_equal(counter * 8 + lane, i)
    assert sampling._BF16_BLOCK == 256 * 8


@pytest.mark.parametrize(
    "batch,row",
    [(500, 16384), (500, 4096), (500, 10), (128, 16384), (301, 16384), (3, 5000), (70_000, 10), (1, 1), (7, 2049),
     (500, 27), (64, 788_544)],
)
def test_frozen_bf16_grid_covers_each_element_once(batch, row):
    """The bf16 frozen launch's 2-D grid touches each (example, row
    position) exactly once, draws each position as example 0's train draw
    (counter r // 8, normal r % 8) and fits gridDim.y."""
    row_chunks, per_program, batch_chunks = sampling.frozen_plan_bf16(batch, row)
    assert batch_chunks <= sampling._MAX_GRID_Y
    hits = np.zeros((min(batch, 600), row), np.int32)
    for x in range(row_chunks):
        first = x * sampling._BF16_BLOCK
        pos = np.arange(first, min(first + sampling._BF16_BLOCK, row))
        counter, lane = sampling.philox_slot_bf16(pos)
        np.testing.assert_array_equal(counter, pos // 8)
        np.testing.assert_array_equal(lane, pos % 8)
        for y in range(batch_chunks):
            lo, hi = y * per_program, min((y + 1) * per_program, batch)
            if lo < hits.shape[0]:
                hits[lo:min(hi, hits.shape[0]), pos] += 1
    assert (hits == 1).all()
    assert (batch_chunks - 1) * per_program < batch <= batch_chunks * per_program


@pytest.mark.parametrize("shape,rows", [((6, 10), (1, 9)), ((4, 3, 3, 3), (3, 7)), ((5, 16, 8, 8), (2, 12)),
                                        ((9, 5), (4, 13)), ((1, 1), (0, 1))])
def test_offset_shard_draws_the_whole_batchs_rows(shape, rows):
    """A shard of rows [offset, offset + B) of a batch of ``total``: the
    kernel's launch starts at the group of 8 holding the shard's first
    global element (counter start // 8, that many elements before the plane
    masked), so each element draws at its global slot, and the twin's shard
    equals those rows of the whole draw, bit for bit."""
    offset, total = rows
    row = math.prod(shape[1:])
    start = sampling._element_offset(rows, shape)
    assert start == offset * row
    group0, shift = divmod(start, 8)
    n = math.prod(shape)
    t = np.arange(-(-(shift + n) // 8))
    local = (t[:, None] * 8 + np.arange(8)[None, :] - shift).reshape(-1)
    counters = np.repeat(group0 + t, 8)
    live = (local >= 0) & (local < n)
    assert sorted(local[live].tolist()) == list(range(n))
    np.testing.assert_array_equal(counters[live], sampling.philox_slot_bf16(local[live] + start)[0])
    part = sampling.normals_bf16_plain(1234, n, start=start)
    whole = sampling.normals_bf16_plain(1234, total * row)
    assert torch.equal(part, whole[start:start + n])


def test_twin_uniforms_are_the_kernels_bit_layout():
    """The kernel builds u = (k + 1/2) 2^-20 from the top 20 bits as the
    float 1 + u less 1, and the angle from the low 12 bits as the float 1 +
    (j + 1/2) 2^-12: both exact, as the twin computes them."""
    rng = np.random.default_rng(1)
    w = np.concatenate([rng.integers(0, 2**32, 100_000, dtype=np.uint64), np.array([0, 0xFFF, 0xFFFFF000,
                                                                                     2**32 - 1])]).astype(np.uint32)
    u = (((w >> 9) & 0x7FFFF8) | 0x3F800004).view(np.float32) - np.float32(1.0)
    np.testing.assert_array_equal(u.astype(np.float64), ((w >> 12).astype(np.float64) + 0.5) * 2.0**-20)
    x = (((w << 11) & 0x7FF800) | 0x3F800400).view(np.float32)
    np.testing.assert_array_equal(x.astype(np.float64) - 1.0, ((w & 0xFFF).astype(np.float64) + 0.5) * 2.0**-12)
    assert u.min() > 0.0 and u.max() < 1.0


def test_twin_draws_the_normal_distribution():
    """2^22 draws of the twin: mean and variance within 5 standard errors,
    the KS distance below its 1 % critical value, the counts beyond 3 and 4
    sigma within 5 binomial standard deviations, and the tail it reaches:
    the smallest radial uniform, 2^-21, gives |z| up to sqrt(42 ln 2) =
    5.396 >= 5.3."""
    z, r = sampling.normals_bf16_plain(2024, DRAWS, with_radius=True)
    zd = z.double()
    n = zd.numel()
    assert abs(float(zd.mean())) <= 5.0 / math.sqrt(n)
    assert abs(float(zd.var()) - 1.0) <= 5.0 * math.sqrt(2.0 / (n - 1))
    s = torch.sort(zd).values
    cdf = 0.5 * torch.erfc(-s / math.sqrt(2.0))
    i = torch.arange(1, n + 1, dtype=torch.float64)
    ks = float(torch.maximum(i / n - cdf, cdf - (i - 1) / n).max())
    assert ks < 1.628 / math.sqrt(n), ks
    for t in (3, 4):
        p = math.erfc(t / math.sqrt(2.0))
        k = int((zd.abs() > t).sum())
        assert abs(k - n * p) <= 5.0 * math.sqrt(n * p * (1.0 - p)), (t, k, n * p)
    cap = math.sqrt(-2.0 * math.log(0.5 * 2.0**-20))
    assert cap >= 5.3 and float(r.max()) <= cap + 1e-12 and float(zd.abs().max()) <= cap
    # the radius is r(u) at the draw's own u: r^2 = -2 ln u with u on the 2^-20 grid
    u = torch.exp(-0.5 * r * r)
    k = u * 2.0**20 - 0.5
    assert float((k - k.round()).abs().max()) < 1e-6


def test_twin_pairs_cos_and_sin_of_one_word():
    """Elements 2 m and 2 m + 1 of a call are one word's pair: the same
    radius, z0^2 + z1^2 = r^2, and the frozen row of a plane is the train
    draw of its first ``row`` elements."""
    z, r = sampling.normals_bf16_plain(5, 4096, with_radius=True)
    assert torch.equal(r[0::2], r[1::2])
    np.testing.assert_allclose((z[0::2].double() ** 2 + z[1::2].double() ** 2).numpy(),
                               (r[0::2] ** 2).numpy(), rtol=1e-6)
    assert torch.equal(sampling.normals_bf16_plain(5, 1000), z[:1000])


@pytest.mark.parametrize("d", list(range(1, 300)) + [12321, 3136, 784, 196, 50176, 2304, 576, 144, 36, 9, 788_544,
                                                      16384, 65535, 2**20 + 7, 2**30 + 1, 2**31 - 1])
def test_divider_divides_every_index(d):
    """The channel index's magic multiplier: n // d == (n magic) >> shift
    for indices up to 2^31 - 1 (random, around multiples of d, the edges)."""
    magic, shift = sampling._divider(d)
    assert 0 < magic < 2**32
    rng = np.random.default_rng(d)
    n = np.concatenate([rng.integers(0, 2**31, 4000, dtype=np.uint64),
                        np.arange(0, min(3 * d + 3, 2000), dtype=np.uint64),
                        np.array([2**31 - 1, 2**31 - 2], dtype=np.uint64)])
    near = (2**31 - 1) // d * d
    n = np.concatenate([n, np.array([near - 1, near, max(near - d, 0)], dtype=np.uint64)])
    np.testing.assert_array_equal((n * np.uint64(magic)) >> np.uint64(shift), n // np.uint64(d))


@pytest.mark.parametrize("hw,run", [(12321, 2), (3136, 3), (196, 2), (9, 2), (8, 3), (1, 1), (4, 1), (64, 3)])
def test_channel_run_of_a_vector_group(hw, run):
    """A vector group (8 elements from a multiple of 8) lies in one channel
    when hw % 8 == 0 (run 3), in at most two when hw >= 8 (2), else in up to
    8 (1); checked against the channels of every group of a small plane."""
    assert sampling._channel_run(hw) == run
    channels = 3
    l0 = np.arange(0, channels * hw - 7, 8)
    spans = [len(set(((l0_ + np.arange(8)) // hw % channels).tolist())) for l0_ in l0]
    assert max(spans, default=1) <= {3: 1, 2: 2, 1: 8}[run]


def test_noise_bf16_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        sampling.noise_bf16(torch.zeros(2, 3, dtype=torch.bfloat16), 1)


def test_bf16_planes_on_the_cpu_keep_the_plain_path():
    """On the CPU the bf16 planes still draw through ``torch.randn`` and
    ``gaussian_sample_plain`` and count no launch, of either kind."""
    before = (sampling.gaussian_sample.launches, sampling.gaussian_sample.bf16_launches)
    mean = torch.zeros(3, 4, dtype=torch.bfloat16)
    out = sampling.gaussian_sample(mean, torch.ones_like(mean), seed=9)
    gen = torch.Generator().manual_seed(9)
    assert torch.equal(out, torch.randn(3, 4, generator=gen).bfloat16())
    assert (sampling.gaussian_sample.launches, sampling.gaussian_sample.bf16_launches) == before


# kernel cases: the CUDA kernels against the twin and the plain version

def _spacing(want):
    """The bf16 spacing at each of ``want``: 2^(e - 8) for |want| = m 2^e, m
    in [0.5, 1) (frexp: log2 on the card reads a power of two as just below
    it); 2^-133 at and below 2^-126."""
    want = want.double()
    return torch.ldexp(torch.ones_like(want), torch.frexp(want.abs().clamp_min(2.0**-126))[1] - 8)


def _planes(device, shape, bias, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    mean = (0.5 * torch.randn(shape, device=device, generator=gen)).bfloat16()
    var = (0.25 * torch.rand(shape, device=device, generator=gen) + 1e-4).bfloat16()
    b_mean = torch.randn(shape[1], device=device, generator=gen).bfloat16() if bias else None
    b_var = torch.rand(shape[1], device=device, generator=gen).bfloat16() if bias else None
    return mean, var, b_mean, b_var


KERNEL_CASES = [((64, 64, 11, 11), True), ((8, 16, 8, 8), True), ((5, 3, 3, 3), True), ((16, 32, 16, 16), False),
                ((9, 5), True), ((128, 10), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bias", KERNEL_CASES)
def test_kernel_draw_matches_the_twin(cuda_device, shape, bias):
    """The kernel's Philox words equal the twin's bit for bit, its z is
    within ``noise_bf16_tolerance`` of the twin's, its frozen row is the
    train draw of example 0, and a shard at an offset draws the whole
    batch's rows, all read back through ``noise_bf16``."""
    mean = _planes(cuda_device, shape, bias)[0]
    seed = sampling.DeviceSeed(torch.full((), 77, dtype=torch.int64, device=cuda_device), 3)
    n = mean.numel()
    words = sampling.noise_bf16(mean, seed, words=True)
    counters = torch.arange(words.shape[0], dtype=torch.int64, device=cuda_device)
    assert torch.equal(words, torch.stack(sampling.philox4x32_plain(counters, 0, 0, 0, 80, 0), dim=-1))
    z = sampling.noise_bf16(mean, seed)
    twin, r = sampling.normals_bf16_plain(80, n, device=cuda_device, with_radius=True)
    assert ((z.flatten() - twin).abs() <= sampling.noise_bf16_tolerance(r)).all()
    assert torch.equal(sampling.noise_bf16(mean, seed, frozen=True), z[0])
    first = shape[0] // 2
    assert torch.equal(sampling.noise_bf16(mean[first:], seed, rows=(first, shape[0])), z[first:])


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize("shape,bias", KERNEL_CASES)
def test_kernel_within_one_ulp_and_seeded_equals_given(cuda_device, shape, bias, frozen):
    """Forward within one bf16 ulp of the plain version at the kernel's own
    z (beyond the fp32 sums' 2^-22 margin), d act_var within one ulp of the
    plain backward; the seeded forward and gradients equal the same z given,
    bit for bit; one launch each way, on the bf16 counters too."""
    mean, var, b_mean, b_var = _planes(cuda_device, shape, bias, seed=1)
    g = torch.randn(shape, device=cuda_device).bfloat16()
    z = sampling.noise_bf16(mean, 21, frozen=frozen)
    leaves = [t.clone().requires_grad_(True) for t in (mean, var)]
    before = (sampling.gaussian_sample.launches, sampling.gaussian_sample.bf16_launches,
              sampling.gaussian_sample_backward.launches, sampling.gaussian_sample_backward.bf16_launches)
    out = sampling.gaussian_sample(*leaves, b_mean, b_var, seed=21, frozen=frozen)
    out.backward(g)
    assert (sampling.gaussian_sample.launches, sampling.gaussian_sample.bf16_launches,
            sampling.gaussian_sample_backward.launches, sampling.gaussian_sample_backward.bf16_launches) == tuple(
        c + 1 for c in before)
    given_leaves = [t.clone().requires_grad_(True) for t in (mean, var)]
    given = sampling.gaussian_sample(*given_leaves, b_mean, b_var, eps=z.contiguous())
    given.backward(g)
    assert torch.equal(out, given)
    assert torch.equal(leaves[1].grad, given_leaves[1].grad)
    ref = sampling.gaussian_sample_plain(mean, var, b_mean, b_var, z)
    a = sampling._add_bias(mean.float(), None if b_mean is None else b_mean.float())
    std = torch.sqrt(sampling._add_bias(var.float(), None if b_var is None else b_var.float()))
    spacing = _spacing(ref)
    err = ((out.double() - ref.double()).abs() - 2.0**-22 * (a.abs() + (std * z).abs()).double()).clamp_min(0.0)
    assert float((err / spacing).max()) <= 1.0
    ref_d = (g.float() * z * 0.5 / std).bfloat16()
    spacing = _spacing(ref_d)
    assert float(((leaves[1].grad.double() - ref_d.double()).abs() / spacing).max()) <= 1.0
