"""PyTorch port, ops/sampling.py (K1): the plain version and its gradient
held against the JAX layers' epilogue math on the same noise, the CPU
generator mode, input checks, and (on a card only) the Triton kernel against
the plain version.

The JAX Pallas kernel cannot run on the CPU (tests/test_sampling_kernel.py),
so the hold is against the expression the JAX layers compute
(nn/bbb.py:89-95, :163-170). Tolerances: the same fp32 operations in the same
order, 1e-6 absolute on outputs; gradients 1e-5 relative (the bias
gradients are sums over N, H, W taken in another order). The seeded
backward draws z again from the seed, so its gradients equal those of the
same z given, bit for bit.

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
# driven down, where recovering z from the output would lose the most
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
    """Seeded mode saves no z and no output: the backward regenerates z from
    the seed (the name is older than that: it once recovered z from the
    output). Its gradients equal those of the same draw fed as given noise,
    bit for bit, in every tensor; a second derivative raises."""
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
    for a, b in zip(grads, grads2):
        assert torch.equal(a, b)
    again = sampling.gaussian_sample(mean, var, b_mean, b_var, seed=1234)
    # a loss whose gradient at the output depends on the output
    first = torch.autograd.grad((again * again * g).sum(), leaves, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        first[1].sum().backward()


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
    # frozen mode draws position i of the row as the train mode draws index i
    assert torch.equal(rows[:1], sampling.gaussian_sample(mean[:1], torch.ones_like(mean[:1]), seed=13))
    head = torch.zeros(500, 10, device=cuda_device)
    head_rows = sampling.gaussian_sample(head, torch.ones_like(head), seed=14, frozen=True)
    assert torch.equal(head_rows, head_rows[:1].expand_as(head_rows))
    assert torch.equal(head_rows[:1], sampling.gaussian_sample(head[:1], torch.ones_like(head[:1]), seed=14))


# the 22 planes of a ResNet-20 forward at batch 128 (train) flattened, the
# per-example rows of frozen eval, and ragged sizes around the map's blocks
MAIN_PATH_SIZES = [128 * 16 * 32 * 32, 128 * 32 * 16 * 16, 128 * 64 * 8 * 8, 1280, 16384, 8192, 4096, 10]
RAGGED_SIZES = [1, 511, 512, 513, 2047, 2049, 100_003]


@pytest.mark.parametrize("n", MAIN_PATH_SIZES + RAGGED_SIZES)
def test_philox_slot_is_a_bijection(n):
    """Every index of [0, n) gets its own (counter, lane), and the train
    kernel's program p, sub-block l, column j (index 4Gp + lG + j) draws at
    counter Gp + j, output l."""
    g = sampling._GROUP
    i = np.arange(n, dtype=np.int64)
    counter, lane = sampling.philox_slot(i)
    assert ((lane >= 0) & (lane < 4)).all()
    assert ((counter >= 0) & (counter < -(-n // (4 * g)) * g)).all()
    assert len(np.unique(counter * 4 + lane)) == n
    program, column = counter // g, counter % g
    np.testing.assert_array_equal(program * 4 * g + lane * g + column, i)


@pytest.mark.parametrize(
    "batch,row",
    [(500, 16384), (500, 8192), (500, 4096), (500, 10), (128, 16384), (301, 16384), (3, 5000), (70_000, 10), (1, 1),
     (7, 2049)],
)
def test_frozen_grid_covers_each_element_once(batch, row):
    """The frozen launch's 2-D grid touches each (example, row position)
    exactly once, draws each position through ``philox_slot`` and fits
    gridDim.y."""
    g = sampling._GROUP
    width, lanes, row_chunks, per_program, batch_chunks = sampling.frozen_plan(batch, row)
    assert batch_chunks <= sampling._MAX_GRID_Y and width & (width - 1) == 0
    hits = np.zeros((batch, row), np.int32)
    cols = np.arange(width)
    for r in range(row_chunks):
        counters = r * g + cols
        for lane in range(lanes):
            pos = r * 4 * g + lane * g + cols
            live = pos < row
            slot_counter, slot_lane = sampling.philox_slot(pos[live])
            np.testing.assert_array_equal(slot_counter, counters[live])
            assert (slot_lane == lane).all()
            for b in range(batch_chunks):
                hits[b * per_program:min((b + 1) * per_program, batch), pos[live]] += 1
    assert (hits == 1).all()


def _realized_noise(shape, seed, frozen, device):
    """The z the seeded kernel draws, read back through a zero mean and a
    unit variance (0 + sqrt(1) * z = z exactly)."""
    zeros = torch.zeros(shape, device=device)
    z = sampling.gaussian_sample(zeros, torch.ones_like(zeros), seed=seed, frozen=frozen)
    return z[0].contiguous() if frozen else z


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize(
    "shape,bias",
    [((128, 16, 32, 32), True), ((128, 32, 16, 16), False), ((128, 10), True), ((500, 16, 32, 32), True),
     ((301, 16, 32, 32), True)],
)
def test_kernel_backward_regenerates_z(cuda_device, shape, bias, frozen):
    """The backward kernel: in Philox mode its output and gradients equal
    the given mode's at the same z bit for bit; in both they match the plain
    version's autograd (rel 1e-5); one launch per backward in its own
    counter. At batches 500 and 301 a frozen program loops over several
    examples and the last batch chunk is ragged
    (``test_frozen_plan_loops_over_examples``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    leaves = [0.5 * torch.randn(shape, device=cuda_device, generator=gen),
              0.25 * torch.rand(shape, device=cuda_device, generator=gen) + 1e-4]
    if bias:
        leaves += [torch.randn(shape[1], device=cuda_device, generator=gen),
                   torch.rand(shape[1], device=cuda_device, generator=gen)]
    leaves = [t.requires_grad_(True) for t in leaves]
    args = leaves if bias else leaves + [None, None]
    g = torch.randn(shape, device=cuda_device, generator=gen)
    z = _realized_noise(shape, 21, frozen, cuda_device)

    forwards, backwards = sampling.gaussian_sample.launches, sampling.gaussian_sample_backward.launches
    out = sampling.gaussian_sample(*args, seed=21, frozen=frozen)
    seeded = torch.autograd.grad((out * g).sum(), leaves)
    assert sampling.gaussian_sample.launches == forwards + 1
    assert sampling.gaussian_sample_backward.launches == backwards + 1
    given_out = sampling.gaussian_sample(*args, eps=z)
    given = torch.autograd.grad((given_out * g).sum(), leaves)
    assert torch.equal(out, given_out)
    for a, b in zip(seeded, given):
        assert torch.equal(a, b)
    plain = torch.autograd.grad((sampling.gaussian_sample_plain(*args, z) * g).sum(), leaves)
    for a, b in zip(given, plain):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= 1e-5, err


@pytest.mark.parametrize("batch,per_program,last", [(500, 3, 2), (301, 2, 1)])
def test_frozen_plan_loops_over_examples(batch, per_program, last):
    """At the largest layers' row (16x32x32), eval batch 500 gives a program
    3 examples and the last batch chunk 2; batch 301 leaves 1 in the last."""
    _, _, row_chunks, got, chunks = sampling.frozen_plan(batch, 16 * 32 * 32)
    assert (row_chunks, got, batch - (chunks - 1) * got) == (8, per_program, last)



@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
def test_device_seed_equals_the_integer_seed_on_the_cpu(frozen):
    """A device seed (an int64 key in memory plus a draw index) is the seed
    key + index: the plain version draws the same z, the same output and the
    same gradients as through that integer, bit for bit; the autograd
    context keeps the key tensor, so writing it between the forward and the
    backward raises."""
    mean, var, b_mean, b_var = (_to_port(a) for a in _inputs((4, 3, 5, 5), True))
    leaves = [t.requires_grad_(True) for t in (mean, var, b_mean, b_var)]
    g = torch.randn(mean.shape, generator=torch.Generator().manual_seed(2))
    key = torch.tensor(2**40 + 17)
    outs, grads = [], []
    for seed in (sampling.DeviceSeed(key, 5), 2**40 + 22):
        out = sampling.gaussian_sample(*leaves, seed=seed, frozen=frozen)
        outs.append(out)
        grads.append(torch.autograd.grad((out * g).sum(), leaves))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    other = sampling.gaussian_sample(*leaves, seed=sampling.DeviceSeed(key, 6), frozen=frozen)
    assert not torch.equal(other, outs[0])
    out = sampling.gaussian_sample(*leaves, seed=sampling.DeviceSeed(key, 5), frozen=frozen)
    key.add_(1)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        out.sum().backward()
    with pytest.raises(ValueError):
        sampling.gaussian_sample(mean, var, seed=sampling.DeviceSeed(torch.tensor(1.0), 0))


@pytest.mark.cuda
@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize("shape,bias", [((128, 16, 32, 32), True), ((500, 64, 8, 8), True), ((128, 10), True)])
def test_kernel_device_seed(cuda_device, shape, bias, frozen):
    """K1 with its seed in device memory: the output and the gradients equal
    the host seed key + index bit for bit; a CUDA graph that captured the
    forward and backward draws afresh at each replay once the key moves,
    equal to the host seed of the key's new value."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    leaves = [0.5 * torch.randn(shape, device=cuda_device, generator=gen),
              0.25 * torch.rand(shape, device=cuda_device, generator=gen) + 1e-4,
              torch.randn(shape[1], device=cuda_device, generator=gen),
              torch.rand(shape[1], device=cuda_device, generator=gen)]
    leaves = [t.requires_grad_(True) for t in leaves]
    g = torch.randn(shape, device=cuda_device, generator=gen)
    key = torch.tensor(2**45 + 3, device=cuda_device)

    def run(seed):
        out = sampling.gaussian_sample(*leaves, seed=seed, frozen=frozen)
        return out, torch.autograd.grad((out * g).sum(), leaves)

    out, grads = run(sampling.DeviceSeed(key, 7))
    ref, ref_grads = run(2**45 + 10)
    assert torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(grads, ref_grads))

    static = [t.detach().clone().requires_grad_(True) for t in leaves]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sampling.gaussian_sample(*static, seed=sampling.DeviceSeed(key, 7), frozen=frozen).sum().backward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sampling.gaussian_sample(*static, seed=sampling.DeviceSeed(key, 7), frozen=frozen)
        captured_grads = torch.autograd.grad((captured * g).sum(), static)
    replays = []
    for value in (2**45 + 100, 2**45 + 200):
        key.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        want, want_grads = run(value + 7)
        assert torch.equal(captured, want) and all(torch.equal(a, b) for a, b in zip(captured_grads, want_grads))
        replays.append(captured.clone())
    assert not torch.equal(replays[0], replays[1])
