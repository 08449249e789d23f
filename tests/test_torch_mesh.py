"""PyTorch port, ``parallel/mesh.py`` and the noise at a global offset.

The mesh: gloo worlds of 2 (data 2) and 4 (member 2 x data 2) spawned on the
CPU (``tests/_torch_mesh_ranks.py``) run every primitive; their values and
gradients are held exactly, or to 1e-6 relative where a one-process
computation sums in another order, against that computation: the JAX
package's ``make_mesh`` grid and divisibility error, ``shard_batch``'s rows
(and the replicated batch that does not divide), ``replicate``,
``shard_member_state`` and the gather of members, the reductions with
autograd (the gradient of the ranks' mean loss once the parameters'
gradients are averaged), the metrics' reduction.

The noise: a rank holding rows ``[offset, offset + n)`` of a batch must draw
those rows of the whole batch's draw, bit for bit, so that the data-parallel
step is the one-device step. Held exactly here for K1's plain version (fp32
and bf16 planes, host and device seeds, forward and the backward that draws
z again), ``keys.bits``/``keep_mask`` at an element offset, K3's CPU masks
and plain attention, and every per-example draw of ``NoiseSource`` in key,
generator and given mode. The kernels themselves at an offset (marker
``cuda``) run on a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_mesh.py``, and ``chip_smoke.py``'s multi-device phase.
"""
import pytest
import torch

from _torch_mesh_ranks import THETA, collectives, run_world
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.ops import attention, sampling
from beyond_deep_ensembles_tpu_torch.ops.sampling import DeviceSeed

torch.set_num_threads(1)


def _grid(world):
    mp = 2 if world == 4 else 1
    data = world // mp
    rows = [[m * data + d for d in range(data)] for m in range(mp)]
    columns = [[m * data + d for m in range(mp)] for d in range(data)]
    return mp, data, rows, columns


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_placement_and_grid(world, tmp_path):
    results = run_world(collectives, world, tmp_path)
    mp, data, rows, columns = _grid(world)
    theta0 = torch.tensor(THETA)
    for r, out in enumerate(results):
        m, d = r // data, r % data
        group, column = rows[m], columns[d]
        assert out["shape"] == {"member": mp, "data": data} and out["coords"] == (m, d) and out["cached"]
        assert f"{world} rank(s) not divisible by member_parallel=3" in out["indivisible"]
        assert out["engine"] == {"member": 2, "data": world // 2} and out["engine_off"]
        # the data axis' mean and sum, and the gradient of the ranks' mean loss
        theta = theta0.clone().requires_grad_(True)
        y = torch.stack([theta * (s + 1) for s in group]).mean(0)
        z = torch.stack([theta**2 * (s + 1) for s in group]).sum(0)
        loss = sum(((y * (s + 2)) ** 2).sum() + (torch.sin(z) * (s + 1)).sum() for s in group) / len(group)
        (grad,) = torch.autograd.grad(loss, theta)
        torch.testing.assert_close(out["y"], y.detach(), rtol=1e-6, atol=0)
        torch.testing.assert_close(out["z"], z.detach(), rtol=1e-6, atol=0)
        torch.testing.assert_close(out["grad_data"], grad, rtol=1e-6, atol=1e-6)
        # the member axis' gather and its gradient
        theta = theta0.clone().requires_grad_(True)
        w = torch.stack([theta * (s + 1) for s in column])
        weight = torch.arange(w.numel(), dtype=torch.float32).reshape(w.shape)
        (grad,) = torch.autograd.grad(sum((w * weight * (s + 1)).sum() for s in column) / len(column), theta)
        assert torch.equal(out["gathered"], w.detach())
        torch.testing.assert_close(out["grad_member"], grad, rtol=1e-6, atol=0)
        mean, ok = out["mean_of"]
        assert torch.equal(mean, torch.tensor([sum(group) / len(group), 1.0]))
        assert bool(ok) == (1 not in group)
        # placement: this rank's rows, the batch that does not divide whole
        (xs, ys), offset, total = out["shard"]
        n = 8 // data
        assert (offset, total) == (d * n, 8)
        assert torch.equal(ys, torch.arange(d * n, (d + 1) * n))
        assert torch.equal(xs, torch.arange(16.0).reshape(8, 2)[d * n : (d + 1) * n])
        odd, offset, total = out["odd"]
        assert (offset, total) == (0, 5) and torch.equal(odd, torch.arange(5.0))
        assert torch.equal(out["replicated"], torch.zeros(3))
        assert torch.equal(out["replicated_data"], torch.full((2,), float(group[0])))
        # the members: this rank's share, then every member its owner's
        per = 2 // mp
        assert out["own"] == (m * per, per)
        for k, (value, step) in enumerate(out["gathered_members"]):
            assert step == 5 and torch.equal(value, torch.full((2,), 10.0 * (k // per * per + 1) + d))
        loss, per_member = out["metrics"]["loss"], out["metrics"]["loss_per_member"]
        if mp > 1:
            assert float(loss) == pytest.approx((world - 1) / 2, rel=1e-6)
            assert torch.allclose(per_member, torch.tensor([sum(rows[i]) / data for i in range(mp)]))
        else:
            assert float(loss) == pytest.approx(sum(group) / len(group), rel=1e-6)
            assert torch.equal(per_member, torch.full((2,), sum(group) / len(group)))


# --- noise at an offset --------------------------------------------------------


def _planes(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    mean = (0.5 * torch.randn(shape, generator=gen)).to(dtype)
    var = (0.25 * torch.rand(shape, generator=gen) + 1e-3).to(dtype)
    bm = (0.1 * torch.randn(shape[1], generator=gen)).to(dtype)
    bv = (0.01 * torch.rand(shape[1], generator=gen)).to(dtype)
    return mean, var, bm, bv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device_seed", [False, True], ids=["host_seed", "device_seed"])
@pytest.mark.parametrize("shape,offset,n", [((6, 3, 5, 5), 2, 3), ((5, 700), 1, 4), ((4, 10), 3, 1)])
def test_k1_plain_rows_are_the_whole_draws_rows(dtype, device_seed, shape, offset, n):
    """K1's plain version at ``rows``: the forward and the backward's
    redrawn z are the whole batch's rows, bit for bit."""
    mean, var, bm, bv = _planes(shape, dtype)
    seed = DeviceSeed(torch.tensor(123456789, dtype=torch.int64), 7) if device_seed else 987654321
    whole = [t.clone().requires_grad_(True) for t in (mean, var)]
    out = sampling.gaussian_sample(*whole, bm, bv, seed=seed)
    out.backward(torch.ones_like(out))
    part = [t[offset : offset + n].clone().requires_grad_(True) for t in (mean, var)]
    got = sampling.gaussian_sample(*part, bm, bv, seed=seed, rows=(offset, shape[0]))
    got.backward(torch.ones_like(got))
    assert torch.equal(got, out[offset : offset + n])
    assert torch.equal(part[1].grad, whole[1].grad[offset : offset + n])
    # frozen draws one row for every example: the rows change nothing
    frozen = sampling.gaussian_sample(mean[offset : offset + n], var[offset : offset + n], seed=seed, frozen=True,
                                      rows=(offset, shape[0]))
    assert torch.equal(frozen, sampling.gaussian_sample(mean, var, seed=seed, frozen=True)[offset : offset + n])
    with pytest.raises(ValueError, match="rows"):
        sampling.gaussian_sample(mean[:n], var[:n], seed=seed, rows=(shape[0] - n + 1, shape[0]))


@pytest.mark.parametrize("offset,n", [(0, 1000), (517, 2048), (40_000, 77)])
def test_keys_bits_and_masks_at_an_offset(offset, n):
    key = keys.fold_in(12345, 6)
    whole = keys.bits(key, 9, offset + n)
    assert torch.equal(keys.bits(key, 9, n, offset=offset), whole[offset:])
    dev_key = keys.as_key(key, "cpu")
    assert torch.equal(keys.bits(dev_key, 9, n, offset=offset), whole[offset:])
    mask = keys.keep_mask(key, 3, (offset + n,), 0.3)
    assert torch.equal(keys.keep_mask(key, 3, (n,), 0.3, offset=offset), mask[offset:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device_seed", [False, True], ids=["host_seed", "device_seed"])
def test_k3_cpu_masks_and_attention_rows(dtype, device_seed):
    """K3's CPU masks at ``rows`` (host seed: the global shape's draw cut;
    device seed: the element offset) and the plain attention through them:
    the whole batch's rows, bit for bit, forward and backward."""
    b, l, h, dh, offset, n, p = 5, 7, 2, 64, 2, 2, 0.3
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((b, l, h, dh), generator=gen).to(dtype) for _ in range(3))
    key_mask = torch.ones((b, l), dtype=torch.int32)
    key_mask[3, 5:] = 0
    seed = DeviceSeed(torch.tensor(99, dtype=torch.int64), 1 << 20) if device_seed else 4242
    full_mask = (attention.key_keep_mask if device_seed else attention.cpu_keep_mask)((b, h, l, l), seed, p)
    cut = (attention.key_keep_mask if device_seed else attention.cpu_keep_mask)((n, h, l, l), seed, p,
                                                                                 rows=(offset, b))
    assert torch.equal(cut, full_mask[offset : offset + n])
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attention.fused_dropout_attention(*whole, key_mask, dropout_p=p, seed=seed)
    out.sum().backward()
    part = [t[offset : offset + n].clone().requires_grad_(True) for t in (q, k, v)]
    got = attention.fused_dropout_attention(*part, key_mask[offset : offset + n], dropout_p=p, seed=seed,
                                            rows=(offset, b))
    got.sum().backward()
    assert torch.equal(got, out[offset : offset + n])
    for g, w in zip(part, whole):
        assert torch.equal(g.grad, w.grad[offset : offset + n])
    if dtype == torch.float32:  # the debug probabilities take fp32 operands
        _, probs = attention.fused_dropout_attention_debug(*part, key_mask[offset : offset + n], dropout_p=p,
                                                           seed=seed, rows=(offset, b))
        _, want = attention.fused_dropout_attention_debug(*whole, key_mask, dropout_p=p, seed=seed)
        assert torch.equal(probs, want[offset : offset + n])


def _sources(mode, rows, given):
    """Two sources alike but for ``rows`` (the shard's, and None)."""
    def make(r):
        if mode == "key":
            return NoiseSource(key=keys.as_key(keys.fold_in(7, 3), "cpu"), rows=r)
        if mode == "generator":
            return NoiseSource(generator=torch.Generator().manual_seed(11), rows=r)
        return NoiseSource(given=given, rows=r)
    return make(rows), make(None)


@pytest.mark.parametrize("mode", ["key", "generator", "given"])
def test_noise_source_rows_are_the_whole_draws_rows(mode):
    """Every per-example draw of a source at ``rows`` is the whole batch's
    rows; draws of the parameters' shape, and frozen rows, are whole."""
    total, offset, n = 6, 4, 2
    gen = torch.Generator().manual_seed(3)
    given = [torch.randn(total, 4, 3), torch.rand(total, 5) > 0.4, torch.randn(3, 3), torch.randn(4, 3),
             torch.randn(total, 2, 3), torch.rand(total, 2, 4, 4) > 0.3, torch.randn(2, total, 3)]
    shard, whole = _sources(mode, (offset, total), given)
    cut = slice(offset, offset + n)

    def same(a, b):
        assert torch.equal(a, b)

    same(shard.normal((n, 4, 3), "cpu", True, False, batch_axis=0), whole.normal((total, 4, 3), "cpu", True, False,
                                                                                   batch_axis=0)[cut])
    same(shard.keep_mask((n, 5), "cpu", 0.4, batch_axis=0), whole.keep_mask((total, 5), "cpu", 0.4, batch_axis=0)[cut])
    same(shard.normal((3, 3), "cpu", True, False), whole.normal((3, 3), "cpu", True, False))  # a parameter's
    same(shard.normal((n, 4, 3), "cpu", False, True, batch_axis=0),  # frozen: one row for every example
         whole.normal((total, 4, 3), "cpu", False, True, batch_axis=0)[cut])
    mean, var, bm, bv = _planes((total, 2, 3), torch.float32)
    same(shard.gaussian(mean[cut], var[cut], bm, bv, True, True), whole.gaussian(mean, var, bm, bv, True, True)[cut])
    q = torch.randn((total, 4, 2, 64), generator=gen)
    km = torch.ones((total, 4))
    same(shard.attention(q[cut], q[cut], q[cut], km[cut], 0.25), whole.attention(q, q, q, km, 0.25)[cut])
    same(shard.normal((2, n, 3), "cpu", True, False, batch_axis=1),  # SNGP's [S, B, C]
         whole.normal((2, total, 3), "cpu", True, False, batch_axis=1)[:, cut])
    if mode != "given":
        o1, f1 = shard.crops(n, "cpu")
        o2, f2 = whole.crops(total, "cpu")
        same(o1, o2[cut])
        same(f1, f2[cut])
    # a member's source keeps the rows
    assert shard.member(1).rows == (offset, total)


def test_given_draws_per_member():
    """Given draws per member: each member's source takes its own, so members
    split over ranks each take theirs."""
    draws = {0: [torch.zeros(2)], 1: [torch.ones(2)]}
    source = NoiseSource(given=draws)
    assert source.per_member and not NoiseSource(given=[torch.ones(2)]).per_member
    assert torch.equal(source.member(1).normal((2,), "cpu", True, False), torch.ones(2))
    assert torch.equal(source.member(0).normal((2,), "cpu", True, False), torch.zeros(2))


# --- the kernels at an offset, on a card ----------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K1 and K3 run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,n", [((6, 3, 5, 5), 2, 3), ((8, 64, 16, 16), 3, 4), ((5, 700), 1, 4)])
def test_k1_kernel_rows_are_the_whole_launchs_rows(cuda_device, dtype, shape, offset, n):
    mean, var, bm, bv = (t.to(cuda_device) for t in _planes(shape, dtype))
    for seed in (987654321, DeviceSeed(torch.tensor(123456789, dtype=torch.int64, device=cuda_device), 7)):
        whole = [t.clone().requires_grad_(True) for t in (mean, var)]
        out = sampling.gaussian_sample(*whole, bm, bv, seed=seed)
        out.backward(torch.ones_like(out))
        part = [t[offset : offset + n].clone().requires_grad_(True) for t in (mean, var)]
        got = sampling.gaussian_sample(*part, bm, bv, seed=seed, rows=(offset, shape[0]))
        got.backward(torch.ones_like(got))
        assert torch.equal(got, out[offset : offset + n])
        assert torch.equal(part[1].grad, whole[1].grad[offset : offset + n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_kernels_rows_are_the_whole_launchs_rows(cuda_device, dtype):
    b, l, h, offset, n = 6, 96, 4, 2, 3
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn((b, l, h, 64), generator=gen, device=cuda_device).to(dtype) for _ in range(3))
    key_mask = torch.ones((b, l), dtype=torch.int32, device=cuda_device)
    for seed in (4242, DeviceSeed(torch.tensor(99, dtype=torch.int64, device=cuda_device), 1 << 20)):
        whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention.fused_dropout_attention(*whole, key_mask, dropout_p=0.1, seed=seed)
        out.float().sum().backward()
        part = [t[offset : offset + n].clone().requires_grad_(True) for t in (q, k, v)]
        got = attention.fused_dropout_attention(*part, key_mask[offset : offset + n], dropout_p=0.1, seed=seed,
                                                rows=(offset, b))
        got.float().sum().backward()
        assert torch.equal(got, out[offset : offset + n])
        for g, w in zip(part, whole):
            assert torch.equal(g.grad, w.grad[offset : offset + n])
