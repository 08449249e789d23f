"""PyTorch port, keys.py: the counter hash ``bits`` runs on int32 tensors
below 2^31 values (half the memory traffic of int64; the dropout masks of a
ResNet-50 at 448x448 draw billions of values an eval). Every value must be
the int64 form's: held here bit for bit against the int64 reference, on host
and tensor keys with the high bits set, streams past 2^31, and sizes around
the int32 boundaries of the arithmetic."""
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)

from beyond_deep_ensembles_tpu_torch import keys


def _reference(key, stream, n):
    lo, hi = key & keys._M32, (key >> 32) ^ keys._mix32(stream & keys._M32)
    x = keys._mix32(torch.arange(n, dtype=torch.int64) ^ lo)
    return keys._mix32(x ^ hi)


@pytest.mark.parametrize("key", [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, keys.MASK, 123_456_789_012_345,
                                 keys.fold_in(7, 3)])
@pytest.mark.parametrize("stream", [0, 5, (1 << 31) + 11, (1 << 20) + 3])
def test_int32_bits_equal_the_int64_hash(key, stream):
    n = 70_001
    want = _reference(key, stream, n)
    for k in (key, torch.tensor(key, dtype=torch.int64)):
        got = keys.bits(k, stream, n)
        assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int(want.min()) >= 0 and int(want.max()) < 1 << 32


def test_int32_bits_cover_every_high_bit():
    """Across a large draw each of the 32 output bits and each input bit of
    the index is exercised: the masks and uniforms built on ``bits`` keep
    their values."""
    key, n = keys.fold_in(11, 2), 1 << 20
    got, want = keys.bits(key, 9, n), _reference(key, 9, n)
    assert torch.equal(got, want)
    ones = np.bitwise_or.reduce(got.numpy())
    assert ones == 0xFFFFFFFF
    u = (got >> 8).to(torch.float32) * 2.0**-24
    assert 0.49 < float(u.mean()) < 0.51


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.1, 0.2, 0.3, 1 / 3, 0.5, 0.9, 2.0**-25])
@pytest.mark.parametrize("key", [keys.fold_in(7, 3), torch.tensor(keys.MASK, dtype=torch.int64)])
def test_keep_mask_equals_the_float_comparison(key, rate):
    """``keys.keep_mask`` compares the hash's top 24 bits with an integer
    threshold on the int32 hash: the same mask as ``u >= rate`` for u the top
    24 of ``bits`` as a float (the dropout layers' and K3's plain mask)."""
    shape = (3, 5, 7, 11)
    h = keys.bits(key, 12, 3 * 5 * 7 * 11)
    want = ((h >> 8).to(torch.float32) * 2.0**-24 >= rate).reshape(shape)
    got = keys.keep_mask(key, 12, shape, rate)
    assert got.dtype == torch.bool and torch.equal(got, want)
