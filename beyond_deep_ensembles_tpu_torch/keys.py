"""Random keys that a CUDA graph can replay: the port's counterpart of the
``jax.random`` keys of ``parallel/multistep.py`` and the experiment loops.

A key is an integer in [0, 2^62): a Python int on the host (a run's seed,
folded with an epoch or a step), or a 0-dim int64 tensor on the device
inside a step, where a captured graph reads it from memory at every replay.

  * :func:`fold_in` derives a key from a key and an integer, as
    ``jax.random.fold_in`` does: on host ints, or on a device key inside a
    step (an ensemble's member keys, ``methods/ensemble.py``);
  * :func:`advance` steps a key to the next, on ints and on tensors alike
    (a 62-bit xorshift: a bijection, so distinct keys stay distinct); a
    runner advances its device key once per step, inside the graph, where
    ``make_multi_step`` splits its key into one per step;
  * :func:`bits` gives ``n`` 32-bit values as a function of (key, stream,
    index) alone, by a counter hash in plain integer tensor ops, so the
    same draw comes out eagerly and in a replay, on the CPU and on a card;
    :func:`normal` is built on it.

The Gaussian noise of the BBB layers does not come from here: K1 draws it
in-kernel by Philox, from the key plus a draw index (``ops/sampling.py``).
"""
from __future__ import annotations

import math
import struct
from typing import Union

import torch

MASK = (1 << 62) - 1
_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B  # the 32-bit integer hash's multiplier (below 2^27: no int64 overflow)

Key = Union[int, torch.Tensor]


def advance(key: Key) -> Key:
    """The next key: xorshift (13, 7, 17) on 62 bits, each left shift masked
    first, so a tensor's int64 never overflows."""
    key = key ^ ((key & (MASK >> 13)) << 13)
    key = key ^ (key >> 7)
    return key ^ ((key & (MASK >> 17)) << 17)


def fold_in(key: Key, data: int) -> Key:
    """A key derived from ``key`` and ``data`` in [0, 2^32) (an epoch, a
    step, a batch index, a member): a host int from a host int, a new
    device tensor from a 0-dim int64 tensor (computed on the device, so a
    captured graph derives it afresh from the key it reads)."""
    if not 0 <= data <= _M32 or (not isinstance(key, torch.Tensor) and not 0 <= key <= MASK):
        raise ValueError(f"fold_in takes a key in [0, 2^62) and data in [0, 2^32), got {key}, {data}")
    return advance(advance(key ^ (_mix32(data) << 30)))


def as_key(key: int, device) -> torch.Tensor:
    """The host key ``key`` as a 0-dim int64 tensor on ``device``, written by
    a fill, which does not wait for the device."""
    if not 0 <= key <= MASK:
        raise ValueError(f"a key lies in [0, 2^62), got {key}")
    return torch.full((), key, dtype=torch.int64, device=device)


def _mix32(x: Key) -> Key:
    """The 32-bit integer hash (two multiply-xorshift rounds) on ints, or
    int64 tensors, in [0, 2^32): a bijection of 32-bit values."""
    x = ((x >> 16) ^ x) * _MIX & _M32
    x = ((x >> 16) ^ x) * _MIX & _M32
    return (x >> 16) ^ x


def _as_int32(v: Key) -> Key:
    """A value in [0, 2^32) as the int32 that holds its 32 bits."""
    v = ((v & _M32) ^ (1 << 31)) - (1 << 31)
    return v.to(torch.int32) if isinstance(v, torch.Tensor) else v


def _mix32_int32(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32` on int32 tensors holding 32-bit values: the shifts made
    logical by a mask, the products wrapping at 2^32 (the int64 form's ``&
    _M32``), so every bit is the int64 form's, at half its memory traffic."""
    x = (((x >> 16) & 0xFFFF) ^ x) * _MIX
    x = (((x >> 16) & 0xFFFF) ^ x) * _MIX
    return ((x >> 16) & 0xFFFF) ^ x


def _bits_int32(key: Key, stream: int, n: int, device=None, offset: int = 0) -> torch.Tensor:
    """:func:`bits` for ``offset + n`` < 2^31, as the int32 tensor holding
    each value's 32 bits."""
    if isinstance(key, torch.Tensor):
        device = key.device
    lo, hi = key & _M32, (key >> 32) ^ _mix32(stream & _M32)
    x = _mix32_int32(torch.arange(offset, offset + n, dtype=torch.int32, device=device) ^ _as_int32(lo))
    return _mix32_int32(x ^ _as_int32(hi))


def bits(key: Key, stream: int, n: int, device=None, offset: int = 0) -> torch.Tensor:
    """``n`` values in [0, 2^32) (int64), value i a function of (key,
    ``stream``, ``offset + i``) alone, ``offset + i`` < 2^32: ``mix(mix(j ^
    key_lo) ^ key_hi ^ mix(stream))`` at j = ``offset + i``, so the values at
    an offset are those elements of the draw from 0 (a data-parallel rank's
    rows of a whole batch's draw). For a fixed key and stream the map from j
    is a bijection, so the values are distinct. ``key``: a host int or a
    0-dim int64 tensor (whose device the values take). Below 2^31 the hash
    runs on int32 tensors (the same bits)."""
    if offset + n < 1 << 31:
        return _bits_int32(key, stream, n, device, offset).to(torch.int64) & _M32
    if isinstance(key, torch.Tensor):
        device = key.device
    lo, hi = key & _M32, (key >> 32) ^ _mix32(stream & _M32)
    x = _mix32(torch.arange(offset, offset + n, dtype=torch.int64, device=device) ^ lo)
    return _mix32(x ^ hi)


def keep_mask(key: Key, stream: int, shape, rate: float, device=None, offset: int = 0) -> torch.Tensor:
    """A dropout keep mask of ``shape`` (bool): ``u >= rate`` for u the top
    24 of :func:`bits` as a float in [0, 1), ``(h >> 8) * 2^-24``, against
    ``rate`` rounded to fp32 (as a tensor compares with a Python float).
    Taken as the integer comparison ``h >> 8 >= ceil(fp32(rate) 2^24)``,
    exact and the same mask, on the int32 hash (the int64 and float passes
    were most of a mask's memory traffic after the hash). At element
    ``offset`` the mask is those elements of the mask from 0 (:func:`bits`)."""
    n = math.prod(shape)
    threshold = math.ceil(struct.unpack("f", struct.pack("f", rate))[0] * 2**24)
    if offset + n < 1 << 31:
        top = (_bits_int32(key, stream, n, device, offset) >> 8) & 0xFFFFFF
    else:
        top = bits(key, stream, n, device, offset) >> 8
    return (top >= threshold).reshape(tuple(shape))


def normal(key: Key, stream: int, n: int, device=None) -> torch.Tensor:
    """``n`` fp32 standard normals by Box-Muller over pairs of 24-bit
    uniforms from :func:`bits` (the first taken in (0, 1]): values [0, m) are
    r cos(theta), [m, 2m) r sin(theta), of the m = ceil(n / 2) pairs."""
    m = -(-n // 2)
    u = ((bits(key, stream, 2 * m, device) >> 8).to(torch.float32) * 2.0**-24).reshape(2, m)
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[0]))
    theta = (2.0 * torch.pi) * u[1]
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)])[:n]
