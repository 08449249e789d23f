"""Storage knobs for flat posterior ring buffers.

Counterpart of ``beyond_deep_ensembles_tpu/methods/rings.py``. SWAG keeps a
``[K, D]`` deviation ring and ``[D]`` moment vectors (``methods/swag.py``):

* ``ring_dtype`` (default fp32): the ring may be stored in bf16 to halve
  its memory; rows are upcast on read (:func:`load`) and SWAG's ``z1 @
  deviations`` contraction runs in fp32;
* ``ring_sharding``: the JAX package shards D over a mesh axis. The port is
  one device so far (ROADMAP item 18), so any sharding raises.
"""
from __future__ import annotations

import torch


def refuse_sharding(sharding) -> None:
    if sharding is not None:
        raise NotImplementedError("ring_sharding (a ring split over devices): not ported yet")


def pad_flat(flat: torch.Tensor, sharding=None) -> torch.Tensor:
    """A flat vector padded for ``sharding`` (never padded on one device)."""
    refuse_sharding(sharding)
    return flat


def store(arr: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Downcast for ring storage (no copy at fp32)."""
    return arr.to(dtype)


def load(arr: torch.Tensor) -> torch.Tensor:
    """Upcast a ring row back to fp32 compute precision."""
    return arr.to(torch.float32)
