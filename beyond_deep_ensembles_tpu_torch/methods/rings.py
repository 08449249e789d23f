"""Storage knobs for flat posterior ring buffers, and the draw rings' push
and read.

Counterpart of ``beyond_deep_ensembles_tpu/methods/rings.py``. SWAG keeps a
``[K, D]`` deviation ring and ``[D]`` moment vectors (``methods/swag.py``);
HMC and SG-MCMC a ``[K, D]`` ring of draws, the newest last
(``methods/hmc.py``, ``methods/sgmcmc.py``; :func:`pushed`, :func:`read`):

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


def pushed(ring: torch.Tensor, row: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``ring`` rolled up by one row, ``row`` stored as its last."""
    out = torch.roll(ring, -1, 0)
    out[-1] = store(row, dtype)
    return out


def read(ring: torch.Tensor, n_samples: torch.Tensor, index, current: torch.Tensor) -> torch.Tensor:
    """Draw ``index`` counted back from the newest (modulo the ``n_samples``
    held), upcast and cut to ``current``'s length; ``current`` while the
    ring is empty."""
    n = torch.clamp(n_samples, min=1)
    slot = ring.shape[0] - 1 - (torch.as_tensor(index, device=n.device) % n)
    return torch.where(n_samples > 0, load(ring[slot])[: current.shape[0]], current)
