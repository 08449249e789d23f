"""Storage knobs for flat posterior ring buffers, and the draw rings' push
and read.

Counterpart of ``beyond_deep_ensembles_tpu/methods/rings.py``. SWAG keeps a
``[K, D]`` deviation ring and ``[D]`` moment vectors (``methods/swag.py``);
HMC and SG-MCMC a ``[K, D]`` ring of draws, the newest last
(``methods/hmc.py``, ``methods/sgmcmc.py``; :func:`pushed`, :func:`read`):

* ``ring_dtype`` (default fp32): the ring may be stored in bf16 to halve
  its memory; rows are upcast on read (:func:`load`) and SWAG's ``z1 @
  deviations`` contraction runs in fp32;
* ``ring_sharding`` (a :class:`RingSharding`, or None): the flat dimension D
  split over the data axis of a mesh (``parallel/mesh.py``), as JAX's
  ``NamedSharding(mesh, P(None, "data"))``: D is padded with zeros to a
  multiple of the axis size N (:func:`padded_width`, :func:`pad_flat`) and
  each rank stores its ``[K, D/N]`` columns (:func:`shard`) in the ring's
  dtype; a row is gathered (:func:`gather`) only where it is unraveled
  into parameters. The parameters themselves stay whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import mesh as _mesh


class RingSharding(NamedTuple):
    """D split over the data axis of ``mesh``."""

    mesh: "_mesh.Mesh"

    @property
    def size(self) -> int:
        return self.mesh.size(_mesh.DATA_AXIS)

    @property
    def index(self) -> int:
        return self.mesh.coordinate(_mesh.DATA_AXIS)


def check(sharding) -> None:
    """Raises unless ``sharding`` is None or a :class:`RingSharding`."""
    if sharding is not None and not isinstance(sharding, RingSharding):
        raise TypeError(f"ring_sharding is a rings.RingSharding over a mesh's data axis (parallel/mesh.py) or None, "
                        f"got {type(sharding).__name__}")


def padded_width(d: int, sharding: Optional[RingSharding]) -> int:
    """D rounded up to a multiple of the sharding axis (D without one)."""
    n = 1 if sharding is None else sharding.size
    return -(-d // n) * n


def pad_flat(flat: torch.Tensor, sharding: Optional[RingSharding] = None) -> torch.Tensor:
    """A flat vector padded with zeros for ``sharding`` (itself without
    one, or where D divides)."""
    pad = padded_width(flat.shape[0], sharding) - flat.shape[0]
    return flat if pad == 0 else torch.cat([flat, flat.new_zeros(pad)])


def shard(flat: torch.Tensor, sharding: Optional[RingSharding] = None) -> torch.Tensor:
    """This rank's columns of the padded ``flat`` (``flat`` without a
    sharding)."""
    if sharding is None:
        return flat
    flat = pad_flat(flat, sharding)
    width = flat.shape[0] // sharding.size
    return flat[sharding.index * width : (sharding.index + 1) * width]


def gather(part: torch.Tensor, sharding: Optional[RingSharding] = None) -> torch.Tensor:
    """The padded flat vector whose columns the ranks hold (``part``
    without a sharding)."""
    if sharding is None:
        return part
    return _mesh.all_gather(part, _mesh.DATA_AXIS, sharding.mesh)


def store(arr: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Downcast for ring storage (no copy at fp32)."""
    return arr.to(dtype)


def load(arr: torch.Tensor) -> torch.Tensor:
    """Upcast a ring row back to fp32 compute precision."""
    return arr.to(torch.float32)


def pushed(ring: torch.Tensor, row: torch.Tensor, dtype: torch.dtype,
           sharding: Optional[RingSharding] = None) -> torch.Tensor:
    """``ring`` rolled up by one row, ``row`` (whole) stored as its last, this
    rank's columns of it under ``sharding``."""
    out = torch.roll(ring, -1, 0)
    out[-1] = store(shard(row, sharding), dtype)
    return out


def read(ring: torch.Tensor, n_samples: torch.Tensor, index, current: torch.Tensor,
         sharding: Optional[RingSharding] = None) -> torch.Tensor:
    """Draw ``index`` counted back from the newest (modulo the ``n_samples``
    held), gathered under ``sharding``, upcast and cut to ``current``'s
    length; ``current`` while the ring is empty."""
    n = torch.clamp(n_samples, min=1)
    slot = ring.shape[0] - 1 - (torch.as_tensor(index, device=n.device) % n)
    row = gather(load(ring[slot]), sharding)
    return torch.where(n_samples > 0, row[: current.shape[0]], current)
