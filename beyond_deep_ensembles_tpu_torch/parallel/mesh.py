"""The (member, data) grid of ranks, on ``torch.distributed``.

Counterpart of ``beyond_deep_ensembles_tpu/parallel/mesh.py``. The JAX
package is one controller over a ``jax.sharding.Mesh``: GSPMD keeps the
arithmetic of the one-device program and inserts the collectives. The port
is one process per rank (launched by ``torchrun``), each computing its
shard, so everything the one-device program computes over a whole batch is
made global here by hand:

  * ``data`` axis: a batch's rows are split over the ranks of a data group
    (:func:`shard_batch`); gradients, metrics and batch statistics are
    averaged over it (:func:`all_reduce_mean`), every per-example draw is
    the rank's rows of the whole batch's draw (``NoiseSource.rows``);
  * ``member`` axis: ensemble members and SVGD particles are split over the
    ranks of a member group (:func:`shard_member_state`) and gathered where
    they meet (:func:`all_gather`).

Rank r sits at member row ``r // data_size`` and data column ``r %
data_size`` (JAX's ``reshape(member, data)`` of the device list). Every
collective here carries autograd (the batch norms' statistics are reduced
inside the forward): the gradient of a mean over ranks is the mean of the
gradients, of a gather the rank's rows of the summed gradient. That is the
gradient of the ranks' mean loss once the parameters' gradients are
averaged, as :class:`~.pipelines.ParallelTrainer` does.

Backends: NCCL between cards, gloo on the CPU. A gloo group handed card
tensors stages each collective through host memory, explicitly and only in
this module (:func:`_collective`). A gloo collective cannot be captured in
a CUDA graph (``parallel/multistep.py`` raises).

Where a batch does not divide over the data axis, :func:`shard_batch`
replicates it, as the JAX engines do (JAX ``wilds_task.py:725-734``): every
rank then computes the whole batch, and the means over ranks give the
one-device values.

Without a process group the engines' flags are no-ops (:func:`engine_mesh`
returns None), as in JAX on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MEMBER_AXIS = "member"
TORCHRUN = "python -m torch.distributed.run --nproc-per-node N -m beyond_deep_ensembles_tpu_torch.run <task> <yaml>"


def is_distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def init_distributed(device=None, backend: Optional[str] = None, timeout_s: float = 600.0) -> bool:
    """Joins the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment):
    NCCL for a card, gloo for the CPU, unless ``backend`` names one. Returns
    whether a group exists (False outside ``torchrun``, where nothing is
    done)."""
    if is_distributed():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "nccl" if device is not None and torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def close_distributed() -> None:
    """Leaves the process group (and forgets its meshes)."""
    if is_distributed():
        dist.destroy_process_group()
    _MESHES.clear()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_first_rank() -> bool:
    """Rank 0, or the only process: the one that writes records and
    checkpoints."""
    return rank() == 0


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (member, data) grid over the group's ranks: this rank's
    coordinates, and the member and data subgroups it belongs to."""

    member_size: int
    data_size: int
    rank: int
    backend: str
    groups: Dict[str, object]
    ranks: Dict[str, Tuple[int, ...]]

    @property
    def shape(self) -> dict:
        return {MEMBER_AXIS: self.member_size, DATA_AXIS: self.data_size}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.rank // self.data_size if axis == MEMBER_AXIS else self.rank % self.data_size

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives (NCCL's;
        gloo's run on the host)."""
        return self.backend == "nccl"


_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(n_devices: Optional[int] = None, member_parallel: int = 1) -> Mesh:
    """The (member, data) grid over every rank of the process group, with
    JAX's divisibility rule and error. Every rank must call it, in the same
    order (its subgroups are made collectively); a second call with the
    same ``member_parallel`` returns the first's mesh."""
    if not is_distributed():
        raise RuntimeError(f"make_mesh needs a process group: launch under torchrun ({TORCHRUN})")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: the port's mesh spans every rank of the group ({n}), not {n_devices}")
    if n % member_parallel != 0:
        raise ValueError(
            f"make_mesh: {n} rank(s) not divisible by member_parallel={member_parallel}. Either pass a "
            f"divisor of {n}, or launch more ranks (torchrun --nproc-per-node)."
        )
    cache_key = (id(dist.group.WORLD), member_parallel)
    cached = _MESHES.get(cache_key)
    if cached is not None:
        return cached
    data_size = n // member_parallel
    me = dist.get_rank()
    groups, ranks = {}, {}
    for m in range(member_parallel):  # every rank makes every group, in one order
        row = tuple(m * data_size + d for d in range(data_size))
        group = dist.new_group(list(row))
        if me in row:
            groups[DATA_AXIS], ranks[DATA_AXIS] = group, row
    for d in range(data_size):
        column = tuple(m * data_size + d for m in range(member_parallel))
        group = dist.new_group(list(column))
        if me in column:
            groups[MEMBER_AXIS], ranks[MEMBER_AXIS] = group, column
    mesh = Mesh(member_parallel, data_size, me, dist.get_backend(), groups, ranks)
    _MESHES[cache_key] = mesh
    return mesh


def member_axis_size(mesh_size: int, n_members: int) -> int:
    """JAX's rule for the member axis: the members split over the ranks when
    their number divides the ranks' (``mp = members if world % members ==
    0 else 1``)."""
    return n_members if n_members > 1 and mesh_size % n_members == 0 else 1


def check_flags(config: dict, flags=("data_parallel", "ring_shard")) -> None:
    """Raises, naming the ``torchrun`` line, for a run whose config sets one
    of ``flags`` with several visible cards and no process group: such a run
    never falls back to one card silently. The engines call it before any
    work is done."""
    if is_distributed() or torch.cuda.device_count() <= 1:
        return
    for flag in flags:
        if config.get(flag):
            raise RuntimeError(
                f"{flag} with {torch.cuda.device_count()} visible cards and no process group: launch the run "
                f"under torchrun ({TORCHRUN}), or make one card visible (CUDA_VISIBLE_DEVICES)"
            )


def engine_mesh(config: dict, flag: str, n_members: int = 1) -> Optional[Mesh]:
    """The mesh of an engine run whose config sets ``flag``
    (``data_parallel``, ``ring_shard``): the (member, data) grid under a
    process group, even of one rank; None without the flag or the group,
    where the flag is a no-op as in JAX on one device (:func:`check_flags`
    raises with several visible cards)."""
    if not config.get(flag):
        return None
    check_flags(config, (flag,))
    if not is_distributed():
        return None
    return make_mesh(member_parallel=member_axis_size(dist.get_world_size(), n_members))


# --- the active mesh (JAX's ``jax.set_mesh``) ------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Within the block the collectives of the batch norms, optimizers and
    methods act over ``mesh`` (None: they are the identity)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active() -> Optional[Mesh]:
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


# --- collectives ------------------------------------------------------------


def _collective(mesh: Mesh, fn, t: torch.Tensor, *args) -> torch.Tensor:
    """Runs ``fn(tensor, *args)`` in place over ``mesh``'s backend and
    returns the tensor it wrote: gloo is handed a host copy of a card
    tensor, NCCL a card copy of a host tensor (a checkpoint's counters), each
    written back to the tensor's device after; else the tensor itself."""
    t = t.contiguous()
    if t.is_cuda and mesh.backend == "gloo":
        host = t.cpu()
        fn(host, *args)
        return host.to(t.device)
    if not t.is_cuda and mesh.backend == "nccl":
        card = t.to(torch.device("cuda", torch.cuda.current_device()))
        fn(card, *args)
        return card.cpu()
    fn(t, *args)
    return t


def _broadcast(mesh: Mesh, t: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor holding rank ``src``'s ``t``, on ``t``'s device."""
    return _collective(mesh, lambda x: dist.broadcast(x, src, group=group), t.detach().clone())


def _reduce_sum(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    out = t.detach().clone()
    return _collective(mesh, lambda x: dist.all_reduce(x, group=mesh.groups[axis]), out)


def _gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """``[size * n, ...]``: the ranks' ``[n, ...]`` along ``axis``, in their
    order."""
    size = mesh.size(axis)
    t = t.detach().contiguous()
    out = torch.empty((size,) + tuple(t.shape), dtype=t.dtype, device=t.device)

    def gather(buf, src):
        dist.all_gather(list(buf.unbind(0)), src, group=mesh.groups[axis])

    if t.is_cuda and mesh.backend == "gloo":
        host = out.cpu()
        gather(host, t.cpu())
        out = host.to(t.device)
    else:
        gather(out, t)
    return out.reshape((size * t.shape[0],) + tuple(t.shape[1:])) if t.dim() else out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        ctx.mesh, ctx.axis, ctx.mean = mesh, axis, mean
        out = _reduce_sum(mesh, axis, x)
        return out / mesh.size(axis) if mean else out

    @staticmethod
    def backward(ctx, g):
        out = _reduce_sum(ctx.mesh, ctx.axis, g)
        return (out / ctx.mesh.size(ctx.axis) if ctx.mean else out), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, x.shape[0]
        return _gather(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        summed = _reduce_sum(ctx.mesh, ctx.axis, g)
        start = ctx.mesh.coordinate(ctx.axis) * ctx.n
        return summed[start : start + ctx.n], None, None


def _mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    return active() if mesh is None else mesh


def all_reduce_sum(t: torch.Tensor, axis: str = DATA_AXIS, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis`` (differentiable); ``t``
    itself without a mesh."""
    mesh = _mesh(mesh)
    return t if mesh is None else _AllReduce.apply(t, mesh, axis, False)


def all_reduce_mean(t: torch.Tensor, axis: str = DATA_AXIS, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis``, the sum divided by
    their number (differentiable); ``t`` itself without a mesh."""
    mesh = _mesh(mesh)
    return t if mesh is None else _AllReduce.apply(t, mesh, axis, True)


def all_gather(t: torch.Tensor, axis: str = MEMBER_AXIS, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The ranks' ``t`` ``[n, ...]`` along ``axis`` joined along dim 0, in
    rank order (differentiable); ``t`` itself without a mesh."""
    mesh = _mesh(mesh)
    return t if mesh is None else _AllGather.apply(t, mesh, axis)


def mean_of(tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS, mesh: Optional[Mesh] = None) -> list:
    """Each of ``tensors`` averaged over ``axis`` by ONE collective over
    their concatenation (a flat gradient buffer and its loss, say); bool
    tensors come back as their AND over the ranks. Without a mesh, the
    tensors themselves."""
    mesh = _mesh(mesh)
    if mesh is None:
        return list(tensors)
    dtype = torch.promote_types(tensors[0].dtype, torch.float32)
    flat = torch.cat([(~t).to(dtype).reshape(-1) if t.dtype == torch.bool else t.to(dtype).reshape(-1)
                      for t in tensors])
    summed = _reduce_sum(mesh, axis, flat)
    out, start = [], 0
    for t in tensors:
        part = summed[start : start + t.numel()].reshape(t.shape)
        start += t.numel()
        out.append(part == 0 if t.dtype == torch.bool else (part / mesh.size(axis)).to(t.dtype))
    return out


# --- placement ----------------------------------------------------------------


@torch.no_grad()
def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: Optional[str] = None) -> None:
    """Broadcasts ``tensors`` in place from the first rank of ``axis`` (of
    the whole group where None), so every rank holds the same values."""
    group = None if axis is None else mesh.groups[axis]
    src = 0 if axis is None else mesh.ranks[axis][0]
    for t in tensors:
        if t.numel():
            t.copy_(_broadcast(mesh, t, src, group))


@dataclasses.dataclass
class Shard:
    """A rank's rows ``[offset, offset + n)`` of a batch of ``total``; a
    replicated batch has ``offset`` 0 and ``n == total``."""

    batch: tuple
    offset: int
    total: int

    @property
    def rows(self) -> Tuple[int, int]:
        return self.offset, self.total


def shard_batch(mesh: Mesh, batch: Sequence[torch.Tensor]) -> Shard:
    """This rank's rows of the data axis of ``batch`` (tensors with one
    leading batch axis), and their offset; the whole batch where its rows
    do not divide over the axis."""
    total = batch[0].shape[0]
    size = mesh.size(DATA_AXIS)
    if total % size:
        return Shard(tuple(batch), 0, total)
    n = total // size
    offset = mesh.coordinate(DATA_AXIS) * n
    return Shard(tuple(t[offset : offset + n] for t in batch), offset, total)


def member_range(mesh: Mesh, n_members: int) -> range:
    """The members this rank updates: its contiguous share of the member
    axis where ``n_members`` divides over it, else all."""
    size = mesh.size(MEMBER_AXIS)
    if n_members % size:
        return range(n_members)
    per = n_members // size
    start = mesh.coordinate(MEMBER_AXIS) * per
    return range(start, start + per)


def broadcast_member_buffers(mesh: Mesh, modules, n_members: int) -> None:
    """Each of ``modules``' buffers (a running-statistics norm's ``mean``
    and ``var``) made the one its owner on the member axis stepped (in
    place): SVGD's particles are whole on every rank, but only the owner's
    forwards step a particle's statistics."""
    size = mesh.size(MEMBER_AXIS)
    if size == 1 or n_members % size:
        return
    per = n_members // size
    group, column = mesh.groups[MEMBER_AXIS], mesh.ranks[MEMBER_AXIS]
    with torch.no_grad():
        for m, module in enumerate(modules):
            for t in module.buffers():
                t.copy_(_broadcast(mesh, t, column[m // per], group))


def shard_member_state(mesh: Mesh, state, n_members: int):
    """An ensemble state (``methods/ensemble.py::EnsembleState``) holding
    this rank's members of ``state``'s (the same member states, not
    copies), its first member's index recorded; ``state`` itself where the
    members do not divide over the member axis or it is no ensemble (SVGD's
    particles stay whole on every rank: their method splits its forwards,
    ``methods/svgd.py``)."""
    members = getattr(state, "members", None)
    if members is None or len(members) != n_members:
        return state
    own = member_range(mesh, n_members)
    return type(state)(members=[members[i] for i in own], first=own.start)


def gather_member_state(mesh: Mesh, full, n_members: int) -> None:
    """Every member of the ensemble state ``full`` made the one its owner
    trained: each member's tensors broadcast from the first rank of the
    member axis that holds it (in place; the member objects ``full`` shares
    with a :func:`shard_member_state` are the owners')."""
    members = getattr(full, "members", None)
    size = mesh.size(MEMBER_AXIS)
    if members is None or size == 1 or n_members % size:
        return
    per = n_members // size
    group, column = mesh.groups[MEMBER_AXIS], mesh.ranks[MEMBER_AXIS]
    for m, member in enumerate(members):
        src = column[m // per]
        member.load_state_dict({k: _broadcast(mesh, t, src, group) for k, t in member.state_dict().items()})
