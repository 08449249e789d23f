"""Multi-device training: a posterior method on the (member, data) grid.

Counterpart of ``beyond_deep_ensembles_tpu/parallel/pipelines.py``. There
one jitted update runs over a sharded batch and member-sharded state, and
XLA inserts the collectives. Here every rank runs the method's own update
on its shard, inside :func:`~.mesh.use_mesh`, where the collectives sit:

  * the gradients are averaged over the data axis where each method's
    gradient meets its optimizer, by one collective over the flat gradient
    buffer (``utils/optim.py``: ``SGD``, ``Adam`` and ``Split`` steps), the
    NaN guard's predicate AND-ed over the ranks in the same collective, so
    every rank takes the same branch; the methods that reduce for
    themselves (SVGD before its Stein direction, iVON, HMC and SG-MCMC on
    their likelihood gradients) say so;
  * the KL and prior terms are the same on every rank, so the mean leaves
    them as they are;
  * the batch statistics (``nn/norm.py::channel_stats``) and SNGP's
    precision are reduced inside the forward;
  * the metrics are averaged over the data axis (one collective), then over
    the member axis, the ``*_per_member`` ones gathered, before
    :meth:`ParallelTrainer.update` returns them.

:meth:`ParallelTrainer.update` has the method's signature, so the step and
epoch runners (``parallel/multistep.py``) take it in place of
``method.update``: it is handed the whole batch (every rank walks the same
data order), cuts the rank's rows (``mesh.shard_batch``) and sets the noise
source's ``rows``, so each per-example draw is those rows of the one-device
draw.

The engines take a trainer from :func:`trainer_for`: a
:class:`ParallelTrainer` where the config's flag and a process group make a
mesh (``mesh.engine_mesh``), else a :class:`LocalTrainer` with the same
methods over the method alone. Their runners capture the trainer's update
where :attr:`capturable` (no mesh, or NCCL), and run it eagerly otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..methods.api import PosteriorMethod
from .mesh import (
    DATA_AXIS,
    MEMBER_AXIS,
    Mesh,
    all_gather,
    engine_mesh,
    gather_member_state,
    make_mesh,
    mean_of,
    replicate,
    shard_batch,
    shard_member_state,
    use_mesh,
)

_PER_MEMBER = "_per_member"


def parameter_tensors(state) -> list:
    """The live parameters and buffers of a method state's modules (its
    ``params.*`` entries, each member's in an ensemble): what every rank
    must hold alike. A ring split over ranks (``methods/rings.py``) is not
    among them."""
    return [t for k, t in state.state_dict().items()
            if isinstance(t, torch.Tensor) and (k.startswith("params.") or ".params." in k)]


class ParallelTrainer:
    """Places a state on the mesh and runs the method's update on the
    rank's shard of each batch.

    n_members: the members of an ensemble state (``deep_ensemble``), split
    over the member axis where they divide over it (1: the state is
    replicated; SVGD's particles stay whole on every rank and its update
    splits its forwards over the member axis itself)."""

    def __init__(self, method: PosteriorMethod, mesh: Optional[Mesh] = None, n_members: int = 1,
                 member_parallel: Optional[int] = None):
        self.method = method
        self.mesh = mesh if mesh is not None else make_mesh(member_parallel=member_parallel or 1)
        self.n_members = n_members
        self.full = None

    def place_state(self, state):
        """The rank's state: its parameters first made rank 0's
        (:func:`parameter_tensors`; the ranks build their states from one
        seed, so this only makes sure); an ensemble's members then cut to the
        rank's share (``mesh.shard_member_state``). The whole state is kept
        for :meth:`gather_state`."""
        replicate(self.mesh, parameter_tensors(state))
        self.full = state
        return shard_member_state(self.mesh, state, self.n_members) if self.n_members > 1 else state

    def gather_state(self, state):
        """The whole state, each member as its owner trained it (for eval and
        checkpoints); ``state`` itself when nothing was split."""
        if self.full is None or self.full is state:
            return state
        gather_member_state(self.mesh, self.full, self.n_members)
        return self.full

    def place_batch(self, batch):
        """The rank's rows of ``batch`` (``mesh.Shard``)."""
        return shard_batch(self.mesh, batch)

    def update(self, state, noise, batch):
        """``method.update`` on this rank's rows of ``batch``, under the mesh;
        the metrics reduced over the ranks."""
        shard = shard_batch(self.mesh, batch)
        if hasattr(noise, "rows"):  # a NoiseSource; a generator or given draws are whole-batch free
            noise.rows = shard.rows if shard.total != shard.batch[0].shape[0] else None
        with use_mesh(self.mesh):
            state, metrics = self.method.update(state, noise, shard.batch)
        return state, self.reduce_metrics(metrics)

    step = update

    def finalize_epoch(self, state):
        with use_mesh(self.mesh):
            return self.method.finalize_epoch(state)

    @property
    def capturable(self) -> bool:
        return self.mesh.capturable

    def predict(self, predict_batch):
        """``run(state, key, xb)``: ``predict_batch(state, key, rows, xb)``
        on this rank's rows of the eval batch ``xb`` under the mesh (the
        noise source's ``rows`` given), the per-example outputs gathered
        over the data axis, so every rank holds the whole batch's."""

        def run(state, key, xb):
            shard = shard_batch(self.mesh, (xb,))
            sharded = shard.total != shard.batch[0].shape[0]
            with use_mesh(self.mesh):
                out = predict_batch(state, key, shard.rows if sharded else None, shard.batch[0])
            return all_gather(out, DATA_AXIS, self.mesh) if sharded else out

        return run

    def reduce_metrics(self, metrics: dict) -> dict:
        """The metrics' means over the data axis, then over the member axis
        where the members are split (``*_per_member`` gathered there)."""
        names = list(metrics)
        values = [torch.as_tensor(metrics[k]) for k in names]
        values = mean_of(values, DATA_AXIS, self.mesh)
        split = self.n_members > 1 and self.mesh.size(MEMBER_AXIS) > 1 and self.n_members % self.mesh.size(
            MEMBER_AXIS) == 0
        if split:
            plain = [i for i, k in enumerate(names) if not k.endswith(_PER_MEMBER)]
            for i, v in zip(plain, mean_of([values[i] for i in plain], MEMBER_AXIS, self.mesh)):
                values[i] = v
            for i, k in enumerate(names):
                if k.endswith(_PER_MEMBER):
                    values[i] = all_gather(values[i], MEMBER_AXIS, self.mesh)
        return dict(zip(names, values))


class LocalTrainer:
    """:class:`ParallelTrainer`'s methods over one process, without a mesh:
    the method's own update and epoch end, the state as it is."""

    mesh = None
    capturable = True

    def __init__(self, method: PosteriorMethod):
        self.method = method

    def place_state(self, state):
        return state

    def gather_state(self, state):
        return state

    def update(self, state, noise, batch):
        return self.method.update(state, noise, batch)

    def finalize_epoch(self, state):
        return self.method.finalize_epoch(state)

    def predict(self, predict_batch):
        return lambda state, key, xb: predict_batch(state, key, None, xb)


def member_count(config: dict) -> int:
    """The size of an engine state's member axis (JAX's ``n_members`` in
    every engine): SVGD's particles, else the ensemble's members."""
    if config.get("model") == "svgd":
        return config.get("svgd_particles", 1)
    return config.get("members", 1)


def trainer_for(config: dict, method: PosteriorMethod):
    """The trainer of an engine run: a :class:`ParallelTrainer` over the
    (member, data) grid where ``data_parallel`` is set under a process
    group, else a :class:`LocalTrainer` (``mesh.engine_mesh``, which raises
    for a flagged run with several visible cards and no group)."""
    n_members = member_count(config)
    mesh = engine_mesh(config, "data_parallel", n_members)
    return LocalTrainer(method) if mesh is None else ParallelTrainer(method, mesh, n_members=n_members)
