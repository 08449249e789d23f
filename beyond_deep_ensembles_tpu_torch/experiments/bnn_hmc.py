"""Full-batch HMC / SG-MCMC / MFVI / SGD experiment entries (the
google-bnn-hmc subtree).

Counterpart of ``beyond_deep_ensembles_tpu/experiments/bnn_hmc.py``
(reference bnn_hmc/run_hmc.py, run_sgmcmc.py, run_sgd.py, run_vi.py), with
its arguments and return values. ``model`` is the port's ``Model`` (e.g.
``models/zoo.py::get_model``): its module's weights, drawn from the
caller's generator, are the initial point, or ``init_params`` (a state
dict, e.g. ``models/jax_convert.py``'s) replaces them; each entry runs a
copy on its device, so the caller's module is left as it was. The arrays
come in the JAX package's layout (images NHWC, tokens ``[N, T]``) and move
to the device once, images as NCHW.

Randomness: the draws of iteration (HMC) or step (the minibatch entries)
``it`` come from a ``torch.Generator`` on the device seeded with
``keys.fold_in(seed + 2, it)`` (:func:`iteration_noise`), as JAX keys them
by ``fold_in(key(seed + 2), it)``, so a resumed chain draws what an
uninterrupted one draws. The minibatch order is numpy's
``RandomState(seed).permutation`` an epoch, the last partial batch dropped,
as in JAX.

Under a process group (``torchrun``), or with a ``mesh`` given, the entries
run as JAX's do over its mesh (JAX :86-116): each (full or mini) batch's
rows split over the data axis, the chain's state replicated (broadcast from
rank 0), the likelihood and its gradient reduced over the axis
(``parallel/pipelines.py``), so every rank takes the same accept decision;
the test predictions are made whole on every rank. Without a group the
batch stays whole on one device. The predictive running average over
accepted draws (reference ensemble_utils.py:19-53) stays on the device.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import keys
from ..evals.classification import EvalResult, analyze_output
from ..methods.api import LossOutput
from ..methods.hmc import hmc_method
from ..methods.map import map_method
from ..methods.sgmcmc import sgmcmc_method
from ..methods.vi import mfvi_method
from ..nn.base import Model
from ..parallel import mesh as _mesh
from ..parallel.pipelines import LocalTrainer, ParallelTrainer
from ..tree import sorted_named
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.logging import VoidLog
from ..utils.optim import SGD, Adam
from ..utils.schedules import cosine_decay_schedule


def xent_loss_fn(model: Model):
    def loss_fn(params, model_state, noise, batch):
        x, y = batch
        out, kl, new_state = model.apply(params, model_state, noise, x, train=True)
        logp = F.log_softmax(out, dim=-1)
        loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
        return LossOutput(loss=loss, kl=kl, model_state=new_state)

    return loss_fn


@dataclasses.dataclass
class PredictiveAverage:
    """Running average of predictive probabilities over accepted samples
    (reference ensemble_utils.py:24-35)."""

    probs: torch.Tensor = None
    count: int = 0

    def update(self, new_probs: torch.Tensor):
        if self.probs is None:
            self.probs = new_probs
            self.count = 1
        else:
            self.count += 1
            self.probs = self.probs + (new_probs - self.probs) / self.count
        return self


def iteration_noise(seed: int, it: int, device) -> torch.Generator:
    """The generator of iteration (or step) ``it``'s draws: a function of
    ``(seed, it)`` alone."""
    return torch.Generator(device=device).manual_seed(keys.fold_in(seed + 2, it))


def _setup(model: Model, init_params, device):
    """(device, a copy of the model on it holding the initial point)."""
    device = resolve_device(device)
    module = copy.deepcopy(model.module).to(device)
    if init_params is not None:
        # warm start / transplant (reference --init_checkpoint)
        module.load_state_dict(init_params, strict=True)
    return device, Model(module)


def _trainer(method, mesh=None):
    """The entry's steps: over ``mesh``, or under a process group over
    ``make_mesh(member_parallel=1)`` (JAX :86-87), a ``ParallelTrainer``
    (the batch's rows split over the data axis); else the method alone."""
    if mesh is not None and not isinstance(mesh, _mesh.Mesh):
        raise TypeError(f"mesh is a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if mesh is None and _mesh.is_distributed():
        mesh = _mesh.make_mesh(member_parallel=1)
    return LocalTrainer(method) if mesh is None else ParallelTrainer(method, mesh)


def _to_device(arrays, device):
    """Arrays in the JAX layout (images NHWC) -> tensors on ``device``
    (images NCHW, ids and labels int64); tensors are taken as they are."""
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(a.to(device))
            continue
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if a.ndim == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        if not a.dtype.kind == "f":
            t = t.to(torch.int64)
        out.append(t.to(device))
    return tuple(out)


def _ring_kw(ring_dtype, ring_sharding) -> dict:
    out = {}
    if ring_dtype is not None:
        out["ring_dtype"] = ring_dtype
    if ring_sharding is not None:
        out["ring_sharding"] = ring_sharding
    return out


def run_hmc(
    model: Model,
    train_batch,
    test_batch,
    n_iterations: int = 100,
    burn_in: int = 10,
    step_size: float = 1e-5,
    n_leapfrog: int = 50,
    prior_std: float = 1.0,
    target_accept_rate: float = 0.8,
    step_size_adaptation_speed: float = 0.05,
    seed: int = 0,
    run_dir: Optional[str] = None,
    init_params=None,
    log=None,
    mesh=None,
    ring_dtype=None,
    ring_sharding=None,
    device=None,
) -> dict:
    """One HMC chain (reference run_hmc.py:134-191): the step size adapts
    in every iteration (the JAX loop passes no burn-in switch to the
    method); after ``burn_in`` iterations each accepted draw's test
    predictive joins a running average. With ``run_dir`` a checkpoint is
    written after every iteration and a run resumes from the latest. Returns
    ``{"metrics": [one dict an iteration run], "state": HmcState}`` and, when
    a draw was averaged, ``"eval"`` (the averaged predictive's
    ``EvalResult.as_dict()``) and ``"predictive"`` (its probabilities,
    numpy)."""
    log = log or VoidLog()
    device, model = _setup(model, init_params, device)
    train = _to_device(train_batch, device)
    x_test, y_test = _to_device(test_batch, device)
    method = hmc_method(
        xent_loss_fn(model),
        dataset_size=train[0].shape[0],
        step_size=step_size,
        n_leapfrog=n_leapfrog,
        prior_std=prior_std,
        target_accept_rate=target_accept_rate,
        step_size_adaptation_speed=step_size_adaptation_speed,
        **_ring_kw(ring_dtype, ring_sharding),
    )
    state = method.init(model.module, {})
    trainer = _trainer(method, mesh)
    per_rank = ring_sharding is not None

    def test_predict(params):
        with torch.no_grad():
            out, _, _ = model.apply(params, state.model_state, None, x_test, train=False)
            return F.softmax(out, dim=-1)

    start_iter = 0
    if run_dir:
        state, resumed = ckpt.restore_checkpoint(run_dir, state, per_rank=per_rank)
        if resumed is not None:
            start_iter = resumed + 1
            log.info(f"resumed from iteration {resumed}")
    state = trainer.place_state(state)

    ensemble = PredictiveAverage()
    metrics_hist = []
    for it in range(start_iter, n_iterations):
        state, metrics = trainer.update(state, iteration_noise(seed, it, device), train)
        m = {k: float(v) for k, v in metrics.items()}
        if it >= burn_in and m["accepted"]:
            ensemble.update(test_predict(state.params))
        metrics_hist.append(m)
        log.info(f"iter {it}: accept_prob {m['accept_prob']:.3f} "
                 f"step_size {m['step_size']:.2e} loglik {m['log_likelihood']:.1f}")
        if run_dir:
            ckpt.save_checkpoint(run_dir, it, state, per_rank=per_rank)

    result = {"metrics": metrics_hist, "state": state}
    if ensemble.probs is not None:
        log_marg = torch.log(torch.clamp(ensemble.probs, min=1e-38))
        correct, conf, ll, _, _ = analyze_output(log_marg, y_test)
        result["eval"] = EvalResult.create(correct, conf, ll).as_dict()
        result["predictive"] = ensemble.probs.cpu().numpy()
    return result


def _batches(rng: np.random.RandomState, n_data: int, batch_size: int, n: Optional[int] = None):
    """One epoch's batches of indices: the first ``n`` of a permutation
    (default the whole batches' worth, the last partial batch dropped), in
    batches of ``batch_size``."""
    n = (n_data // batch_size) * batch_size if n is None else n
    order = rng.permutation(n_data)[:n]
    return [order[start : start + batch_size] for start in range(0, n, batch_size)]


def _batch(data, sel: np.ndarray):
    idx = torch.from_numpy(sel).to(data[0].device)
    return tuple(a[idx] for a in data)


def run_sgmcmc(
    model: Model,
    train_arrays,
    n_epochs: int = 10,
    batch_size: int = 128,
    step_size: float = 1e-6,
    momentum_decay: float = 0.9,
    temperature: float = 1.0,
    prior_std: float = 1.0,
    preconditioner: Optional[str] = None,
    sample_interval: int = 100,
    seed: int = 0,
    init_params=None,
    log=None,
    ring_dtype=None,
    ring_sharding=None,
    device=None,
):
    """SGLD / SGHMC training loop (reference run_sgmcmc.py); returns
    ``(method, state)``."""
    log = log or VoidLog()
    device, model = _setup(model, init_params, device)
    data = _to_device(train_arrays, device)
    method = sgmcmc_method(
        xent_loss_fn(model),
        dataset_size=data[0].shape[0],
        step_size_fn=step_size,
        momentum_decay=momentum_decay,
        temperature=temperature,
        prior_std=prior_std,
        preconditioner=preconditioner,
        sample_interval=sample_interval,
        **_ring_kw(ring_dtype, ring_sharding),
    )
    trainer = _trainer(method)
    state = trainer.place_state(method.init(model.module, {}))
    rng = np.random.RandomState(seed)
    step = 0
    for epoch in range(n_epochs):
        for sel in _batches(rng, data[0].shape[0], batch_size):
            step += 1
            state, metrics = trainer.update(state, iteration_noise(seed, step, device), _batch(data, sel))
        log.info(f"epoch {epoch}: loss {float(metrics['loss']):.4f}")
    return method, state


def run_sgd(
    model: Model,
    train_arrays,
    n_epochs: int = 10,
    batch_size: int = 128,
    lr: float = 1e-2,
    momentum: float = 0.9,
    prior_std: float = 1.0,
    schedule: str = "cosine",
    seed: int = 0,
    run_dir: Optional[str] = None,
    init_params=None,
    log=None,
    device=None,
):
    """MAP / SGD training (reference run_sgd.py), the baseline that seeds
    deep ensembles: the Gaussian log-prior folded into the loss (scaled by
    1/N), optax's cosine decay over the run or a constant lr, momentum SGD;
    with ``run_dir`` a checkpoint an epoch and auto-resume. A resumed run
    walks the epochs' permutations of an uninterrupted one (the JAX loop
    restarts its data order on resume). Returns ``(method, state)``."""
    log = log or VoidLog()
    device, model = _setup(model, init_params, device)
    data = _to_device(train_arrays, device)
    n_data = data[0].shape[0]
    base_loss = xent_loss_fn(model)

    def loss_fn(params, model_state, noise, batch):
        out = base_loss(params, model_state, noise, batch)
        sq = sum(torch.sum(leaf.float() ** 2) for leaf in sorted_named(params).values())
        prior = sq / (2 * prior_std**2 * n_data)
        return out._replace(loss=out.loss + prior)

    steps_per_epoch = max(1, n_data // batch_size)
    lr_sched = cosine_decay_schedule(lr, n_epochs * steps_per_epoch) if schedule == "cosine" else None
    method = map_method(loss_fn, lambda params: (SGD(params, lr, momentum=momentum, schedule=lr_sched), None))
    state = method.init(model.module, {})

    start_epoch = 0
    if run_dir:
        state, resumed = ckpt.restore_checkpoint(run_dir, state)
        if resumed is not None:
            start_epoch = resumed + 1
            log.info(f"resumed from epoch {resumed}")
    trainer = _trainer(method)
    state = trainer.place_state(state)

    rng = np.random.RandomState(seed)
    n = steps_per_epoch * batch_size
    for _ in range(start_epoch):
        rng.permutation(n_data)
    step = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, n_epochs):
        for sel in _batches(rng, n_data, batch_size, n):
            step += 1
            state, metrics = trainer.update(state, None, _batch(data, sel))
        log.info(f"epoch {epoch}: loss {float(metrics['loss']):.4f}")
        if run_dir:
            ckpt.save_checkpoint(run_dir, epoch, state)
    return method, state


def run_vi(
    model: Model,
    train_arrays,
    n_epochs: int = 10,
    batch_size: int = 128,
    lr: float = 1e-3,
    prior_std: float = 1.0,
    sigma_init: float = 0.01,
    mc_samples: int = 1,
    temperature: float = 1.0,
    seed: int = 0,
    init_params=None,
    log=None,
    device=None,
):
    """MFVI ELBO training (reference run_vi.py:105-121) under Adam;
    returns ``(method, state)``."""
    log = log or VoidLog()
    device, model = _setup(model, init_params, device)
    data = _to_device(train_arrays, device)
    method = mfvi_method(
        xent_loss_fn(model),
        lambda params: (Adam(params, lr), None),
        dataset_size=data[0].shape[0],
        prior_std=prior_std,
        sigma_init=sigma_init,
        mc_samples=mc_samples,
        temperature=temperature,
    )
    trainer = _trainer(method)
    state = trainer.place_state(method.init(model.module, {}))
    rng = np.random.RandomState(seed)
    step = 0
    for epoch in range(n_epochs):
        for sel in _batches(rng, data[0].shape[0], batch_size):
            step += 1
            state, metrics = trainer.update(state, iteration_noise(seed, step, device), _batch(data, sel))
        log.info(f"epoch {epoch}: loss {float(metrics['loss']):.4f} kl {float(metrics['kl']):.1f}")
    return method, state
