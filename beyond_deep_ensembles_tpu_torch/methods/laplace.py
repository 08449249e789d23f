"""Post-hoc (last-layer) Laplace approximation with the GGN.

Counterpart of ``beyond_deep_ensembles_tpu/methods/laplace.py`` (reference
src/algos/laplace_approx.py, which calls laplace-torch): the GGN of the
network output with respect to the last layer's parameters,

    H = sum_b J_b^T Lambda_b J_b,   Lambda_b = diag(p_b) - p_b p_b^T

at the MAP logits (``I / sigma^2`` for regression), the per-example
Jacobians ``J`` ``[B, O, D]`` from ``torch.func.jacrev`` (the JAX package's
``jax.jacrev``) and the contraction by ``torch.matmul``; then the prior
precision that maximizes the marginal likelihood ``log lik(MAP) - 0.5
(pp |theta|^2 + logdet P - D log pp)``, ``P = H + pp I``, over a 33-point log
grid from 1e-4 to 1e4 and 32 golden-section steps on log(pp), on the host;
then the posterior: ``full`` (``scale_tril``, the Cholesky factor of the
covariance, ``inv(chol(P))^T``), ``diag`` (``1 / sqrt(P)``) or ``kron``
(KFAC, ``H ~ A (x) B`` with ``A = sum phi~ phi~^T`` and ``B`` the mean output
Hessian, kept as their eigenbases).

The last-layer vector is the JAX package's: the selected leaves in its
sorted-name order (for a dense head: the bias, then the kernel) in its
layout (a dense kernel ``[in, out]``), so ``H``, ``ll_mean`` and
``scale_tril`` compare with the JAX state's as they are. A draw is
``ll_mean + scale_tril @ z`` (``diag``: ``diag_scale * z``; ``kron``:
``U_A (z / sqrt(s)) U_B^T`` added to the head), ``z`` from the forward's
``NoiseSource``, returned as a mapping from parameter names to tensors.

``fit`` on a deep-ensemble state fits each member on the same batches and
keeps the members (an ``EnsembleState`` of fitted states). The fitted state
is a new :class:`LaplaceState`; its ``load_state_dict`` copies in place, so
a captured eval graph that holds a state's tensors reads what is loaded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .api import MethodState, PosteriorMethod
from .ensemble import EnsembleState

_LAPLACE_KEYS = ("ll_mean", "scale_tril", "diag_scale", "prior_prec", "kron_ua", "kron_ub", "kron_sa", "kron_sb")


@dataclasses.dataclass(kw_only=True)
class LaplaceState(MethodState):
    ll_mean: torch.Tensor  # [D] the last-layer MAP vector
    scale_tril: torch.Tensor  # [D, D] (full) or [0, 0]
    diag_scale: torch.Tensor  # [D] (diag) or [0]
    prior_prec: torch.Tensor  # 0-dim
    kron_ua: torch.Tensor  # [Din + 1, Din + 1] (kron) or [0, 0]
    kron_ub: torch.Tensor  # [O, O] or [0, 0]
    kron_sa: torch.Tensor  # [Din + 1] or [0]
    kron_sb: torch.Tensor  # [O] or [0]

    def state_dict(self) -> dict:
        return {**super().state_dict(), **{f"laplace.{k}": getattr(self, k) for k in _LAPLACE_KEYS}}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        with torch.no_grad():
            for k in _LAPLACE_KEYS:
                getattr(self, k).copy_(state[f"laplace.{k}"])


def optimize_prior_prec(marglik: Callable, lo: float = -4.0, hi: float = 4.0, grid: int = 33,
                        refine_iters: int = 32, device=None) -> float:
    """The prior precision that maximizes the marginal likelihood (JAX
    ``_optimize_prior_prec``): the argmax over ``grid`` log-spaced candidates
    from 10^lo to 10^hi (``marglik`` of the fp32 candidates ``[grid]``, all
    at once), then ``refine_iters`` golden-section steps on log(pp) inside the
    bracketing pair of grid points (``marglik`` of a 0-dim fp32 pp), one
    host read a step."""
    candidates = torch.logspace(lo, hi, grid, dtype=torch.float64).to(torch.float32).to(device)
    # a candidate without a value (a Cholesky that failed: NaN) is never the
    # argmax (the JAX package's jnp.argmax would take the first NaN)
    i = int(torch.argmax(torch.nan_to_num(marglik(candidates), nan=-math.inf)))
    log_c = torch.log(candidates)
    a, b = float(log_c[max(i - 1, 0)]), float(log_c[min(i + 1, grid - 1)])

    def f(t):
        return float(marglik(torch.exp(torch.tensor(t, dtype=torch.float32, device=device))))

    gr = (math.sqrt(5.0) - 1.0) / 2.0
    c, d_ = b - gr * (b - a), a + gr * (b - a)
    fc, fd = f(c), f(d_)
    for _ in range(refine_iters):
        if fc >= fd:  # maximum in [a, d_]
            b, d_, fd = d_, c, fc
            c = b - gr * (b - a)
            fc = f(c)
        else:  # maximum in [c, b]
            a, c, fc = c, d_, fd
            d_ = a + gr * (b - a)
            fd = f(d_)
    return float(math.exp((a + b) / 2.0))


def log_marginal_likelihood(curvature: torch.Tensor, loglik: torch.Tensor, theta: torch.Tensor,
                            hessian: str) -> Callable:
    """``pp -> log lik - 0.5 (pp |theta|^2 + logdet(H + pp I) - D log pp)``
    (laplace-torch's marglik criterion; JAX ``marglik``), for fp32 ``pp`` of
    any shape (the grid at once). ``curvature``: ``H`` ``[D, D]`` (``full``:
    the logdet by Cholesky), its diagonal ``[D]`` (``diag``), or the ``[D]``
    products ``s_A (x) s_B`` of the Kronecker factors' eigenvalues
    (``kron``)."""
    d, scatter = theta.numel(), torch.sum(theta**2)

    def logdet(pp):
        if hessian == "full":
            eye = torch.eye(d, dtype=curvature.dtype, device=curvature.device)
            chol, _ = torch.linalg.cholesky_ex(curvature + pp[..., None, None] * eye)
            return 2 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        return torch.sum(torch.log(curvature + pp[..., None]), dim=-1)

    def marglik(pp):
        return loglik - 0.5 * (pp * scatter + logdet(pp) - d * torch.log(pp))

    return marglik


def last_layer_mask(params) -> dict:
    """The highest-indexed ``Dense_k`` / ``BBBDense_k`` / ``Rank1Dense_k``
    scope (the head in every ported architecture): ``{name: bool}`` over the
    parameter names of ``params`` (a module or a mapping)."""
    names = list(dict(params.named_parameters()) if hasattr(params, "named_parameters") else params)
    scopes = {part for name in names for part in name.split(".")[:-1]
              if part.startswith(("Dense_", "BBBDense_", "Rank1Dense_"))}
    if not scopes:
        raise ValueError("no Dense scope found for last-layer Laplace")
    target = sorted(scopes, key=lambda s: (s.rsplit("_", 1)[0], int(s.rsplit("_", 1)[1])))[-1]
    return {name: target in name.split(".")[:-1] for name in names}


def _to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    return t.T if t.ndim == 2 else t


def _from_jax_layout(t: torch.Tensor) -> torch.Tensor:
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t.T if t.ndim == 2 else t


class _LastLayer:
    """The selected leaves of one module as the JAX package's last-layer
    vector, and back."""

    def __init__(self, module, mask_fn):
        mask = mask_fn(module)
        self.module = module
        # the JAX package's leaf order: sorted path components
        self.names = sorted((n for n, m in mask.items() if m), key=lambda n: n.split("."))
        self.shapes = [tuple(_to_jax_layout(dict(module.named_parameters())[n]).shape) for n in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]

    def vector(self) -> torch.Tensor:
        named = dict(self.module.named_parameters())
        return torch.cat([_to_jax_layout(named[n].detach()).reshape(-1) for n in self.names])

    def params(self, vec: torch.Tensor) -> dict:
        """Every parameter of the module (detached), the selected ones taken
        from ``vec``."""
        out = {n: p.detach() for n, p in self.module.named_parameters()}
        for n, shape, part in zip(self.names, self.shapes, torch.split(vec, self.sizes)):
            out[n] = _from_jax_layout(part.reshape(shape))
        return out


@dataclasses.dataclass(frozen=True)
class LaplacePosterior(PosteriorMethod):
    """A ``PosteriorMethod`` with a post-hoc ``fit(state, data)`` and its
    first half, ``ggn(state, data) -> (H or its diagonal, log-likelihood)``
    (``full`` and ``diag``); ``init`` and ``update`` delegate to the inner
    (MAP) method."""

    fit: Callable = None
    ggn: Callable = None


_NO_INNER = (
    "laplace_method(inner=None) is post-hoc only and cannot train: pass inner=<trainable PosteriorMethod>, "
    "or train a MAP state and call .fit(map_state, (x, y)) (experiments/cifar.py::fit_laplace_phase)"
)


def laplace_method(
    model,
    hessian: str = "full",
    regression: bool = True,
    sigma_noise: float = 1.0,
    inner: Optional[PosteriorMethod] = None,
    batch_size: int = 256,
) -> LaplacePosterior:
    """``model``: an ``nn/base.py::Model``; the GGN linearizes its output at
    ``train=False`` (channel 0 of a two-channel regression output) in the
    parameters :func:`last_layer_mask` selects. The JAX package's
    ``mean_output``, ``subset_mask_fn`` and (unused) ``prior_prec`` have no
    caller in the port and are not taken."""
    mask_fn = last_layer_mask
    if hessian not in ("full", "diag", "kron"):
        raise NotImplementedError(f"hessian={hessian!r}")

    def out_fn(params, model_state, x):
        out, _, _ = model.apply(params, model_state, None, x, train=False)
        if regression and out.ndim >= 2 and out.shape[-1] == 2:
            out = out[..., 0]
        return out.reshape(x.shape[0], -1)

    def _loglik(logits, y):
        if regression:
            resid = logits - y.reshape(logits.shape)
            return torch.sum(-0.5 * (resid / sigma_noise) ** 2 - math.log(sigma_noise) - 0.5 * math.log(2 * math.pi))
        return torch.sum(torch.gather(F.log_softmax(logits, dim=-1), 1, y.reshape(-1, 1)))

    def _ggn_batch(state, ll: _LastLayer, x, y):
        """(H ``[D, D]`` or its diagonal ``[D]``, the batch's log-likelihood)."""

        def f(vec):
            out = out_fn(ll.params(vec), state.model_state, x)
            return out, out

        jac, logits = torch.func.jacrev(f, has_aux=True)(ll.vector())  # [B, O, D], [B, O]
        b, o, d = jac.shape
        if regression:
            lam = 1.0 / sigma_noise**2
            if hessian == "full":
                h = lam * (jac.reshape(b * o, d).T @ jac.reshape(b * o, d))
            else:
                h = lam * torch.sum(jac**2, dim=(0, 1))
        else:
            # diag(p) - p p^T = A^T A with A = diag(sqrt p) (I - 1 p^T), so H
            # is the Gram matrix of G = A J, [B * O, D]: the same function as
            # the JAX package's difference of two products, without their
            # cancellation, which leaves the softmax's null directions
            # (a constant added to every logit) at fp32 noise of either sign
            # and H + pp I at small pp without a Cholesky factor
            p = torch.softmax(logits, dim=-1)
            jp = torch.einsum("bo,boi->bi", p, jac)
            g = (torch.sqrt(p)[..., None] * (jac - jp[:, None, :])).reshape(b * o, d)
            h = g.T @ g if hessian == "full" else torch.sum(g * g, dim=0)
        return h, _loglik(logits, y)

    def _new_state(state, device, **fields):
        """A fitted state over ``state``'s module (its step and epoch 0, as
        the JAX ``LaplaceState``'s)."""
        empty = {"scale_tril": torch.zeros(0, 0), "diag_scale": torch.zeros(0), "kron_ua": torch.zeros(0, 0),
                 "kron_ub": torch.zeros(0, 0), "kron_sa": torch.zeros(0), "kron_sb": torch.zeros(0)}
        empty.update(fields)
        return LaplaceState(params=state.params, model_state=state.model_state, opt_state=None,
                            **{k: v.to(device) for k, v in empty.items()})

    def _fit_kron(state, batches):
        """KFAC last-layer fit (JAX ``_fit_kron``): exact Kronecker structure
        for a linear head."""
        ll = _LastLayer(state.params, mask_fn)
        named = dict(state.params.named_parameters())
        kernel_name = next(n for n in ll.names if named[n].ndim == 2)
        bias_name = next((n for n in ll.names if named[n].ndim == 1), None)
        kernel = named[kernel_name].detach()  # [O, Din]
        n_out, din = kernel.shape
        a_tot = b_tot = None
        loglik, n_total = 0.0, 0
        for xb, yb in batches:
            base = {n: p.detach() for n, p in named.items()}

            def f0(k):
                out = out_fn({**base, kernel_name: k}, state.model_state, xb)
                return out[:, 0], out

            jac, logits = torch.func.jacrev(f0, has_aux=True)(kernel)  # [B, O, Din]
            phi = jac[:, 0, :]
            phi_t = torch.cat([phi, torch.ones(phi.shape[0], 1, dtype=phi.dtype, device=phi.device)], dim=1)
            a = phi_t.T @ phi_t
            if regression:
                bb = torch.eye(n_out, device=phi.device) / sigma_noise**2 * xb.shape[0]
            else:
                p = torch.softmax(logits, dim=-1)
                bb = torch.diag(p.sum(0)) - p.T @ p
            a_tot = a if a_tot is None else a_tot + a
            b_tot = bb if b_tot is None else b_tot + bb
            loglik = loglik + _loglik(logits, yb).double()
            n_total += xb.shape[0]
        loglik = loglik.to(torch.float32)
        sa, ua = torch.linalg.eigh(a_tot)
        sb, ub = torch.linalg.eigh(b_tot / n_total)
        sa, sb = torch.clamp(sa, min=0.0), torch.clamp(sb, min=0.0)
        bias = named[bias_name].detach() if bias_name else torch.zeros(n_out, device=kernel.device)
        theta = torch.cat([kernel.T.reshape(-1), bias])
        eig = (sa[:, None] * sb[None, :]).reshape(-1)
        best = optimize_prior_prec(log_marginal_likelihood(eig, loglik, theta, "kron"), device=kernel.device)
        return _new_state(state, kernel.device, ll_mean=ll.vector(), prior_prec=torch.tensor(best, dtype=torch.float32),
                          kron_ua=ua, kron_ub=ub, kron_sa=sa, kron_sb=sb)

    def _batches(data):
        if isinstance(data, tuple):
            x, y = data
            return [(x[i : i + batch_size], y[i : i + batch_size]) for i in range(0, x.shape[0], batch_size)]
        return list(data)

    @torch.no_grad()
    def ggn(state, data):
        """The GGN over ``data`` (``full``: ``[D, D]``, ``diag``: ``[D]``) and
        the log-likelihood at the MAP (fp32, summed over the batches in
        fp64 as the JAX package sums them on the host)."""
        ll = _LastLayer(state.params, mask_fn)
        h_total, loglik = None, 0.0
        for xb, yb in _batches(data):
            h, batch_ll = _ggn_batch(state, ll, xb, yb)
            h_total = h if h_total is None else h_total + h
            loglik = loglik + batch_ll.double()
        return h_total, loglik.to(torch.float32)

    def fit(state, data, key=None):
        """``data``: ``(x, y)`` tensors on the model's device (cut into
        batches of ``batch_size``) or a sequence of ``(x, y)`` batches. A
        deep-ensemble state is fitted per member, on the same batches."""
        del key
        if isinstance(state, EnsembleState):
            data = data if isinstance(data, tuple) else list(data)
            return EnsembleState([fit(member, data) for member in state.members])
        batches = _batches(data)
        with torch.no_grad():
            if hessian == "kron":
                return _fit_kron(state, batches)
            h_total, loglik = ggn(state, batches)
            ll_vec = _LastLayer(state.params, mask_fn).vector()
            eye = torch.eye(ll_vec.shape[0], dtype=ll_vec.dtype, device=ll_vec.device)
            best = optimize_prior_prec(log_marginal_likelihood(h_total, loglik, ll_vec, hessian), device=ll_vec.device)
            pp = torch.tensor(best, dtype=torch.float32, device=ll_vec.device)
            fields = {"ll_mean": ll_vec, "prior_prec": pp}
            if hessian == "full":
                chol, _ = torch.linalg.cholesky_ex(h_total + pp * eye)
                # scale_tril of the covariance: inv(chol(prec))^T
                fields["scale_tril"] = torch.linalg.solve_triangular(chol, eye, upper=False).T
            else:
                fields["diag_scale"] = 1.0 / torch.sqrt(h_total + pp)
            return _new_state(state, ll_vec.device, **fields)

    def sample(state: LaplaceState, noise, index=None):
        del index
        ll = _LastLayer(state.params, mask_fn)
        device = state.ll_mean.device
        if hessian == "kron":
            named = {n: p.detach() for n, p in state.params.named_parameters()}
            kernel_name = next(n for n in ll.names if named[n].ndim == 2)
            bias_name = next((n for n in ll.names if named[n].ndim == 1), None)
            n_out, din = named[kernel_name].shape
            z = noise.normal((din + 1, n_out), device, True, False)
            s = state.kron_sa[:, None] * state.kron_sb[None, :] + state.prior_prec
            delta = state.kron_ua @ (z / torch.sqrt(s)) @ state.kron_ub.T  # [Din + 1, O]
            named[kernel_name] = named[kernel_name] + delta[:din].T
            if bias_name is not None:
                named[bias_name] = named[bias_name] + delta[din]
            return named, state.model_state
        z = noise.normal(tuple(state.ll_mean.shape), device, True, False)
        if hessian == "full":
            vec = state.ll_mean + state.scale_tril @ z
        else:
            vec = state.ll_mean + state.diag_scale * z
        return ll.params(vec), state.model_state

    def init(params, model_state=None):
        if inner is None:
            raise RuntimeError(_NO_INNER)
        return inner.init(params, model_state)

    def update(state, noise, batch):
        if inner is None:
            raise RuntimeError(_NO_INNER)
        return inner.update(state, noise, batch)

    return LaplacePosterior(init=init, update=update, sample=sample, fit=fit, ggn=ggn)
