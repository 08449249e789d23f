"""PyTorch port, methods/last_layer.py (``last_layer_method``) held against
the JAX package's on a two-layer classifier, on the CPU: three jitted
updates of the composition over an inner SWAG, iVON (mc 2), SVGD (3 head
particles) and BBB (a BBB head), the inner method owning the head and an
Adam with weight decay stepping the backbone, from JAX's state and with
JAX's draws given (``_torch_wilds_parity``); then the backbone's gradient,
which must be the SUM of every backward the inner method made (SVGD's
particles, iVON's MC draws), never their mean; the head view's names, the
state's round trip and the options that raise. The compositions on tiny
DistilBERT (``swag_ll``, ``ll_ivon``, ``ll_svgd``, ``ll_bbb``, the head both
dense layers) are held through the engine in ``test_torch_wilds_amazon.py``,
``test_torch_wilds_amazon_rest.py`` and ``test_torch_wilds_civil_rest.py``.

Tolerances: every state tensor within 1e-6 after three updates at lr 1e-2
(fp32 arithmetic in other orders on values of order 1; the Adam moments
within 1e-5 of their tensor's largest); the backbone gradient against the
sum of the per-pass gradients 1e-6 relative to its largest entry."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import assert_close, random_jax_params
from _torch_wilds_parity import RECORDED, _convert, record_draws
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import GaussianPrior as JaxPrior
from beyond_deep_ensembles_tpu.methods import bbb_method as jax_bbb
from beyond_deep_ensembles_tpu.methods import ivon_method as jax_ivon
from beyond_deep_ensembles_tpu.methods import last_layer_method as jax_last_layer
from beyond_deep_ensembles_tpu.methods import svgd_method as jax_svgd
from beyond_deep_ensembles_tpu.methods import swag_method as jax_swag
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu.nn.bbb import BBBDense as JaxBBBDense
from beyond_deep_ensembles_tpu_torch.methods.api import GaussianPrior, LossOutput
from beyond_deep_ensembles_tpu_torch.methods.bbb import bbb_method
from beyond_deep_ensembles_tpu_torch.methods.ivon import ivon_method
from beyond_deep_ensembles_tpu_torch.methods.last_layer import HeadView, LastLayerState, last_layer_method
from beyond_deep_ensembles_tpu_torch.methods.svgd import svgd_method
from beyond_deep_ensembles_tpu_torch.methods.swag import swag_method
from beyond_deep_ensembles_tpu_torch.models.jax_convert import last_layer_state_from_jax, strip_placeholders
from beyond_deep_ensembles_tpu_torch.models.layers import make_dense
from beyond_deep_ensembles_tpu_torch.nn.base import Model, add_auto_named
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource
from beyond_deep_ensembles_tpu_torch.utils.optim import Adam

LR, WD, N = 1e-2, 1e-2, 60
INNERS = ["swag", "ivon", "svgd", "bbb"]


class JaxNet(fnn.Module):
    head: str = "plain"

    @fnn.compact
    def __call__(self, x, train: bool = True):
        h = jax.nn.relu(fnn.Dense(16)(x))
        if self.head == "bbb":
            return JaxBBBDense(3)(h, train=train)
        return fnn.Dense(3)(h)


class TorchNet(torch.nn.Module):
    def __init__(self, head="plain"):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self._layers = (add_auto_named(self, make_dense("plain", 5, 16, generator=gen)),
                        add_auto_named(self, make_dense(head, 16, 3, generator=gen)))

    def forward(self, x, noise=None, train=True):
        hidden, out = self._layers
        return out(torch.relu(hidden(x, noise, train)), noise, train=train)


def _head_mask(params):
    """The head: the last layer (``Dense_1`` or ``BBBDense_0``), JAX tree or
    port module."""
    if isinstance(params, torch.nn.Module):
        return {n: not n.startswith("Dense_0.") for n, _ in params.named_parameters()}
    return jax.tree_util.tree_map_with_path(lambda path, _: getattr(path[0], "key", "") != "Dense_0", params)


def _jax_inner(name):
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    if name == "swag":
        return lambda lf: jax_swag(lf, tx, update_interval=1, start_epoch=0, deviation_samples=4)
    if name == "ivon":
        return lambda lf: jax_ivon(lf, lr=LR, prior_prec=50.0, dataset_size=N, mc_samples=2)
    if name == "svgd":
        return lambda lf: jax_svgd(lf, tx, particle_count=3, dataset_size=N, l2_reg=1e-4)
    return lambda lf: jax_bbb(lf, tx, JaxPrior(0.0, 1.0), dataset_size=N, mc_samples=1, kl_rescaling=0.2)


def _port_inner(name):
    def tx(params):
        return Adam(params, LR, weight_decay=WD), None

    if name == "swag":
        return lambda lf: swag_method(lf, tx, update_interval=1, start_epoch=0, deviation_samples=4)
    if name == "ivon":
        return lambda lf: ivon_method(lf, lr=LR, prior_prec=50.0, dataset_size=N, mc_samples=2)
    if name == "svgd":
        return lambda lf: svgd_method(lf, tx, particle_count=3, dataset_size=N, l2_reg=1e-4)
    return lambda lf: bbb_method(lf, tx, GaussianPrior(0.0, 1.0), dataset_size=N, mc_samples=1, kl_rescaling=0.2)


def _jax_loss(model):
    def loss_fn(params, model_state, key, batch, **kw):
        x, y = batch
        out, kl, ms = model.apply(params, model_state, key, x, train=True, **kw)
        logp = jax.nn.log_softmax(out, axis=-1)
        return JaxLossOutput(loss=-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), kl=kl, model_state=ms)

    return loss_fn


def _port_loss(model):
    def loss_fn(params, model_state, noise, batch, **kw):
        x, y = batch
        out, kl, ms = model.apply(params, model_state, noise, x, train=True, **kw)
        return LossOutput(loss=F.cross_entropy(out, y), kl=kl, model_state=ms)

    return loss_fn


def _batches(n=3):
    rng = np.random.RandomState(0)
    return [(rng.standard_normal((6, 5)).astype(np.float32), rng.randint(0, 3, 6)) for _ in range(n)]


def _setup(name):
    head = "bbb" if name == "bbb" else "plain"
    jmodel = JaxModel(JaxNet(head))
    particles = 3 if name == "svgd" else 0
    jmethod = jax_last_layer(_jax_loss(jmodel), _jax_inner(name),
                             optax.chain(optax.add_decayed_weights(WD), optax.adam(LR)), mask_fn=_head_mask,
                             head_particles=particles)
    params = random_jax_params(jmodel.module, (6, 5), seed=2)
    jstate = jmethod.init(jax.random.key(0), params, {})
    model = Model(TorchNet(head))
    method = last_layer_method(_port_loss(model), _port_inner(name),
                               lambda p: (Adam(p, LR, weight_decay=WD), None), mask_fn=_head_mask,
                               head_particles=particles)
    state = method.init(model.module, {})
    state.load_state_dict(last_layer_state_from_jax(state, jstate, LR))
    if hasattr(state.inner, "mean") and hasattr(state.inner, "flat"):  # iVON: the parameters hold the mean
        state.inner.flat.copy_(state.inner.mean)
    return jmethod, jstate, method, state


def _hold(state, jstate):
    want, got = last_layer_state_from_jax(state, jstate, LR), state.state_dict()
    assert got.keys() == want.keys()
    worst = 0.0
    for k, g in got.items():
        w = want[k]
        if not g.is_floating_point():
            assert torch.equal(g.to(torch.int64), w.to(torch.int64)), k
            continue
        tol = max(1e-6, 1e-5 * float(w.abs().max())) if k.endswith((".mu", ".nu")) and w.numel() else 1e-6
        gap = float((g.detach().double() - w.double()).abs().max()) if g.numel() else 0.0
        assert gap <= tol, (k, gap, tol)
        worst = max(worst, gap / tol * 1e-6)
    assert_close(worst, 0.0, atol=1e-6, err_msg="state after three updates")


@pytest.mark.parametrize("inner", INNERS)
def test_three_updates_match_jax(inner, monkeypatch):
    jmethod, jstate, method, state = _setup(inner)
    record_draws(monkeypatch)
    update = jax.jit(jmethod.update)
    losses = []
    for i, (x, y) in enumerate(_batches()):
        jstate, m = update(jstate, jax.random.key(i), (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(m["loss"]))
    jax.effects_barrier()
    draws = list(RECORDED)
    template = strip_placeholders(jax.tree.map(np.asarray, jstate.inner.params))
    leaves = len(jax.tree.leaves(jstate.inner.params)) if inner == "ivon" else 0
    given = NoiseSource(given=_convert(draws, leaves, template, state.inner.params, False))
    for (x, y), want in zip(_batches(), losses):
        state, m = method.update(state, given, (torch.from_numpy(x), torch.from_numpy(y)))
        assert_close(float(m["loss"]), want, rtol=1e-6, err_msg=f"{inner} loss")
    assert given.draws == len(given._given) and state.step == 3
    _hold(state, jstate)


def _per_pass_grads(model, backbone, loss_of, passes):
    """The backbone's gradient of each pass's loss, computed alone."""
    out = []
    for i in range(passes):
        grads = torch.autograd.grad(loss_of(i), list(backbone.values()))
        out.append(torch.cat([g.reshape(-1) for g in grads]))
    return out


@pytest.mark.parametrize("inner", ["svgd", "ivon"])
def test_backbone_gradient_is_the_sum_over_passes(inner):
    """One update: the gradient the backbone optimizer steps with equals the
    sum of the per-pass backbone gradients (3 SVGD particles; iVON's 2 MC
    draws, given), not their mean."""
    model = Model(TorchNet())
    method = last_layer_method(_port_loss(model), _port_inner(inner), lambda p: (Adam(p, LR, weight_decay=0.0), None),
                               mask_fn=_head_mask, head_particles=3 if inner == "svgd" else 0)
    state = method.init(model.module, {})
    x, y = (torch.from_numpy(a) for a in _batches(1)[0])
    head = state.inner.params
    gen = torch.Generator().manual_seed(5)
    deltas = [torch.randn(sum(p.numel() for p in head.parameters()), generator=gen) for _ in range(2)]
    loss_fn = _port_loss(model)
    if inner == "svgd":
        def loss_of(i):
            return loss_fn(head[i], {}, None, (x, y)).loss
        passes = 3
    else:
        eps_scale = 1.0 / torch.sqrt(N * torch.clamp(state.inner.precision, min=1e-4))
        mean = state.inner.mean.clone()

        def loss_of(i):
            with torch.no_grad():
                state.inner.flat.copy_(mean + deltas[i] * eps_scale)
            return loss_fn(head, {}, None, (x, y)).loss
        passes = 2
    want = torch.stack(_per_pass_grads(model, state.backbone, loss_of, passes)).sum(0)
    if inner == "ivon":
        state.inner.flat.copy_(mean)
    noise = NoiseSource(given=deltas) if inner == "ivon" else None
    state, _ = method.update(state, noise, (x, y))
    got = torch.cat([p.grad.reshape(-1) for p in state.backbone.values()])
    assert_close(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * float(want.abs().max()),
                 err_msg=f"{inner} backbone gradient = the sum over {passes} passes")
    assert float((got - want / passes).abs().max()) > 1e-3 * float(want.abs().max())  # not the mean


def test_head_view_names_and_state_round_trip():
    model = TorchNet()
    method = last_layer_method(_port_loss(Model(model)), _port_inner("svgd"),
                               lambda p: (Adam(p, LR), None), mask_fn=_head_mask, head_particles=3)
    state = method.init(model, {})
    assert isinstance(state, LastLayerState) and len(state.inner.params) == 3
    assert [n for n, _ in state.inner.params[0].named_parameters()] == ["Dense_1.kernel", "Dense_1.bias"]
    assert list(state.backbone) == ["Dense_0.kernel", "Dense_0.bias"]
    # the particles are perturbed copies: other values, the model's head untouched
    assert not torch.equal(state.inner.params[0].Dense_1.kernel, state.inner.params[1].Dense_1.kernel)
    assert state.inner.params[0].Dense_1 is not model.Dense_1
    single = last_layer_method(_port_loss(Model(model)), _port_inner("swag"), lambda p: (Adam(p, LR), None),
                               mask_fn=_head_mask).init(model, {})
    assert isinstance(single.inner.params, HeadView) and single.inner.params.Dense_1 is model.Dense_1
    saved = {k: v.clone() for k, v in state.state_dict().items()}
    with torch.no_grad():
        for t in state.written_tensors():
            t.add_(1) if t.is_floating_point() else t.add_(1)
    state.load_state_dict(saved)
    assert all(torch.equal(v, saved[k]) for k, v in state.state_dict().items())
    with pytest.raises(ValueError, match="part of"):
        last_layer_method(_port_loss(Model(model)), _port_inner("swag"), lambda p: (Adam(p, LR), None),
                          mask_fn=lambda m: {n: n == "Dense_1.kernel" for n, _ in m.named_parameters()}).init(model)
