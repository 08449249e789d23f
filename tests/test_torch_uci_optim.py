"""PyTorch port, the UCI optimizer (``utils/optim.py``: ``Adam``, and
``mle_split``'s ``Split`` with a momentum-free ``SGD`` on the ``__mle``
parameters) held against the JAX package's ``experiments/uci.py::_base_tx``
(``optax.multi_transform`` of ``adam``, after ``add_decayed_weights`` where
``weight_decay`` is set, and ``sgd(var_lr)``) on the CPU: 5 steps of the same
gradients on the MLP's parameters, with and without weight decay and with
and without the ``__mle`` rho; the state compared through
``models/jax_convert.py::state_from_jax`` (parameters, ``mu``, ``nu``, the
count); then ``step(ok=False)``, which must leave every buffer as it was.

Tolerances: parameters and moments within 1e-6 relative and 1e-7 absolute
(optax's fp32 bias corrections, ``b^t`` by repeated squaring in XLA against
``torch.pow``: a last-bit difference in a few counts), the counts exact."""
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_close, one_cpu_thread, to_numpy_tree  # noqa: F401 (one_cpu_thread: a fixture)
from beyond_deep_ensembles_tpu.experiments import uci as jax_uci
from beyond_deep_ensembles_tpu_torch.experiments import uci
from beyond_deep_ensembles_tpu_torch.models.jax_convert import params_from_jax, state_from_jax
from beyond_deep_ensembles_tpu_torch.models.mlp import RegressionMLP
from beyond_deep_ensembles_tpu_torch.utils.optim import SGD, Adam, Split

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

IN_DIM = 5


@pytest.mark.parametrize("learn_var", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_five_steps_match_optax_multi_transform(weight_decay, learn_var):
    config = {**uci.DEFAULT_CONFIG, "lr": 0.01, "var_lr": 0.05, "weight_decay": weight_decay}
    jtx = jax_uci._base_tx(config)
    jmodel = jax_uci._make_model({**config, "learn_var": learn_var})
    jparams = to_numpy_tree(jmodel.init(jax.random.key(0), np.zeros((1, IN_DIM), np.float32))[0])
    jstate = jtx.init(jparams)

    net = RegressionMLP(IN_DIM, learn_var=learn_var, generator=torch.Generator())
    net.load_state_dict(params_from_jax(jparams), strict=True)
    optimizer, _ = uci._base_tx(config, [net])(net.parameters())
    assert isinstance(optimizer, Split if learn_var else Adam)
    if learn_var:
        assert isinstance(optimizer.mle, SGD) and optimizer.mle.params == [net.GaussLayer_0.rho__mle]

    rng = np.random.RandomState(1)
    update = jax.jit(jtx.update)
    for _ in range(5):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jparams)
        updates, jstate = update(grads, jstate, jparams)
        jparams = to_numpy_tree(optax.apply_updates(jparams, updates))
        port_grads = params_from_jax(grads)
        for name, p in net.named_parameters():
            p.grad = port_grads[name].clone()
        optimizer.step()

    ref = state_from_jax(net, SimpleNamespace(params=jparams, model_state={}, opt_state=jstate, step=5, epoch=0),
                         lr=config["lr"], var_lr=config["var_lr"])
    mine = {f"opt.{k}": v for k, v in optimizer.state_dict().items()}
    assert mine.keys() == {k for k in ref if k.startswith("opt.")}
    for k, v in mine.items():
        if k.endswith(("count", "lr")):
            assert torch.equal(v, ref[k]), k
        elif not k.endswith("trace"):  # the JAX sgd keeps no trace
            assert_close(v.numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    for name, p in net.named_parameters():
        assert_close(p.detach().numpy(), params_from_jax(jparams)[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)

    # a skipped step: parameters, moments and counts as they were
    before = [t.clone() for t in optimizer.tensors()]
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step(torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, optimizer.tensors()))
    optimizer.step(torch.tensor(True))
    assert int(optimizer.state_dict()["main.count" if learn_var else "count"]) == 6


def test_state_dict_round_trip_in_place():
    net = RegressionMLP(IN_DIM, learn_var=True, generator=torch.Generator().manual_seed(0))
    optimizer, _ = uci._base_tx(uci.DEFAULT_CONFIG, [net])(net.parameters())
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    optimizer.step()
    saved = {k: v.clone() for k, v in optimizer.state_dict().items()}
    flat = optimizer.main.flat
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    optimizer.step()
    optimizer.load_state_dict(saved)
    assert optimizer.main.flat is flat  # in place: the parameters stay views of it
    assert all(torch.equal(optimizer.state_dict()[k], v) for k, v in saved.items())
    assert torch.equal(net.Dense_0.bias.detach(), flat[IN_DIM * 50 : IN_DIM * 50 + 50])
    with pytest.raises(KeyError):
        optimizer.main.load_state_dict({"flat": flat})
