"""PyTorch port, the bnn-hmc models and data, held against the JAX package
on the same numpy inputs and JAX's initial weights (converted by
``models/jax_convert.py``):

* ``LeNet5`` at 16x16 and 28x28, ``CNNLSTM`` and ``smooth_cnn_lstm`` at a
  narrow width (vocabulary 2048, width 16, T = 100) and ``WilsonResNet20``
  (swish) at its true width on 4 images: logits and the gradients of
  ``sum(logits * w)`` with respect to every parameter within rtol 1e-5,
  atol 1e-5 (fp32 convolutions, an LSTM's 96 steps); JAX's side jitted.

The model zoo's names and the data loaders: ``test_torch_bnn_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.models.cnn_lstm import CNNLSTM as JaxCNNLSTM
from beyond_deep_ensembles_tpu.models.lenet import LeNet5 as JaxLeNet5
from beyond_deep_ensembles_tpu.models.resnet import WilsonResNet20 as JaxWilson
from beyond_deep_ensembles_tpu_torch.models.cnn_lstm import CNNLSTM
from beyond_deep_ensembles_tpu_torch.models.jax_convert import model_params_from_jax
from beyond_deep_ensembles_tpu_torch.models.lenet import LeNet5
from beyond_deep_ensembles_tpu_torch.models.resnet import WilsonResNet20

TOL = {"rtol": 1e-5, "atol": 1e-5}


def _port_input(x):
    x = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if x.ndim == 4:
        return t.permute(0, 3, 1, 2).contiguous()
    return t if x.dtype.kind == "f" else t.long()


def _hold(jax_module, module, x, seed, what):
    """Logits and parameter gradients of ``sum(logits * w)``, JAX's
    module (its init from ``seed``, jitted) against the port's loaded with
    its weights."""
    xj = jnp.asarray(x)
    params = jax.jit(jax_module.init)(jax.random.key(seed), xj)["params"]
    module.load_state_dict(model_params_from_jax(module, params), strict=True)
    n_out = module(_port_input(x)[:1]).shape[-1]
    w = np.random.RandomState(seed).standard_normal((x.shape[0], n_out)).astype(np.float32)

    @jax.jit
    def logits_and_grads(p):
        objective = lambda q: jnp.sum(jax_module.apply({"params": q}, xj) * w)  # noqa: E731
        return jax_module.apply({"params": p}, xj), jax.grad(objective)(p)

    out, grads = logits_and_grads(params)
    jgrads = model_params_from_jax(module, grads)
    got = module(_port_input(x))
    assert_close(got.detach().numpy(), np.asarray(out), **TOL, err_msg=f"{what} logits")
    (got * torch.from_numpy(w)).sum().backward()
    for name, p in module.named_parameters():
        assert_close(p.grad.numpy(), jgrads[name].numpy(), **TOL, err_msg=f"{what} grad {name}")


@pytest.mark.parametrize("size", [16, 28])
def test_lenet5_matches_jax(size):
    x = np.random.RandomState(size).standard_normal((3, size, size, 1)).astype(np.float32)
    module = LeNet5(10, in_channels=1, image_size=size, generator=torch.Generator().manual_seed(0))
    _hold(JaxLeNet5(classes=10), module, x, size, f"LeNet5 {size}x{size}")


@pytest.mark.parametrize("smooth", [False, True], ids=["cnn_lstm", "smooth_cnn_lstm"])
def test_cnn_lstm_matches_jax(smooth):
    kw = {"max_features": 2048, "embedding_size": 16, "cell_size": 16, "num_filters": 16}
    if smooth:
        kw.update(use_swish=True, use_maxpool=False)
    tokens = np.random.RandomState(7).randint(0, 2048, (3, 100)).astype(np.int32)
    module = CNNLSTM(2, generator=torch.Generator().manual_seed(0), **kw)
    _hold(JaxCNNLSTM(classes=2, **kw), module, tokens, 3, "CNNLSTM smooth" if smooth else "CNNLSTM")


def test_wilson_resnet20_matches_jax():
    x = np.random.RandomState(5).standard_normal((4, 32, 32, 3)).astype(np.float32)
    module = WilsonResNet20(10, activation="swish", generator=torch.Generator().manual_seed(0))
    assert len(list(module.parameters())) == 107
    _hold(JaxWilson(classes=10, activation="swish"), module, x, 1, "WilsonResNet20")
