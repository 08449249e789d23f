"""PyTorch port at a bf16 compute dtype, the tiny DenseNet (growth 4, blocks
(2, 2)) against the JAX package: every layer's and block's output dtype (the
concatenated features and the ``"buffer"`` bf16, the head fp32), fp32
logits, and the logits' bf16 error (tests/_torch_bf16_parity.py states the
holds and their bounds). Kinds: plain and BBB, and spectral, which the JAX
package runs in fp32 throughout; the buffer growth on the plain kind."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16_parity import check_model
from _torch_parity import nchw
from beyond_deep_ensembles_tpu.models.densenet import DenseNetClassifier as JaxDenseNet
from beyond_deep_ensembles_tpu_torch.models.densenet import DenseNetClassifier

TINY = dict(growth_rate=4, block_config=(2, 2), init_features=8, bn_size=2)


@pytest.mark.parametrize("kind,concat_mode", [("plain", "concat"), ("bbb", "concat"), ("spectral", "concat"),
                                              ("plain", "buffer")])
def test_densenet_bf16(kind, concat_mode, monkeypatch):
    x = np.random.RandomState(0).standard_normal((4, 32, 32, 3)).astype(np.float32)

    def jax_module(dtype):
        return JaxDenseNet(classes=5, conv_kind=kind, head_kind=kind, concat_mode=concat_mode, dtype=dtype, **TINY)

    def port(dtype):
        return DenseNetClassifier(5, head_kind=kind, conv_kind=kind, concat_mode=concat_mode, dtype=dtype,
                                  generator=torch.Generator(), **TINY)

    check_model(monkeypatch, "densenet", jax_module(jnp.bfloat16), port(torch.bfloat16), x, nchw(x),
                fp32_module=jax_module(None), fp32_net=port(None), expect_bf16=kind != "spectral")
