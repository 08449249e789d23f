"""PyTorch port at a bf16 compute dtype, the full ResNet-18 on 32x32x8
(PovertyMap's trunk) against the JAX package: every layer's and block's
output dtype (the static norms return bf16 with fp32 statistics, the head
fp32), fp32 outputs, and their bf16 error (tests/_torch_bf16_parity.py
states the holds and their bounds). Kinds: plain and BBB, and Rank-1
(component 0), which the JAX package runs in fp32 throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16_parity import check_model
from _torch_parity import nchw
from beyond_deep_ensembles_tpu.models.resnet import ResNet18 as JaxResNet18
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet18


@pytest.mark.parametrize("kind", ["plain", "bbb", "rank1"])
def test_resnet18_bf16(kind, monkeypatch):
    x = np.random.RandomState(0).standard_normal((4, 32, 32, 8)).astype(np.float32)
    components = 2 if kind == "rank1" else 1
    kw = dict(component=0) if kind == "rank1" else {}

    def jax_module(dtype):
        return JaxResNet18(classes=1, conv_kind=kind, components=components, dtype=dtype)

    def port(dtype):
        return ResNet18(1, conv_kind=kind, components=components, dtype=dtype, in_channels=8,
                        generator=torch.Generator())

    check_model(monkeypatch, "resnet18", jax_module(jnp.bfloat16), port(torch.bfloat16), x, nchw(x),
                fp32_module=jax_module(jnp.float32), fp32_net=port(None), expect_bf16=kind != "rank1", **kw)
