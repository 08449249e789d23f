"""PyTorch port at a bf16 compute dtype, ResNet-50 at stage sizes (1, 1) on
32x32x3 against the JAX package: every layer's and block's output dtype (the
static norms return bf16 with fp32 statistics, the head fp32), fp32 logits,
and their bf16 error (tests/_torch_bf16_parity.py states the holds and their
bounds). Kinds: plain and BBB, and spectral, which the JAX package runs in
fp32 throughout. ResNet-18: tests/test_torch_bf16_models_resnet18.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16_parity import check_model
from _torch_parity import nchw
from beyond_deep_ensembles_tpu.models.resnet import ResNet50 as JaxResNet50
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet50


@pytest.mark.parametrize("kind", ["plain", "bbb", "spectral"])
def test_resnet50_bf16(kind, monkeypatch):
    x = np.random.RandomState(0).standard_normal((4, 32, 32, 3)).astype(np.float32)

    def jax_module(dtype):
        return JaxResNet50(classes=5, conv_kind=kind, head_kind=kind, stage_sizes=(1, 1), dtype=dtype)

    def port(dtype):
        return ResNet50(5, conv_kind=kind, head_kind=kind, stage_sizes=(1, 1), dtype=dtype,
                        generator=torch.Generator())

    check_model(monkeypatch, "resnet50", jax_module(jnp.bfloat16), port(torch.bfloat16), x, nchw(x),
                fp32_module=jax_module(jnp.float32), fp32_net=port(None), expect_bf16=kind != "spectral")

