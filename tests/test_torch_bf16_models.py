"""PyTorch port at a bf16 compute dtype, the CIFAR ResNet-20 and DistilBERT
(TINY) against the JAX package: every layer's and block's output dtype, fp32
logits, and the logits' bf16 error (tests/_torch_bf16_parity.py states the
holds and their bounds). Kinds: plain and BBB, and Rank-1 (component 0),
which the JAX package runs in fp32 throughout (it passes no dtype to a rank-1
layer); DistilBERT's head kinds map, bbb and rank1 on the bf16 encoder."""
import numpy as np
import pytest
import torch

from _torch_bf16_parity import check_model
from _torch_parity import nchw
from beyond_deep_ensembles_tpu.models.bert import BertClassifier as JaxBert
from beyond_deep_ensembles_tpu.models.bert import DistilBertConfig as JaxBertConfig
from beyond_deep_ensembles_tpu.models.resnet import ResNet20 as JaxResNet20
import jax.numpy as jnp

from beyond_deep_ensembles_tpu_torch.models import bert
from beyond_deep_ensembles_tpu_torch.models.resnet import ResNet20


@pytest.mark.parametrize("kind", ["plain", "bbb", "rank1"])
def test_resnet20_bf16(kind, monkeypatch):
    components = 2 if kind == "rank1" else 1
    kw = dict(component=0) if kind == "rank1" else {}
    x = np.random.RandomState(0).standard_normal((4, 32, 32, 3)).astype(np.float32)

    def jax_module(dtype):
        return JaxResNet20(classes=10, activation="swish", norm="frn", conv_kind=kind, components=components,
                           dtype=dtype)

    def port(dtype):
        return ResNet20(10, "swish", "frn", kind, components=components, dtype=dtype, generator=torch.Generator())

    check_model(monkeypatch, "resnet20", jax_module(jnp.bfloat16), port(torch.bfloat16), x, nchw(x),
                fp32_module=jax_module(jnp.float32), fp32_net=port(None), expect_bf16=kind != "rank1", **kw)


@pytest.mark.parametrize("head", ["map", "bbb", "rank1"])
def test_bert_bf16(head, monkeypatch):
    cfg = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, hidden_dim=128)
    components = 2 if head == "rank1" else 1
    kw = dict(component=0) if head == "rank1" else {}
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (4, 16))
    mask = np.ones((4, 16), np.int32)
    mask[0, 12:] = 0
    x = np.stack([ids, mask], -1).astype(np.int32)

    def jax_module(dtype):
        return JaxBert(classes=5, head_kind=head, components=components, config=JaxBertConfig(**cfg), dtype=dtype)

    def port(dtype):
        return bert.BertClassifier(5, head, components=components, config=bert.DistilBertConfig(**cfg), dtype=dtype,
                                   generator=torch.Generator())

    check_model(monkeypatch, "bert", jax_module(jnp.bfloat16), port(torch.bfloat16), x, torch.from_numpy(x),
                fp32_module=jax_module(jnp.float32), fp32_net=port(None), **kw)
