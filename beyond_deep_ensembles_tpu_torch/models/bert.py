"""DistilBERT classifier with swappable Bayesian heads, and the SNGP text
model.

Counterpart of ``beyond_deep_ensembles_tpu/models/bert.py`` (reference
src/architectures/bert.py: HF ``DistilBertModel`` backbone + a 2-layer head
768 -> 768 -> classes): a post-LN transformer with GELU FFN and learned
positions, distilbert-base's shape by default (dim 768, 6 layers, 12 heads,
FFN 3072, 512 positions). The input packs (input_ids, attention_mask) as one
int tensor ``[B, L, 2]`` and the first token feeds the head.

Every attention goes through K3 (``ops/attention.py``): with dropout live on
the probabilities at rate ``attention_dropout`` (train, or every pass under
``mc_dropout``) with a seed or a given mask from the forward's
:class:`~..nn.gaussian.NoiseSource`; with none live at p = 0, where the JAX
package calls ``jax.nn.dot_product_attention``. Dropout sits, as in HF
DistilBERT, after the embedding LayerNorm and after ``lin2`` (rate
``dropout``), and on the attention probabilities; there is none after
``out_lin``.

flax's ``nn.Embed``, ``nn.LayerNorm`` and ``nn.Dense`` become :class:`Embed`,
:class:`LayerNorm` and :class:`Dense` (``nn/plain.py``), with flax's initializers,
and submodules carry the flax names, so that ``models/jax_convert.py::
bert_from_jax`` maps a flax param tree onto the state_dict. The head is
two layers of one kind (``models/layers.py::make_dense``: plain, BBB or
Rank-1 with ``components``), named as flax names them (``Dense_0``,
``BBBDense_1``, ``Rank1Dense_0``), kept in fp32. :class:`BertSNGP` is the
encoder under an ``SNGPHead`` on the first token (the JAX package's text
``BertSNGP``, ``experiments/wilds_task.py:568-583``). ``remat`` (JAX
``nn.remat`` of each block, ``bert_remat``) runs each transformer block in
training under ``torch.utils.checkpoint`` with ``NoiseSource.replay``, so
the recompute in the backward draws the forward's masks and K3 seeds:
outputs and gradients equal the plain form's. :func:`load_hf_weights` fills
the encoder from a staged HuggingFace ``pytorch_model.bin``.

``dtype`` is the encoder's compute dtype (JAX ``models/bert.py:94-204``;
bf16 under ``compute_dtype: bf16``, parameters fp32): the embeddings, every
``Dense`` and every ``LayerNorm`` (fp32 statistics) compute and return it, so
q, k and v reach K3 in bf16 (its plain version on the CPU); the first
token's hidden state is cast to fp32 for the head (JAX ``:223``), and the
head computes in fp32. :class:`BertSNGP` takes no dtype, as the JAX
package's text SNGP model passes none.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.base import add_auto_named
from ..nn.dropout import FixableDropout, dropout
from ..nn.plain import Dense, LayerNorm
from ..nn.sngp import SNGPHead
from ..ops.attention import fused_dropout_attention
from .layers import call_layer, make_dense, rematerialized


class DistilBertConfig:
    def __init__(
        self,
        vocab_size: int = 30522,
        dim: int = 768,
        n_layers: int = 6,
        n_heads: int = 12,
        hidden_dim: int = 3072,
        max_position_embeddings: int = 512,
        dropout: float = 0.1,
        attention_dropout: float = 0.1,
        remat: bool = False,
    ):
        self.remat = remat
        self.vocab_size = vocab_size
        self.dim = dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.hidden_dim = hidden_dim
        self.max_position_embeddings = max_position_embeddings
        self.dropout = dropout
        self.attention_dropout = attention_dropout


TINY_CONFIG = DistilBertConfig(vocab_size=1024, dim=64, n_layers=2, n_heads=2, hidden_dim=128)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` ``[num_embeddings, features]``, drawn
    N(0, 1/features) (flax's ``variance_scaling(1, 'fan_in', 'normal')``),
    looked up in ``dtype`` (the table cast to it, as flax promotes it)."""

    def __init__(self, num_embeddings: int, features: int, dtype=None, *, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, features, generator=generator) / math.sqrt(features)
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.embedding if self.dtype is None else self.embedding.to(self.dtype)
        return F.embedding(ids.long(), table)


class TransformerBlock(nn.Module):
    """Post-LN block: attention -> add & LN -> FFN -> add & LN.

    ``mc_dropout``: the block's dropouts stay active (rescaled, per example)
    at eval, the reference's full-model MC-Dropout (``patch_dropout(model,
    False)`` on every nn.Dropout of the HF model, amazon/models.py:73)."""

    def __init__(self, dim: int, n_heads: int, hidden_dim: int, dropout: float,
                 attention_dropout: float = 0.0, mc_dropout: bool = False, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.mc_dropout = mc_dropout
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            self.add_module(name, Dense(dim, dim, dtype=dtype, generator=generator))
        self.sa_layer_norm = LayerNorm(dim, dtype=dtype)
        self.lin1 = Dense(dim, hidden_dim, dtype=dtype, generator=generator)
        self.lin2 = Dense(hidden_dim, dim, dtype=dtype, generator=generator)
        self.output_layer_norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x, mask, noise, train: bool = True):
        b, l, dim = x.shape
        heads = (b, l, self.n_heads, dim // self.n_heads)
        q = self.q_lin(x).reshape(heads)
        k = self.k_lin(x).reshape(heads)
        v = self.v_lin(x).reshape(heads)
        if self.attention_dropout > 0 and (train or self.mc_dropout):
            attn = noise.attention(q, k, v, mask, self.attention_dropout)
        else:
            attn = fused_dropout_attention(q, k, v, mask)
        x = self.sa_layer_norm(x + self.out_lin(attn.reshape(b, l, dim)))
        h = self.lin2(F.gelu(self.lin1(x)))  # exact GELU, as flax's approximate=False
        if self.dropout > 0 and (train or self.mc_dropout):
            h = dropout(h, self.dropout, noise)
        return self.output_layer_norm(x + h)


class DistilBertEncoder(nn.Module):
    def __init__(self, config: DistilBertConfig, mc_dropout: bool = False, dtype=None, *,
                 generator: torch.Generator):
        super().__init__()
        self.config = config
        self.mc_dropout = mc_dropout
        self.word_embeddings = Embed(config.vocab_size, config.dim, dtype=dtype, generator=generator)
        self.position_embeddings = Embed(config.max_position_embeddings, config.dim, dtype=dtype,
                                         generator=generator)
        self.embed_layer_norm = LayerNorm(config.dim, dtype=dtype)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", TransformerBlock(
                config.dim, config.n_heads, config.hidden_dim, config.dropout,
                attention_dropout=config.attention_dropout, mc_dropout=mc_dropout, dtype=dtype,
                generator=generator,
            ))

    def forward(self, input_ids, attention_mask, noise, train: bool = True):
        cfg = self.config
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        h = self.embed_layer_norm(self.word_embeddings(input_ids) + self.position_embeddings(pos)[None])
        if cfg.dropout > 0 and (train or self.mc_dropout):
            h = dropout(h, cfg.dropout, noise)
        # remat only where a backward follows: not at eval, not under
        # torch.func (the Laplace GGN's jacrev takes no checkpoint)
        remat = cfg.remat and train and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                h = rematerialized(lambda h, block=block: block(h, attention_mask, noise, train), noise, h)
            else:
                h = block(h, attention_mask, noise, train)
        return h


class BertClassifier(nn.Module):
    """Reference BertClassifier (bert.py:10-51) with ``head_kind`` ``map``
    (dropout 0.2 in training only), ``drop`` (``FixableDropout(drop_p,
    freeze_on_eval=False)``, active at eval too: the text tasks patch dropout
    with freeze_on_eval=False, civilcomments/models.py:69,
    amazon/models.py:71-73), ``bbb`` (two ``BBBDense``) or ``rank1`` (two
    ``Rank1Dense`` of ``components``, the forward's ``component`` threaded
    to both; JAX ``models/bert.py:235-253``), the last two with the
    training-only dropout 0.2. ``mc_encoder_dropout`` keeps the encoder's
    dropouts sampling at eval (full-model MC-Dropout)."""

    def __init__(self, classes: int, head_kind: str = "map", drop_p: float = 0.2, components: int = 1,
                 config: Optional[DistilBertConfig] = None, mc_encoder_dropout: bool = False,
                 dtype=None, *, generator: torch.Generator):
        super().__init__()
        if head_kind not in ("map", "drop", "bbb", "rank1"):
            raise ValueError(f"unknown head kind {head_kind!r}")
        cfg = config or DistilBertConfig()
        self.head_kind = head_kind
        kind = {"map": "plain", "drop": "plain"}.get(head_kind, head_kind)
        self.bert = DistilBertEncoder(cfg, mc_dropout=mc_encoder_dropout, dtype=dtype, generator=generator)
        first = add_auto_named(self, make_dense(kind, cfg.dim, cfg.dim, components=components, generator=generator))
        self.head_dropout = FixableDropout(drop_p, freeze_on_eval=False)
        second = add_auto_named(self, make_dense(kind, cfg.dim, classes, components=components, generator=generator))
        # a tuple keeps the references out of the state_dict (one key per parameter)
        self._head = (first, second)

    def forward(self, packed_input, noise, train: bool = True, component=None):
        first, second = self._head
        hidden = self.bert(packed_input[:, :, 0], packed_input[:, :, 1], noise, train)
        # the head is a tiny fraction of the flops: fp32 logits (JAX :223)
        cls = hidden[:, 0]
        h = F.relu(call_layer(first, cls.to(torch.promote_types(cls.dtype, torch.float32)), noise, train, component))
        if self.head_kind == "drop":
            h = self.head_dropout(h, noise, train)
        elif train:
            h = dropout(h, 0.2, noise)
        return call_layer(second, h, noise, train, component)


class BertSNGP(nn.Module):
    """The text SNGP model (reference civilcomments SNGP model; JAX
    ``experiments/wilds_task.py:568-583``): the encoder, then
    ``SNGPHead(**sngp_kwargs)`` on the first token's hidden state.
    ``forward(x, noise, train, n_samples)``: training logits ``[B, O]``; at
    eval the head's output for ``n_samples``."""

    def __init__(self, classes: int, config: Optional[DistilBertConfig] = None, sngp_kwargs: Optional[dict] = None,
                 *, generator: torch.Generator):
        super().__init__()
        cfg = config or DistilBertConfig()
        self.bert = DistilBertEncoder(cfg, generator=generator)
        self.SNGPHead_0 = SNGPHead(cfg.dim, classes, **(sngp_kwargs or {}), generator=generator)

    def forward(self, packed_input, noise=None, train: bool = True, n_samples: int = 1):
        hidden = self.bert(packed_input[:, :, 0], packed_input[:, :, 1], noise, train)
        return self.SNGPHead_0(hidden[:, 0], noise, train=train, n_samples=n_samples)


# HF DistilBERT's names for the encoder's layers (JAX ``load_hf_weights``)
_HF_LAYER = (("q_lin", "attention.q_lin"), ("k_lin", "attention.k_lin"), ("v_lin", "attention.v_lin"),
             ("out_lin", "attention.out_lin"), ("lin1", "ffn.lin1"), ("lin2", "ffn.lin2"),
             ("sa_layer_norm", "sa_layer_norm"), ("output_layer_norm", "output_layer_norm"))


@torch.no_grad()
def load_hf_weights(module: nn.Module, hf_dir: str) -> nn.Module:
    """``module.bert`` (a :class:`BertClassifier`'s or :class:`BertSNGP`'s
    encoder) filled in place from the HuggingFace distilbert-base-uncased
    checkpoint ``<hf_dir>/pytorch_model.bin`` (JAX ``models/bert.py::
    load_hf_weights``): the embeddings, the embedding LayerNorm and every
    block's linears and LayerNorms, with or without the ``distilbert.``
    prefix; the head keeps its init. torch's ``Linear.weight`` is the port's
    ``[out, in]`` kernel, so a tensor moves as it is. Read with
    ``torch.load(weights_only=True)``."""
    sd = torch.load(os.path.join(hf_dir, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    pre = "distilbert." if any(k.startswith("distilbert.") for k in sd) else ""
    enc = module.bert
    pairs = [(enc.word_embeddings.embedding, "embeddings.word_embeddings.weight"),
             (enc.position_embeddings.embedding, "embeddings.position_embeddings.weight"),
             (enc.embed_layer_norm.scale, "embeddings.LayerNorm.weight"),
             (enc.embed_layer_norm.bias, "embeddings.LayerNorm.bias")]
    for i in range(enc.config.n_layers):
        block = getattr(enc, f"layer_{i}")
        for ours, theirs in _HF_LAYER:
            layer = getattr(block, ours)
            first = layer.kernel if hasattr(layer, "kernel") else layer.scale
            pairs += [(first, f"transformer.layer.{i}.{theirs}.weight"), (layer.bias, f"transformer.layer.{i}.{theirs}.bias")]
    for param, key in pairs:
        value = sd[pre + key]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{key}: {tuple(value.shape)} does not fit {tuple(param.shape)}")
        param.copy_(value.to(param.dtype))
    return module
