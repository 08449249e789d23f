"""PyTorch port, models/bert.py + nn/dropout.py + methods/map.py +
models/jax_convert.py::bert_from_jax: the DistilBERT classifier held against
the JAX package on weights carried across.

  * ``Embed`` and ``LayerNorm`` against flax's, and their initializers;
  * ``TransformerBlock``, ``DistilBertEncoder`` and ``BertClassifier`` (the
    ``map`` head, TINY_CONFIG, and dim 768 with 1 layer, FFN 256 and vocab
    512, the shape of tests/test_e2e_amazon_parity.py) at ``train=False``,
    where no dropout is live, with ragged key padding on one row;
  * the encoder with live attention dropout, the JAX encoder running the
    interpreted Pallas kernel (patched in for this test only) in its keep-all
    regime and the port fed all-ones attention masks;
  * ``FixableDropout`` (both branches) and the whole classifier with every
    dropout live (MAP in training, full-model MCD in training and at eval),
    the JAX side's ``jax.random.bernoulli`` replaced, for the test, by a
    numpy feed whose masks the port is handed in the same order;
  * three ``map_method`` Adam steps (the JAX package's ``_tx`` with lr 3e-4
    and weight decay 0.01) against the JAX jitted update.

Tolerances: layers and logits 1e-5 absolute and relative (fp32 matmuls,
softmax and LayerNorm statistics summed in other orders, values of order 1),
3e-5 at dim 768 (sums of 768 products; measured 1.9e-5 on logits near 1.6);
the Adam steps: losses 1e-5 relative and parameters 2e-6 absolute after
three steps of 3e-4 (a step is lr g / (|g| + 1e-8), so gradients that agree
to 1e-5 relative move the parameters alike), but for the ``k_lin`` biases,
whose gradient is 0 in exact arithmetic (the softmax is blind to a shift of
a whole row of scores): Adam turns their rounding-level gradients into steps
of up to lr in either direction on each side, so they are held to 3 lr of
their start.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.methods import LossOutput as JaxLossOutput
from beyond_deep_ensembles_tpu.methods import map_method as jax_map_method
from beyond_deep_ensembles_tpu.models import bert as jax_bert
from beyond_deep_ensembles_tpu.nn.base import Model as JaxModel
from beyond_deep_ensembles_tpu.nn.dropout import FixableDropout as JaxFixableDropout
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.methods.api import LossOutput
from beyond_deep_ensembles_tpu_torch.methods.map import map_method
from beyond_deep_ensembles_tpu_torch.models import bert
from beyond_deep_ensembles_tpu_torch.models.jax_convert import bert_from_jax
from beyond_deep_ensembles_tpu_torch.nn.base import Model
from beyond_deep_ensembles_tpu_torch.nn.dropout import FixableDropout
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_TOL = dict(rtol=3e-5, atol=3e-5)  # dim 768: dot products over 768 and 256 terms
WIDE = dict(vocab_size=512, dim=768, n_layers=1, n_heads=12, hidden_dim=256, max_position_embeddings=64)
SEQ = 16


class BernoulliFeed:
    """Stands in for ``jax.random.bernoulli``: masks from a seeded numpy
    generator, recorded in call order."""

    def __init__(self, seed=0):
        self.rng = np.random.RandomState(seed)
        self.masks = []

    def __call__(self, key, p=0.5, shape=None):
        del key
        mask = self.rng.rand(*shape) < p
        self.masks.append(mask)
        return jnp.asarray(mask)

    def given(self):
        return NoiseSource(given=[torch.from_numpy(m) for m in self.masks])


def _random_params(module, *args, seed=0, **kw):
    """Flax params for ``module`` drawn with numpy: shapes from
    ``jax.eval_shape``, LayerNorm scales near 1, everything else N(0, 0.1)."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args, **kw)
    )["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        z = rng.standard_normal(s.shape).astype(np.float32)
        return 1.0 + 0.1 * z if str(getattr(path[-1], "key", "")) == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def _load(module, params):
    module.load_state_dict(bert_from_jax(_numpy_tree(params)), strict=True)
    return module


def _tokens(batch=2, seq=SEQ, vocab=1024, seed=0):
    """Packed [B, L, 2] int32 input; row 0 pads its last quarter."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[0, 3 * seq // 4 :] = 0
    return np.stack([ids, mask], axis=-1)


def test_embed_and_layer_norm_match_flax():
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.randint(0, 50, size=(3, 5)).astype(np.int32)
    want = fnn.Embed(50, 8).apply({"params": {"embedding": jnp.asarray(table)}}, jnp.asarray(ids))
    emb = bert.Embed(50, 8, generator=torch.Generator().manual_seed(0))
    emb.embedding.data = torch.from_numpy(table)
    assert_close(emb(torch.from_numpy(ids)).detach().numpy(), np.asarray(want), rtol=0, atol=0, err_msg="embed")

    x = (3.0 + rng.standard_normal((4, 6, 32))).astype(np.float32)  # a mean far from 0
    scale, shift = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}}, jnp.asarray(x))
    ln = bert.LayerNorm(32)
    ln.scale.data, ln.bias.data = torch.from_numpy(scale), torch.from_numpy(shift)
    assert_close(ln(torch.from_numpy(x)).detach().numpy(), np.asarray(want), err_msg="layer norm", **TOL)

    big = bert.Embed(30522, 768, generator=torch.Generator().manual_seed(1))
    assert abs(float(big.embedding.std()) * 768**0.5 - 1.0) < 0.01  # flax: N(0, 1/features)
    assert torch.equal(bert.LayerNorm(4).scale.data, torch.ones(4)) and not bert.LayerNorm(4).bias.data.any()


def _block_case():
    kw = dict(dim=64, n_heads=2, hidden_dim=128, dropout=0.1, attention_dropout=0.1)
    x = np.random.RandomState(1).standard_normal((2, SEQ, 64)).astype(np.float32)
    mask = _tokens()[:, :, 1]
    jmod = jax_bert.TransformerBlock(**kw)
    params = _random_params(jmod, jnp.asarray(x), jnp.asarray(mask), False)
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), False)
    port = _load(bert.TransformerBlock(**kw, generator=torch.Generator()), params)
    got = port(torch.from_numpy(x), torch.from_numpy(mask), NoiseSource.seeded(0), train=False)
    return got, want


def _encoder_case():
    packed = _tokens()
    jmod = jax_bert.DistilBertEncoder(jax_bert.TINY_CONFIG)
    args = (jnp.asarray(packed[:, :, 0]), jnp.asarray(packed[:, :, 1]))
    params = _random_params(jmod, *args, train=False)
    want = jmod.apply({"params": params}, *args, train=False)
    port = _load(bert.DistilBertEncoder(bert.TINY_CONFIG, generator=torch.Generator()), params)
    got = port(torch.from_numpy(packed[:, :, 0]), torch.from_numpy(packed[:, :, 1]), NoiseSource.seeded(0), train=False)
    return got, want


def _classifier_case(shape):
    jcfg = jax_bert.TINY_CONFIG if shape == "tiny" else jax_bert.DistilBertConfig(**WIDE)
    pcfg = bert.TINY_CONFIG if shape == "tiny" else bert.DistilBertConfig(**WIDE)
    packed = _tokens(vocab=jcfg.vocab_size)
    jmod = jax_bert.BertClassifier(classes=5, head_kind="map", config=jcfg)
    params = _random_params(jmod, jnp.asarray(packed), train=False)
    want = jmod.apply({"params": params}, jnp.asarray(packed), train=False)
    port = _load(bert.BertClassifier(5, "map", config=pcfg, generator=torch.Generator()), params)
    got = port(torch.from_numpy(packed), NoiseSource.seeded(0), train=False)
    return got, want


@pytest.mark.parametrize("case", ["block", "encoder", "classifier_tiny", "classifier_768"])
def test_model_matches_jax_without_dropout(case):
    if case == "block":
        got, want = _block_case()
    elif case == "encoder":
        got, want = _encoder_case()
    else:
        got, want = _classifier_case(case.split("_")[1])
    assert got.shape == want.shape
    assert_close(got.detach().numpy(), np.asarray(want), err_msg=case, **(WIDE_TOL if case.endswith("768") else TOL))


def test_encoder_attention_dropout_matches_interpreted_kernel(monkeypatch):
    """The JAX encoder with live attention dropout runs the Pallas kernel in
    the TPU interpreter (bits all zero: at p = 0.4 every probability is kept
    and scaled by 1/0.6); the port, fed all-ones attention masks, must match
    it, in training and under mc_dropout at eval."""
    import functools

    from jax.experimental.pallas import tpu as pltpu

    from beyond_deep_ensembles_tpu.ops import attention as jax_attention

    monkeypatch.setattr(jax_bert, "fused_attention_available", lambda l, backend=None: True)
    monkeypatch.setattr(
        jax_bert, "fused_dropout_attention",
        functools.partial(jax_attention.fused_dropout_attention, interpret=pltpu.InterpretParams()),
    )
    seq = 8
    jcfg = jax_bert.DistilBertConfig(vocab_size=64, dim=16, n_layers=2, n_heads=2, hidden_dim=32,
                                     max_position_embeddings=seq, dropout=0.0, attention_dropout=0.4)
    pcfg = bert.DistilBertConfig(vocab_size=64, dim=16, n_layers=2, n_heads=2, hidden_dim=32,
                                 max_position_embeddings=seq, dropout=0.0, attention_dropout=0.4)
    packed = _tokens(seq=seq, vocab=64)
    args = (jnp.asarray(packed[:, :, 0]), jnp.asarray(packed[:, :, 1]))
    jmod = jax_bert.DistilBertEncoder(jcfg, mc_dropout=True)
    params = _random_params(jmod, *args, train=False)
    port = _load(bert.DistilBertEncoder(pcfg, mc_dropout=True, generator=torch.Generator()), params)
    ones = [torch.ones(2, 2, seq, seq, dtype=torch.bool)] * jcfg.n_layers
    for train in (True, False):
        want = jmod.apply({"params": params}, *args, train=train, rngs={"dropout": jax.random.key(3)})
        got = port(torch.from_numpy(packed[:, :, 0]), torch.from_numpy(packed[:, :, 1]),
                   NoiseSource(given=ones), train=train)
        assert_close(got.detach().numpy(), np.asarray(want), err_msg=f"train={train}", rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("freeze_on_eval", [True, False])
def test_fixable_dropout_matches_jax(monkeypatch, freeze_on_eval, train):
    feed = BernoulliFeed()
    monkeypatch.setattr(jax.random, "bernoulli", feed)
    x = np.random.RandomState(5).standard_normal((4, 3, 6)).astype(np.float32)
    want = JaxFixableDropout(0.3, freeze_on_eval=freeze_on_eval).apply(
        {}, jnp.asarray(x), train=train, rngs={"dropout": jax.random.key(0)}
    )
    noise = feed.given()
    got = FixableDropout(0.3, freeze_on_eval=freeze_on_eval)(torch.from_numpy(x), noise, train=train)
    assert noise.draws == 1
    frozen = freeze_on_eval and not train
    assert feed.masks[0].shape == (x.shape[1:] if frozen else x.shape)
    assert_close(got.numpy(), np.asarray(want), rtol=1e-7, err_msg="dropout")
    if frozen:  # one unrescaled mask for the whole batch
        assert np.all((got.numpy() == 0) | (got.numpy() == x))


@pytest.mark.parametrize("variant", ["map_train", "mcd_train", "mcd_eval"])
def test_classifier_with_live_dropout_matches_jax(monkeypatch, variant):
    """Every dropout of the model live and fed the same masks: MAP in training
    (nn.Dropout in the encoder, 0.2 on the head), full-model MCD (every
    dropout FixableDropout without freezing, attention probabilities
    included) in training and at eval."""
    mcd, train = variant.startswith("mcd"), variant.endswith("train")
    head = "drop" if mcd else "map"
    packed = _tokens()
    jmod = jax_bert.BertClassifier(classes=5, head_kind=head, drop_p=0.2, config=jax_bert.TINY_CONFIG,
                                   mc_encoder_dropout=mcd)
    params = _random_params(jmod, jnp.asarray(packed), train=False)
    feed = BernoulliFeed(seed=7)
    monkeypatch.setattr(jax.random, "bernoulli", feed)
    want = jmod.apply({"params": params}, jnp.asarray(packed), train=train, rngs={"dropout": jax.random.key(0)})
    layers = jax_bert.TINY_CONFIG.n_layers
    assert len(feed.masks) == 2 + 2 * layers  # embedding, per layer attention and FFN, head
    assert feed.masks[1].shape == (2, 2, SEQ, SEQ)  # the attention's [B, H, L, L]
    port = _load(bert.BertClassifier(5, head, drop_p=0.2, config=bert.TINY_CONFIG, mc_encoder_dropout=mcd,
                                     generator=torch.Generator()), params)
    noise = feed.given()
    got = port(torch.from_numpy(packed), noise, train=train)
    assert noise.draws == len(feed.masks)
    assert_close(got.detach().numpy(), np.asarray(want), err_msg=variant, **TOL)


def test_bert_from_jax_layouts():
    jmod = jax_bert.BertClassifier(classes=5, head_kind="drop", config=jax_bert.TINY_CONFIG)
    params = _numpy_tree(_random_params(jmod, jnp.asarray(_tokens()), train=False))
    sd = bert_from_jax(params)
    port = bert.BertClassifier(5, "drop", config=bert.TINY_CONFIG, generator=torch.Generator())
    assert sd.keys() == port.state_dict().keys()
    assert torch.equal(sd["bert.layer_1.lin1.kernel"], torch.from_numpy(params["bert"]["layer_1"]["lin1"]["kernel"].T))
    assert torch.equal(sd["bert.word_embeddings.embedding"], torch.from_numpy(params["bert"]["word_embeddings"]["embedding"]))
    assert sd["Dense_1.kernel"].shape == (5, 64) and sd["bert.embed_layer_norm.scale"].shape == (64,)


def test_unported_options_raise():
    gen = torch.Generator()
    with pytest.raises(ValueError):
        bert.BertClassifier(5, "spectral", config=bert.TINY_CONFIG, generator=gen)
    with pytest.raises(NotImplementedError):
        bert.BertClassifier(5, "map", config=bert.TINY_CONFIG, dtype=torch.bfloat16, generator=gen)
    assert bert.DistilBertConfig(remat=True).remat  # ported: tests/test_torch_bert_weights.py


def _jax_loss(model):
    def loss_fn(params, model_state, key, batch):
        x, y = batch
        out, kl, _ = model.apply(params, model_state, key, x, train=False)
        logp = jax.nn.log_softmax(out, axis=-1)
        return JaxLossOutput(loss=-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)), kl=kl, model_state=model_state)

    return loss_fn


def _port_loss(model):
    def loss_fn(params, model_state, noise, batch):
        x, y = batch
        out, kl, _ = model.apply(params, model_state, noise, x, train=False)
        logp = torch.log_softmax(out, dim=-1)
        return LossOutput(loss=-torch.mean(torch.gather(logp, 1, y[:, None])), kl=kl, model_state=model_state)

    return loss_fn


def test_three_map_adam_steps_match_jax():
    config = {"optimizer_kind": "adam", "lr": 3e-4, "weight_decay": 0.01}
    rng = np.random.RandomState(11)
    batches = [(_tokens(batch=4, seed=i), rng.randint(0, 5, 4)) for i in range(3)]
    jmodel = JaxModel(jax_bert.BertClassifier(classes=5, head_kind="map", config=jax_bert.TINY_CONFIG))
    params = _random_params(jmodel.module, jnp.asarray(batches[0][0]), train=False)
    method = jax_map_method(_jax_loss(jmodel), jax_wilds._tx(config))
    state = method.init(jax.random.key(0), params)
    update = jax.jit(method.update)
    losses = []
    for x, y in batches:
        state, m = update(state, jax.random.key(1), (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(m["loss"]))

    module = _load(bert.BertClassifier(5, "map", config=bert.TINY_CONFIG, generator=torch.Generator()), params)
    start = {k: p.detach().clone() for k, p in module.named_parameters()}
    port = map_method(_port_loss(Model(module)), wilds_task._tx(config))
    pstate = port.init(module)
    noise = NoiseSource.seeded(0)
    for (x, y), want in zip(batches, losses):
        pstate, m = port.update(pstate, noise, (torch.from_numpy(x), torch.from_numpy(y)))
        assert_close(float(m["loss"]), want, rtol=1e-5, err_msg="loss")
    assert pstate.step == 3 and port.sample_is_identity and port.sample(pstate)[0] is module

    ref = bert_from_jax(_numpy_tree(state.params))
    for key, p in module.named_parameters():
        got = p.detach().numpy()
        if key.endswith("k_lin.bias"):
            assert np.abs(got - start[key].numpy()).max() <= 3 * config["lr"] * (1 + 1e-6), key
            continue
        assert_close(got, ref[key].numpy(), rtol=0, atol=2e-6, err_msg=key)
