"""PyTorch port, models/bert.py's ``load_hf_weights`` and ``remat``:

  * a HuggingFace-layout DistilBERT state dict (``distilbert.``-prefixed
    keys as ``DistilBertForSequenceClassification`` saves them, or bare
    ``DistilBertModel`` keys; the test writes it at TINY_CONFIG's width with
    the HF head and vocabulary-projection keys the loader leaves alone) goes
    through the JAX package's ``load_hf_weights`` onto ``BertClassifier``'s
    flax parameters and through the port's onto its module: the same
    tensors, bit for bit, and the logits within 1e-5;
  * ``build`` of amazon (MAP, SVGD) and civilcomments (SNGP) with the file
    staged at ``$BDE_DATA_DIR/distilbert-base-uncased/pytorch_model.bin``:
    every member's and particle's encoder equals the file and JAX's built
    one, the heads keep their init; ``pretrained: false`` builds the random
    net;
  * ``remat`` (``bert_remat``): a classifier with every dropout live (MCD's
    head and encoder, key-mode draws) gives the plain form's outputs and
    gradients bit for bit, its recompute drawing the forward's masks again;
    at eval and under ``torch.no_grad`` it runs the plain path.

Tolerances: logits 1e-5 (fp32 sums in another order on each side); the
weights and the remat comparison exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from beyond_deep_ensembles_tpu.experiments import wilds_task as jax_wilds
from beyond_deep_ensembles_tpu.models import bert as jax_bert
from beyond_deep_ensembles_tpu_torch import keys
from beyond_deep_ensembles_tpu_torch.experiments import wilds_task
from beyond_deep_ensembles_tpu_torch.models import bert
from beyond_deep_ensembles_tpu_torch.models.jax_convert import bert_from_jax
from beyond_deep_ensembles_tpu_torch.nn.gaussian import NoiseSource

TINY = dict(vocab_size=1024, dim=64, n_layers=2, n_heads=2, hidden_dim=128)
SEQ = 24


def hf_state_dict(prefix="distilbert.", seed=0, cfg=TINY, positions=512):
    """Random tensors under HF DistilBERT's keys and shapes (``Linear``
    weights ``[out, in]``), with the sequence-classification head's keys."""
    gen = torch.Generator().manual_seed(seed)
    dim, hidden = cfg["dim"], cfg["hidden_dim"]
    sd = {}

    def put(key, *shape, scale=0.1, shift=0.0):
        sd[prefix + key] = shift + scale * torch.randn(*shape, generator=gen)

    put("embeddings.word_embeddings.weight", cfg["vocab_size"], dim)
    put("embeddings.position_embeddings.weight", positions, dim)
    put("embeddings.LayerNorm.weight", dim, shift=1.0)
    put("embeddings.LayerNorm.bias", dim)
    for i in range(cfg["n_layers"]):
        t = f"transformer.layer.{i}."
        for name, (o, n) in {"attention.q_lin": (dim, dim), "attention.k_lin": (dim, dim),
                             "attention.v_lin": (dim, dim), "attention.out_lin": (dim, dim),
                             "ffn.lin1": (hidden, dim), "ffn.lin2": (dim, hidden)}.items():
            put(t + name + ".weight", o, n)
            put(t + name + ".bias", o)
        for name in ("sa_layer_norm", "output_layer_norm"):
            put(t + name + ".weight", dim, shift=1.0)
            put(t + name + ".bias", dim)
    if prefix:  # DistilBertForSequenceClassification's head, which neither loader reads
        sd["pre_classifier.weight"] = torch.randn(dim, dim, generator=gen)
        sd["classifier.weight"] = torch.randn(2, dim, generator=gen)
    return sd


def _stage(tmp_path, sd):
    d = tmp_path / "distilbert-base-uncased"
    d.mkdir(exist_ok=True)
    torch.save(sd, d / "pytorch_model.bin")
    return d


def _example(seed=0, batch=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (batch, SEQ))
    mask = np.ones_like(ids)
    mask[1, SEQ // 2 :] = 0
    return np.stack([ids, mask], axis=-1).astype(np.int32)


@pytest.mark.parametrize("prefix", ["distilbert.", ""], ids=["classifier-file", "model-file"])
def test_load_hf_weights_matches_jax(prefix, tmp_path):
    d = _stage(tmp_path, hf_state_dict(prefix))
    cfg = jax_bert.DistilBertConfig(**TINY)
    module = jax_bert.BertClassifier(classes=5, config=cfg)
    params = jax.jit(lambda k: module.init({"params": k}, jnp.zeros((2, SEQ, 2), jnp.int32), train=False))(
        jax.random.key(0))["params"]
    loaded = jax.tree.map(np.asarray, jax_bert.load_hf_weights(params, str(d)))

    net = bert.BertClassifier(5, config=bert.DistilBertConfig(**TINY), generator=torch.Generator())
    net.load_state_dict(bert_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    bert.load_hf_weights(net, str(d))
    want = bert_from_jax(loaded)
    got = net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["bert.layer_1.lin2.kernel"], bert_from_jax(jax.tree.map(np.asarray, params))[
        "bert.layer_1.lin2.kernel"])

    x = _example()
    ref = np.asarray(jax.jit(lambda p, xx: module.apply({"params": p}, xx, train=False))(loaded, jnp.asarray(x)))
    with torch.no_grad():
        out = net(torch.from_numpy(x), None, train=False).numpy()
    assert_close(out, ref, rtol=1e-5, atol=1e-5, err_msg="logits from the HF weights")


def _encoders(built):
    state = built.state
    members = getattr(state, "members", [state])
    out = []
    for member in members:
        params = member.params
        out += [m.bert for m in (params if isinstance(params, torch.nn.ModuleList) else [params])]
    return out


@pytest.mark.parametrize("task,model,extra", [("amazon", "map", {}), ("amazon", "svgd", {"svgd_particles": 2}),
                                              ("civilcomments", "sngp", {"members": 2})])
def test_build_loads_staged_text_weights(task, model, extra, tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    sd = hf_state_dict(positions=512)
    _stage(tmp_path, sd)
    config = {**wilds_task.DEFAULT_CONFIG, "bert_config": TINY, "model": model, "dataset_size": 8,
              "steps_per_epoch": 2, "optimizer_kind": "adam", **extra}
    jbuilt = jax_wilds.build(task, config, jax.random.key(0), 2)
    jparams = jax.tree.map(np.asarray, jbuilt.state.params)
    if model == "svgd" or extra.get("members", 1) > 1:
        jparams = jax.tree.map(lambda a: a[0], jparams)
    jflat = bert_from_jax(jparams)
    built = wilds_task.build(task, config, torch.Generator().manual_seed(0), 2, device="cpu")
    encoders = _encoders(built)
    assert len(encoders) == {"svgd": 2}.get(model, extra.get("members", 1))
    for enc in encoders:
        named = dict(enc.named_parameters())
        assert torch.equal(named["word_embeddings.embedding"], sd["distilbert.embeddings.word_embeddings.weight"])
        assert torch.equal(named["layer_1.lin1.kernel"], sd["distilbert.transformer.layer.1.ffn.lin1.weight"])
        for name, p in named.items():
            assert torch.equal(p.detach(), jflat["bert." + name]), name
    random = wilds_task.build(task, {**config, "pretrained": False}, torch.Generator().manual_seed(0), 2,
                              device="cpu")
    assert not torch.equal(_encoders(random)[0].word_embeddings.embedding,
                           sd["distilbert.embeddings.word_embeddings.weight"])


def _classifier(remat):
    cfg = bert.DistilBertConfig(**TINY, remat=remat)
    return bert.BertClassifier(5, head_kind="drop", config=cfg, mc_encoder_dropout=True,
                               generator=torch.Generator().manual_seed(4))


def test_remat_equals_the_plain_form():
    x = torch.from_numpy(_example(batch=4))
    w = torch.randn(4, 5, generator=torch.Generator().manual_seed(1))
    runs = []
    for remat in (False, True):
        net = _classifier(remat)
        noise = NoiseSource(key=keys.as_key(keys.fold_in(3, 1), "cpu"))
        out = net(x, noise, train=True)
        (out * w).sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in net.named_parameters()}, noise.draws))
        with torch.no_grad():  # eval and no-grad passes take the plain path
            evals = [net(x, NoiseSource(key=keys.as_key(7, "cpu")), train=train) for train in (False, True)]
        runs[-1] += (evals,)
    (out0, g0, d0, e0), (out1, g1, d1, e1) = runs
    assert d0 == d1 > 0
    assert torch.equal(out0, out1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0), [
        k for k in g0 if not torch.equal(g0[k], g1[k])]
    assert all(torch.equal(a, b) for a, b in zip(e0, e1))
    assert wilds_task._bert_config({"bert_remat": True}).remat
    assert not wilds_task._bert_config({"bert_remat": True, "tiny": True}).remat  # as JAX: TINY_CONFIG as it is
