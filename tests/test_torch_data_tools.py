"""PyTorch port, data/prepare.py and data/text.py against the JAX package's
(numpy on both sides, so every comparison is for equality):

  * a WILDS cache written by either package (an image task, poverty's
    regression targets and fold file, a text task) loads through both
    packages' ``load_wilds`` to the same arrays, and ``verify_cache``
    reports the same on both; the writers refuse the same bad input;
  * a UCI cache, and ``prepare_uci`` from a raw ``.data`` file, give both
    packages' ``UCIDataset`` the same splits;
  * ``prepare_wilds`` exits with JAX's message where the ``wilds`` package
    is absent; ``_resize_chw_image``; ``main``'s ``uci`` and ``verify``;
  * ``HashTokenizer``, ``get_tokenizer`` (a vocabulary staged under
    ``$BDE_DATA_DIR/distilbert-base-uncased``, read with
    ``local_files_only``, or the hash fallback) and ``pack_text`` give the
    same ids."""
import numpy as np
import pytest

import _torch_parity  # noqa: F401 (caps torch at one intra-op thread)
from beyond_deep_ensembles_tpu.data import prepare as jax_prepare
from beyond_deep_ensembles_tpu.data import text as jax_text
from beyond_deep_ensembles_tpu.data import uci as jax_uci
from beyond_deep_ensembles_tpu.data import wilds as jax_wilds_data
from beyond_deep_ensembles_tpu_torch.data import prepare, text, uci, wilds

TEXTS = ["The movie was GOOD!", "bad, bad plot... 10/10 wouldn't watch", "", "über naïve café " * 40]


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("BDE_DATA_DIR", str(tmp_path))
    return tmp_path


def _arrays(task, n, seed=0):
    spec = wilds.TASKS[task]
    rng = np.random.RandomState(seed)
    if spec.text:
        x = rng.randint(0, 1000, (n,) + spec.input_shape).astype(np.int64)
    else:
        x = rng.randint(0, 256, (n,) + spec.input_shape).astype(np.uint8) if spec.unit_interval else (
            rng.standard_normal((n,) + spec.input_shape).astype(np.float32) * 2)
    y = rng.standard_normal(n) if spec.classes == 1 else rng.randint(0, spec.classes, n)
    return x, y, rng.randint(0, 2, (n, 8 if task == "civilcomments" else 1))


def _same_load(task, split, fold=None):
    mine = wilds.load_wilds(task, split, fold=fold)
    ref = jax_wilds_data.load_wilds(task, split, fold=fold)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return mine


@pytest.mark.parametrize("task,split,fold", [("camelyon17", "test", None), ("poverty", "train", "C"),
                                             ("civilcomments", "val", None)])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wilds_cache_loads_the_same_through_both(root, task, split, fold, writer):
    x, y, meta = _arrays(task, 3)
    write = (prepare if writer == "port" else jax_prepare).write_wilds_cache
    name = f"{split}_fold{fold}" if fold else split
    path = write(task, name, x, y, meta)
    assert path == str(root / "wilds" / f"{task}_{name}.npz")
    xl, yl, ml = _same_load(task, split, fold)
    spec = wilds.TASKS[task]
    assert yl.shape == ((3, 1) if spec.classes == 1 else (3,)) and ml.dtype == np.int64
    if spec.unit_interval and not spec.text:
        assert xl.max() <= 1.0  # uint8 images rescaled to [0, 1]
    assert prepare.verify_cache(log=lambda *_: None) == jax_prepare.verify_cache(log=lambda *_: None)


def test_writers_refuse_the_same_input(root):
    for module in (prepare, jax_prepare):
        with pytest.raises(ValueError, match="shape"):
            module.write_wilds_cache("camelyon17", "test", np.zeros((2, 32, 32, 3)), np.zeros(2), np.zeros((2, 1)))
        with pytest.raises(ValueError, match="labels"):
            module.write_wilds_cache("camelyon17", "test", np.zeros((2, 96, 96, 3)), np.array([0, 5]), np.zeros(2))
        with pytest.raises(ValueError, match="length"):
            module.write_wilds_cache("camelyon17", "test", np.zeros((2, 96, 96, 3)), np.zeros(2), np.zeros((3, 1)))
    (root / "wilds").mkdir()
    (root / "wilds" / "mnist_test.npz").write_bytes(b"")
    (root / "wilds" / "fmow_val.npz").write_bytes(b"not an npz")
    report = prepare.verify_cache(log=lambda *_: None)
    assert report == jax_prepare.verify_cache(log=lambda *_: None)
    assert report["wilds/mnist_test.npz"] == "unknown task 'mnist'" and report["wilds/fmow_val.npz"] != "ok"


def _same_uci(name):
    mine, ref = uci.UCIDataset(name), jax_uci.UCIDataset(name)
    for split in ("train", "test", "val_train", "val_test"):
        for a, b in zip(mine.get_arrays(split), ref.get_arrays(split)):
            assert np.array_equal(a, b), split


def test_uci_cache_and_raw_file(root):
    rng = np.random.RandomState(1)
    x, y = rng.standard_normal((40, 13)), rng.standard_normal(40)
    assert prepare.write_uci_cache("housing", x, y) == str(root / "uci" / "housing.npz")
    _same_uci("housing")
    raw = root / "energy.data"
    rows = np.concatenate([rng.standard_normal((30, 8)), rng.standard_normal((30, 1))], axis=1)
    raw.write_text("x1,x2,x3,x4,x5,x6,x7,x8,y\n" + "\n".join(",".join(f"{v:.6f}" for v in r) for r in rows) + "\n")
    jax_path = jax_prepare.prepare_uci("energy", raw_path=str(raw), out_root=str(root / "jax"), log=lambda *_: None)
    prepare.main(["uci", "energy", "--raw", str(raw)])
    with np.load(jax_path) as want, np.load(root / "uci" / "energy.npz") as got:
        assert np.array_equal(got["x"], want["x"]) and np.array_equal(got["y"], want["y"])
    _same_uci("energy")
    with pytest.raises(SystemExit, match="no `uci_datasets` package and no raw file"):
        prepare.prepare_uci("yacht", log=lambda *_: None)


def test_prepare_wilds_without_the_package_and_verify(root):
    with pytest.raises(SystemExit) as ref:
        jax_prepare.prepare_wilds("camelyon17", log=lambda *_: None)
    with pytest.raises(SystemExit) as mine:
        prepare.prepare_wilds("camelyon17", log=lambda *_: None)
    assert str(mine.value) == str(ref.value) and "`wilds` package is not installed" in str(mine.value)
    prepare.main(["verify"])  # nothing staged: nothing wrong
    prepare.write_uci_cache("yacht", np.zeros((4, 6)), np.zeros(4))
    np.savez_compressed(root / "uci" / "naval.npz", x=np.zeros((4, 2)), y=np.zeros((3, 1)))
    with pytest.raises(SystemExit):
        prepare.main(["verify"])


def test_resize_matches_jax():
    img = np.random.RandomState(2).randint(0, 256, (37, 51, 3)).astype(np.uint8)
    for hw in ((96, 96), (20, 30), (37, 51)):
        want = jax_prepare._resize_chw_image(img, hw)
        got = prepare._resize_chw_image(img, hw)
        assert got.dtype == np.float32 and np.array_equal(got, want), hw


def test_hash_tokenizer_and_pack_text_match_jax(root):
    for length in (8, 64):
        for a, b in zip(text.HashTokenizer()(TEXTS, length), jax_text.HashTokenizer()(TEXTS, length)):
            assert a.dtype == np.int32 and np.array_equal(a, b)
    # nothing staged: both fall back to the hash tokenizer
    assert isinstance(text.get_tokenizer(), text.HashTokenizer)
    packed = text.pack_text(TEXTS, 16)
    assert packed.shape == (4, 16, 2) and np.array_equal(packed, jax_text.pack_text(TEXTS, 16))


def test_staged_vocabulary_matches_jax(root):
    pytest.importorskip("transformers")
    staged = root / "distilbert-base-uncased"
    staged.mkdir()
    (staged / "vocab.txt").write_text("\n".join(["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                                                 "the", "movie", "was", "good", "bad", "!", ",", "."]) + "\n")
    mine, ref = text.get_tokenizer(), jax_text.get_tokenizer()
    assert not isinstance(mine, text.HashTokenizer)
    for a, b in zip(mine(TEXTS, 12), ref(TEXTS, 12)):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    assert np.array_equal(text.pack_text(TEXTS, 12, mine), jax_text.pack_text(TEXTS, 12, ref))
