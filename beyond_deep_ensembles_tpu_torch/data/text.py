"""Text tokenization for the DistilBERT tasks.

Counterpart of ``beyond_deep_ensembles_tpu/data/text.py`` (numpy only, the
same ids). Reference experiments/base/wilds1.py:159-174: HF DistilBERT tokenizer,
fixed max length (300 for CivilComments, 512 for Amazon), packing
(input_ids, attention_mask) into one [L, 2] int tensor per example.

Offline-friendly: uses the HF tokenizer when the ``transformers`` package
is installed and its vocab files are staged under
``$BDE_DATA_DIR/distilbert-base-uncased`` (or in the HF cache; never
downloaded: ``local_files_only``); otherwise a deterministic hash tokenizer
with the same interface stands in (sufficient for pipeline tests, not for
pretrained-weight inference).
"""
from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from .uci import data_dir

_WORD_RE = re.compile(r"[a-z0-9']+|[^\sa-z0-9']")


class HashTokenizer:
    """Deterministic fallback tokenizer (CLS=101, SEP=102, PAD=0 like
    BERT's conventions; words hashed into the vocab range). Uses crc32,
    NOT Python's hash(): the latter is salted per process, which would
    assign different token ids to the same word across CLI invocations —
    a checkpoint trained in one process would be evaluated on scrambled
    inputs in the next."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def __call__(self, texts: List[str], max_length: int):
        import zlib

        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            toks = [101] + [
                1000 + (zlib.crc32(w.encode()) % (self.vocab_size - 2000))
                for w in _WORD_RE.findall(text.lower())
            ][: max_length - 2] + [102]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


def get_tokenizer():
    local = os.path.join(data_dir(), "distilbert-base-uncased")
    try:
        from transformers import DistilBertTokenizerFast

        src = local if os.path.isdir(local) else "distilbert-base-uncased"
        tok = DistilBertTokenizerFast.from_pretrained(src, local_files_only=True)

        def tokenize(texts, max_length):
            out = tok(
                list(texts),
                padding="max_length",
                truncation=True,
                max_length=max_length,
                return_tensors="np",
            )
            return out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.int32)

        return tokenize
    except Exception:
        return HashTokenizer()


def pack_text(texts: List[str], max_length: int, tokenizer=None) -> np.ndarray:
    """[N, L, 2] packed (input_ids, attention_mask) — the BertClassifier
    input format (reference wilds1.py:159-174, bert.py:46-51)."""
    tokenize = tokenizer or get_tokenizer()
    ids, mask = tokenize(texts, max_length)
    return np.stack([ids, mask], axis=-1)
