"""Word-level signed-hash block (copy of ``cmw_rag_tpu/retrieval/wordhash.py``).

Whole (RU-stemmed) words hashed into a unit vector with uniform weights. It
is host string work: the fused pipeline takes the query word-block vector as
an input computed in ``FusedPipeline.tokenize_queries``, and document
vectors carry the block from ``embed_documents``.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

#: word-id domain: largest prime below 2^15 (same contract as BIGRAM_MOD —
#: ids stay exact under the int32 multiply-shift bucket hash)
WORD_MOD = 32749

_WORD_RE = re.compile(r"[a-zа-яё0-9]+")

#: RU inflectional endings, longest-match-first. A deliberately light
#: stemmer (Porter-ru's high-frequency suffix subset): fold case/number/
#: person variance, never strip below 3 chars of stem.
_RU_SUFFIXES = sorted(
    ["иями", "ями", "ами", "ией", "иям", "иях", "ого", "его", "ому",
     "ему", "ыми", "ими", "ешь", "ете", "ует", "уют", "ать", "ять",
     "ить", "еть", "ой", "ей", "ов", "ев", "ий", "ый", "ая", "яя",
     "ое", "ее", "ах", "ях", "ам", "ям", "ом", "ем", "ет", "ут", "ют",
     "ит", "ат", "ят", "ся", "сь", "ть", "а", "я", "о", "е",
     "ы", "и", "у", "ю", "ь"],
    key=len, reverse=True)

_CYR = re.compile(r"[а-яё]")


def ru_stem(word: str) -> str:
    """Strip one RU inflectional ending (longest match, stem >= 3 chars).
    Non-Cyrillic words pass through unchanged."""
    if not _CYR.search(word):
        return word
    for suf in _RU_SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            return word[: -len(suf)]
    return word


def word_ids(text: str) -> list[int]:
    """Stemmed lowercase words → FNV-1a ids in [0, WORD_MOD)."""
    out: list[int] = []
    for w in _WORD_RE.findall(text.lower()):
        w = ru_stem(w)
        h = 2166136261
        for ch in w.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        out.append(h % WORD_MOD)
    return out


class WordHasher:
    """Signed-hash bag-of-words → unit vector [dim], UNIFORM weights.

    Same multiply-shift bucket/sign hash and log1p tf-dampening as
    ``LexicalHasher`` but weight 1.0 per occurrence: word features are
    intrinsically rare; idf weighting measured strictly worse (module
    docstring)."""

    def __init__(self, dim: int):
        self.dim = dim

    def vectors_from_ids(self, id_rows: Sequence[Sequence[int]]) -> np.ndarray:
        out = np.zeros((len(id_rows), self.dim), np.float32)
        for i, row in enumerate(id_rows):
            if not len(row):
                continue
            ids = np.asarray(row, np.uint64)
            buckets = ((ids * np.uint64(2654435761)) >> np.uint64(16)) \
                % np.uint64(self.dim)
            signs = np.where(((ids * np.uint64(40503)) >> np.uint64(7))
                             & np.uint64(1), 1.0, -1.0).astype(np.float32)
            raw = np.zeros(self.dim, np.float32)
            np.add.at(raw, buckets.astype(np.int64), signs)
            v = np.sign(raw) * np.log1p(np.abs(raw))
            n = np.linalg.norm(v)
            out[i] = v / n if n > 0 else v
        return out

    def vectors(self, texts: Sequence[str]) -> np.ndarray:
        return self.vectors_from_ids([word_ids(t) for t in texts])
