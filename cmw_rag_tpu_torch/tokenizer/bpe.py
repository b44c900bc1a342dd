"""Byte-level BPE tokenizer, pure Python (copy of ``cmw_rag_tpu/tokenizer/bpe.py``).

Token ids equal the JAX package's tokenizer on the same vocabulary: the same
cl100k-style split pattern and the same greedy lowest-rank-first merge. The
native ``g++`` fast path and the settings lookup are not carried over; the
bundled vocabulary is read by path from the JAX package's asset directory.
"""

from __future__ import annotations

import base64
import functools
import json
import re
from pathlib import Path
from typing import Iterable, Optional

from cmw_rag_tpu_torch.device import REPO_ROOT

_PAT_STR = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"
    r"|(?:(?![\r\n])[\W_])?[^\W\d_]+"
    r"|\d{1,3}"
    r"| ?(?:(?![\s])[\W_])+[\r\n]*"
    r"|\s*[\r\n]+"
    r"|\s+(?!\S)"
    r"|\s+"
)

DEFAULT_SPECIAL_TOKENS = (
    "<|endoftext|>",
    "<|im_start|>",
    "<|im_end|>",
    "<|pad|>",
)

DEFAULT_VOCAB = REPO_ROOT / "cmw_rag_tpu" / "tokenizer" / "assets" / "cmw_bpe_16k.json"


def _merge_pretoken(piece: bytes, ranks: dict[bytes, int]) -> list[int]:
    """Greedy BPE: repeatedly merge the adjacent pair with the lowest rank."""
    if len(piece) == 1:
        return [ranks[piece]]
    parts: list[bytes] = [piece[i : i + 1] for i in range(len(piece))]
    while True:
        best_rank = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank = r
                best_i = i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts]


class BPETokenizer:
    def __init__(self, ranks: dict[bytes, int], pattern: str = _PAT_STR,
                 special_tokens: Optional[dict[str, int]] = None):
        self._ranks = ranks
        self._pattern = re.compile(pattern)
        if special_tokens is None:
            base = max(ranks.values()) + 1
            special_tokens = {s: base + i
                              for i, s in enumerate(DEFAULT_SPECIAL_TOKENS)}
        self._special = special_tokens
        self._special_pattern = (
            re.compile("|".join(re.escape(s) for s in
                                sorted(special_tokens, key=len, reverse=True)))
            if special_tokens else None)
        self._decoder: dict[int, bytes] = {v: k for k, v in ranks.items()}
        for s, tid in special_tokens.items():
            self._decoder[tid] = s.encode("utf-8")
        self._encode_piece = functools.lru_cache(maxsize=65536)(
            self._encode_piece_uncached)

    @property
    def n_vocab(self) -> int:
        return max(self._decoder) + 1

    @property
    def special_tokens(self) -> dict[str, int]:
        return dict(self._special)

    def _encode_piece_uncached(self, piece: bytes) -> tuple[int, ...]:
        tok = self._ranks.get(piece)
        if tok is not None:
            return (tok,)
        return tuple(_merge_pretoken(piece, self._ranks))

    def _encode_ordinary(self, text: str) -> list[int]:
        out: list[int] = []
        for m in self._pattern.finditer(text):
            out.extend(self._encode_piece(m.group().encode("utf-8")))
        return out

    def encode(self, text: str,
               allowed_special: Iterable[str] | str = ()) -> list[int]:
        """Encode text. Special-token strings in the input are encoded as
        ordinary text unless listed in ``allowed_special`` (or ``"all"``)."""
        allowed = (set(self._special) if allowed_special == "all"
                   else set(allowed_special))
        if not self._special_pattern:
            return self._encode_ordinary(text)
        out: list[int] = []
        pos = 0
        for m in self._special_pattern.finditer(text):
            s = m.group()
            if s not in allowed:
                continue
            out.extend(self._encode_ordinary(text[pos : m.start()]))
            out.append(self._special[s])
            pos = m.end()
        out.extend(self._encode_ordinary(text[pos:]))
        return out

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self._decoder[i] for i in ids)

    def count(self, text: str) -> int:
        """Exact token count of ``text`` encoded as ordinary text."""
        return sum(len(self._encode_piece(m.group().encode("utf-8")))
                   for m in self._pattern.finditer(text))

    @classmethod
    def load(cls, path: str | Path) -> "BPETokenizer":
        payload = json.loads(Path(path).read_text(encoding="utf-8"))
        ranks = {base64.b64decode(t): i
                 for i, t in enumerate(payload["tokens_b64"]) if t is not None}
        return cls(ranks, payload.get("pattern", _PAT_STR),
                   payload.get("special_tokens"))


@functools.lru_cache(maxsize=4)
def _load_cached(path: str) -> BPETokenizer:
    return BPETokenizer.load(path)


def get_tokenizer(vocab_path: str | Path | None = None) -> BPETokenizer:
    """The bundled bilingual vocabulary unless ``vocab_path`` is given."""
    return _load_cached(str(vocab_path or DEFAULT_VOCAB))
