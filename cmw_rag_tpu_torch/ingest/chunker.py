"""Token-aware, code-fence-safe recursive text splitting (copy of
``cmw_rag_tpu/ingest/chunker.py``, on the port's ``tokenizer/bpe.py``).

Capability parity with the reference chunker (cmw-rag ``rag_engine/core/
chunker.py:16-36``): recursive splitting with the separator priority list
``["\\n\\n```", "\\n\\n### ", "\\n\\n## ", "\\n\\n# ", "\\n\\n", "\\n", " ", ""]``
measured in exact BPE tokens (prod shape: chunk 768 / overlap 75). Separators
are re-attached as prefixes of the following piece so headings stay with their
section and code fences stay with their block; oversize leaf pieces fall back
to exact token-window slicing.

Deterministic: chunk boundaries feed stable chunk IDs (see ``indexer.py``), so
this splitter must produce identical output for identical input + vocab.
"""

from __future__ import annotations

from typing import Callable, Sequence

SEPARATORS: tuple[str, ...] = (
    "\n\n```",
    "\n\n### ",
    "\n\n## ",
    "\n\n# ",
    "\n\n",
    "\n",
    " ",
    "\t",   # tab-separated runs must split at the tab, not mid-word
    "",
)


def _token_window_split(
    text: str, chunk_size: int, overlap: int, tokenizer
) -> list[str]:
    """Last resort: slice by exact token windows with overlap.

    A decoded id-window can RE-encode to more tokens than the slice held
    (BPE merges depend on surrounding context), so each piece is shrunk
    until ``count(decode(window)) <= chunk_size`` holds on the final string
    — the contract chunk IDs and encoder windows rely on."""
    ids = tokenizer.encode(text)
    if len(ids) <= chunk_size and tokenizer.count(text) <= chunk_size:
        return [text] if text else []
    out = []
    start, n = 0, len(ids)
    while start < n:
        end = min(start + chunk_size, n)
        piece = tokenizer.decode(ids[start:end])
        while end - start > 1 and tokenizer.count(piece) > chunk_size:
            end -= 1
            piece = tokenizer.decode(ids[start:end])
        out.append(piece)
        if end >= n:
            break
        start = max(start + 1, end - overlap)
    return out


def _split_on(text: str, sep: str) -> list[str]:
    """Split on ``sep``, re-attaching the separator as a prefix of the piece
    that follows it (headings/fences stay with their content)."""
    if sep == "":
        return [text]
    parts = text.split(sep)
    pieces = []
    if parts[0]:
        pieces.append(parts[0])
    for p in parts[1:]:
        pieces.append(sep + p)
    return pieces


def _recursive_pieces(
    text: str,
    separators: Sequence[str],
    chunk_size: int,
    overlap: int,
    tokenizer,
    length: Callable[[str], int],
) -> list[str]:
    """Produce pieces each of which fits in ``chunk_size`` tokens."""
    if length(text) <= chunk_size:
        return [text] if text else []
    for i, sep in enumerate(separators):
        if sep == "":
            return _token_window_split(text, chunk_size, overlap, tokenizer)
        if sep in text:
            pieces: list[str] = []
            for part in _split_on(text, sep):
                if length(part) <= chunk_size:
                    pieces.append(part)
                else:
                    pieces.extend(
                        _recursive_pieces(
                            part, separators[i + 1 :], chunk_size, overlap, tokenizer, length
                        )
                    )
            return pieces
    return [text]


def split_text(
    text: str,
    chunk_size: int = 768,
    overlap: int = 75,
    tokenizer=None,
    separators: Sequence[str] = SEPARATORS,
) -> list[str]:
    """Split ``text`` into chunks of ≤ ``chunk_size`` tokens with ~``overlap``
    tokens of trailing context carried into the next chunk."""
    if overlap >= chunk_size:
        raise ValueError("overlap must be < chunk_size")
    if not text.strip():
        return []
    if tokenizer is None:
        from cmw_rag_tpu_torch.tokenizer import get_tokenizer

        tokenizer = get_tokenizer()
    length = tokenizer.count

    pieces = _recursive_pieces(text, tuple(separators), chunk_size, overlap, tokenizer, length)
    # normalize: any piece still over budget (custom separator lists without
    # "", or re-tokenization growth) gets hard token-window slicing so the
    # merge loop below never seeds a chunk with an oversize lone piece
    pieces = [
        sub
        for p in pieces
        for sub in (
            [p] if length(p) <= chunk_size
            else _token_window_split(p, chunk_size, overlap, tokenizer)
        )
    ]

    # merge pieces greedily into chunks, carrying overlap. The budget check
    # measures the JOINED text, not the sum of piece lengths — BPE merges
    # across piece junctions can re-tokenize to a different (even larger)
    # count, and chunk tokens feed stable IDs and encoder windows, so the
    # ≤ chunk_size contract must hold on the final string.
    chunks: list[str] = []
    cur: list[str] = []
    for piece in pieces:
        if cur and length("".join(cur) + piece) > chunk_size:
            chunk = "".join(cur).strip("\n")
            if chunk.strip():
                chunks.append(chunk)
            # retain trailing pieces totalling ≤ overlap tokens, but never
            # so many that overlap + the new piece busts the budget
            kept: list[str] = []
            kept_len = 0
            for prev in reversed(cur):
                l = length(prev)
                if kept_len + l > overlap:
                    break
                kept.insert(0, prev)
                kept_len += l
            while kept and length("".join(kept) + piece) > chunk_size:
                kept.pop(0)
            cur = kept
        cur.append(piece)
    if cur:
        chunk = "".join(cur).strip("\n")
        if chunk.strip():
            chunks.append(chunk)
    return chunks


_HEADING_RE = None  # compiled lazily (module import stays regex-free)


def split_text_with_context(
    text: str,
    chunk_size: int = 768,
    overlap: int = 75,
    tokenizer=None,
    separators: Sequence[str] = SEPARATORS,
) -> list[str]:
    """``split_text`` + contextual chunk headers: the document's top-level
    markdown heading is prepended to every chunk that does not already
    contain it.

    The reference reaches the same property through langchain's
    heading-aware splitting (cmw-rag ``rag_engine/core/chunker.py:16-36``
    keeps headings attached to their sections); without it, every chunk
    past the first loses the article's topic/version markers — measured
    here as BOTH a first-stage retrieval miss (chunk text has no topic
    tokens for the lexical/dense match) and unlearnable reranker labels
    (version disambiguation ranks on markers the candidate text no longer
    carries). The header costs ~10-20 tokens on top of ``chunk_size``;
    encoder windows truncate, and stable chunk IDs hash the final text
    either way."""
    global _HEADING_RE
    if _HEADING_RE is None:
        import re

        _HEADING_RE = re.compile(r"^#{1,6} .+$", re.M)
    chunks = split_text(text, chunk_size, overlap, tokenizer, separators)
    m = _HEADING_RE.search(text)
    if not m:
        return chunks
    head = m.group(0).strip()
    return [c if head in c else f"{head}\n\n{c}" for c in chunks]
