"""Query segmentation (copy of ``cmw_rag_tpu/retrieval/retriever.py:69``)."""

from __future__ import annotations


def split_query_segments(query: str, tokenizer, max_segments: int = 4,
                         segment_tokens: int = 448,
                         overlap: int = 64) -> list[str]:
    """Token-aware sliding-window segmentation of a long query."""
    ids = tokenizer.encode(query)
    if len(ids) <= segment_tokens:
        return [query]
    step = segment_tokens - overlap
    segments = []
    for start in range(0, len(ids), step):
        segments.append(tokenizer.decode(ids[start : start + segment_tokens]))
        if len(segments) >= max_segments or start + segment_tokens >= len(ids):
            break
    return segments
