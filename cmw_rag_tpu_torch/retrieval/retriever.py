"""Two-stage retrieval with multi-vector queries and full-article
reconstruction (port of ``cmw_rag_tpu/retrieval/retriever.py:46-335``).

``Retriever.retrieve`` runs, as the JAX retriever does: (1) token-aware
query segmentation (``retrieval/segments.py``); (2) all segments embedded
in one batch and searched in one scan top-k call; (3) candidates deduped by
stable chunk id keeping the max score, with an empty-result retry on the
whole query, an optional kbId exclusion and the pre-rerank cap; (4) the
rerank window (the best chunk of the first ``rerank_article_window``
articles) and the rerank to ``2·top_k``; (5) grouping by numeric kbId
keeping the max score, and the score threshold; (6) full-article
reconstruction from the source file (frontmatter stripped) or, when it is
unreadable, the matched chunks; (7) ``normalized_rank`` and ``last_trace``.

Sibling expansion (``retrieval/siblings.py``) and LLM query decomposition
are not ported: asking for either raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from cmw_rag_tpu_torch.ingest.documents import parse_frontmatter
from cmw_rag_tpu_torch.retrieval.confidence import compute_retrieval_confidence
from cmw_rag_tpu_torch.retrieval.reranker import Candidate, IdentityReranker
from cmw_rag_tpu_torch.retrieval.segments import split_query_segments
from cmw_rag_tpu_torch.utils.metadata import extract_numeric_kbid

log = logging.getLogger(__name__)

ARTICLE_URL_TEMPLATE = "https://kb.comindware.ru/article.php?id={kb_id}"


@dataclass
class Article:
    kb_id: str
    title: str
    content: str
    metadata: dict[str, Any] = field(default_factory=dict)
    score: float = 0.0
    matched_chunks: list[str] = field(default_factory=list)
    normalized_rank: float = 0.0
    article_url: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "kb_id": self.kb_id,
            "title": self.title,
            "url": self.article_url,
            "content": self.content,
            "metadata": {
                **self.metadata,
                "rerank_score": self.score,
                "normalized_rank": self.normalized_rank,
                "matched_chunks": len(self.matched_chunks),
            },
        }


class Retriever:
    def __init__(self, embedder, store, reranker=None,
                 corpus_dir: str | Path | None = None,
                 top_k_retrieve: int = 20, pre_rerank_limit: int = 60,
                 rerank_article_window: int = 20,
                 rerank_score_threshold: float = 0.5, multiquery: bool = True,
                 max_segments: int = 4, segment_tokens: int = 448,
                 segment_overlap: int = 64, query_decomposition: bool = False,
                 sibling_index=None, sibling_expand_slots: int = 0):
        if query_decomposition:
            raise NotImplementedError("LLM query decomposition is not ported")
        if sibling_index is not None and sibling_expand_slots > 0:
            raise NotImplementedError("sibling expansion is not ported")
        self.embedder = embedder
        self.store = store
        self.reranker = reranker or IdentityReranker()
        self.corpus_dir = Path(corpus_dir) if corpus_dir else None
        self.top_k_retrieve = top_k_retrieve
        self.pre_rerank_limit = pre_rerank_limit
        self.rerank_article_window = rerank_article_window
        self.rerank_score_threshold = rerank_score_threshold
        self.multiquery = multiquery
        self.max_segments = max_segments
        self.segment_tokens = segment_tokens
        self.segment_overlap = segment_overlap
        self.last_trace: dict[str, Any] = {}

    def retrieve(self, query: str, top_k: int = 10,
                 exclude_kb_ids: Optional[set[str]] = None) -> list[Article]:
        tokenizer = getattr(self.embedder, "tokenizer", None)
        if self.multiquery and tokenizer is not None:
            segments = split_query_segments(
                query, tokenizer, self.max_segments, self.segment_tokens,
                self.segment_overlap)
        else:
            segments = [query]

        candidates = self._vector_stage(segments)
        if not candidates and len(segments) > 1:
            candidates = self._vector_stage([query])  # retry whole
        if exclude_kb_ids:
            candidates = [
                c for c in candidates
                if extract_numeric_kbid(c.metadata.get("kbId"))
                not in exclude_kb_ids]
        candidates.sort(key=lambda c: -c.score)
        candidates = candidates[: self.pre_rerank_limit]

        # rerank window: the best chunk of each of the first N articles
        # (no window for the identity reranker)
        if self.rerank_article_window > 0 and not isinstance(
                self.reranker, IdentityReranker):
            seen_kb: set[str] = set()
            windowed = []
            for c in candidates:
                kb = extract_numeric_kbid(c.metadata.get("kbId"))
                if kb in seen_kb:
                    continue  # the best chunk of this article is kept
                if kb is not None:
                    if len(seen_kb) >= self.rerank_article_window:
                        continue
                    seen_kb.add(kb)
                windowed.append(c)
            candidates = windowed

        reranked = self.reranker.rerank(query, candidates,
                                        top_k=max(top_k * 2, top_k))

        by_kb: dict[str, dict[str, Any]] = {}
        for c in reranked:
            kb = extract_numeric_kbid(c.metadata.get("kbId"))
            if kb is None:
                continue
            g = by_kb.setdefault(kb, {"score": c.score, "meta": c.metadata,
                                      "chunks": []})
            g["score"] = max(g["score"], c.score)
            g["chunks"].append(c.text)

        kept = [(kb, g) for kb, g in by_kb.items()
                if g["score"] >= self.rerank_score_threshold]
        kept.sort(key=lambda kv: -kv[1]["score"])
        articles = [self._reconstruct_article(kb, g) for kb, g in kept[:top_k]]
        n = len(articles)
        for idx, a in enumerate(articles):
            a.normalized_rank = idx / (n - 1) if n > 1 else 0.0

        self.last_trace = {
            "query": query,
            "segments": len(segments),
            "decomposed_queries": 0,
            "candidates": len(candidates),
            "reranked": len(reranked),
            "articles": n,
            "sibling_expansions": 0,
            "confidence": compute_retrieval_confidence(
                [a.score for a in articles], self.rerank_score_threshold),
        }
        return articles

    def _vector_stage(self, segments: Sequence[str]) -> list[Candidate]:
        """Embed all segments in one batch, search them in one scan top-k
        call, union + dedup by stable chunk id keeping the max score."""
        embeddings = self.embedder.embed_queries(list(segments))
        hits_per_segment = self.store.search(
            np.asarray(embeddings, np.float32), self.top_k_retrieve)
        best: dict[str, Candidate] = {}
        for hits in hits_per_segment:
            for doc in hits:
                sid = doc.metadata.get("stable_id", doc.id)
                prev = best.get(sid)
                if prev is None or doc.score > prev.score:
                    best[sid] = Candidate(id=sid, text=doc.text,
                                          metadata=doc.metadata,
                                          score=doc.score)
        return list(best.values())

    def _reconstruct_article(self, kb: str, group: dict[str, Any]) -> Article:
        meta = dict(group["meta"])
        title = str(meta.get("title", f"Article {kb}"))
        content = None
        source = meta.get("source_file")
        if source:
            path = Path(source)
            if not path.is_absolute() and self.corpus_dir is not None:
                path = self.corpus_dir / path
            try:
                _, content = parse_frontmatter(path.read_text(encoding="utf-8"))
            except OSError:
                log.debug("article file unreadable: %s", path)
        if content is None:
            # stitched matched chunks (deduped, in chunk order)
            content = "\n\n".join(dict.fromkeys(group["chunks"]))
        return Article(kb_id=kb, title=title, content=content.strip(),
                       metadata=meta, score=float(group["score"]),
                       matched_chunks=list(group["chunks"]),
                       article_url=ARTICLE_URL_TEMPLATE.format(kb_id=kb))
