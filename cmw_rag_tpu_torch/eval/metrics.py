"""Retrieval/rerank quality metrics (copy of ``cmw_rag_tpu/eval/metrics.py``).

The primitives behind the engine's parity harnesses (SURVEY.md §4
implication (b) and the reference's reranker benchmark methodology —
judged relevance averaged over ranked results, NDCG-style).
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence


def recall_at_k(retrieved: Sequence[Any], relevant: Sequence[Any], k: int) -> float:
    """|top-k ∩ relevant| / |relevant| (1.0 when nothing is relevant)."""
    rel = set(relevant)
    if not rel:
        return 1.0
    top = list(retrieved)[:k]
    return len(rel.intersection(top)) / len(rel)


def ndcg_at_k(retrieved: Sequence[Any], judgments: Mapping[Any, float], k: int) -> float:
    """Graded NDCG@k; ``judgments`` maps doc id → relevance grade."""
    top = list(retrieved)[:k]
    dcg = sum(
        (2 ** judgments.get(doc, 0.0) - 1) / math.log2(i + 2)
        for i, doc in enumerate(top)
    )
    ideal = sorted(judgments.values(), reverse=True)[:k]
    idcg = sum((2 ** g - 1) / math.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def judged_avg_score(retrieved: Sequence[Any], judgments: Mapping[Any, float],
                     k: int) -> float:
    """Mean judged grade of the top-k (the reference benchmark's headline
    'avg judged score')."""
    top = list(retrieved)[:k]
    if not top:
        return 0.0
    return sum(judgments.get(doc, 0.0) for doc in top) / len(top)


def mrr(retrieved: Sequence[Any], relevant: Sequence[Any]) -> float:
    rel = set(relevant)
    for i, doc in enumerate(retrieved):
        if doc in rel:
            return 1.0 / (i + 1)
    return 0.0
