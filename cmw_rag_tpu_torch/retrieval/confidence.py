"""Retrieval confidence heuristics (copy of
``cmw_rag_tpu/retrieval/confidence.py:13-41``): top score, mean of the top
k, gap of the top over the median, count above the threshold and a
``likely_relevant`` verdict."""

from __future__ import annotations

from typing import Any, Sequence


def compute_retrieval_confidence(
    scores: Sequence[float], threshold: float = 0.5, top_k: int = 5
) -> dict[str, Any]:
    if not scores:
        return {
            "top_score": 0.0,
            "mean_top_k": 0.0,
            "score_gap": 0.0,
            "n_above_threshold": 0,
            "likely_relevant": False,
        }
    s = sorted((float(x) for x in scores), reverse=True)
    top = s[0]
    mean_top = sum(s[:top_k]) / min(len(s), top_k)
    median = s[len(s) // 2]
    gap = top - median
    n_above = sum(1 for x in s if x >= threshold)
    return {
        "top_score": top,
        "mean_top_k": mean_top,
        "score_gap": gap,
        "n_above_threshold": n_above,
        "likely_relevant": top >= threshold and n_above >= 1,
    }

