"""Vector-store types (copy of ``cmw_rag_tpu/index/store.py:20-29``): the
hit a store returns and the equality filter of its metadata reads."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class RetrievedDoc:
    id: str
    text: str
    metadata: dict[str, Any]
    score: float  # cosine similarity, higher is better


def _matches(meta: dict[str, Any], where: dict[str, Any]) -> bool:
    return all(meta.get(k) == v for k, v in where.items())
