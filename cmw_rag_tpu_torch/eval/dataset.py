"""Judged bilingual eval dataset: loader + synthetic generator (copy of
``cmw_rag_tpu/eval/dataset.py``; the same JSON both ways).

The reference ships a 52-question RU/EN dataset with judged relevance for
its reranker benchmarks (SURVEY.md §4/§6). This module loads the same shape
— ``{"queries": [{"query", "language", "judgments": {kb_id: grade}}],
"corpus": [{"kb_id", "title", "content"}]}`` — and can synthesize a
deterministic topical RU/EN dataset for harness tests and CI.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any

TOPICS = [
    ("workflow", "процесс согласования", "approval workflow",
     "Настройка маршрутов согласования и шагов процесса.",
     "Configuring approval routes and process steps."),
    ("permissions", "права доступа", "access permissions",
     "Управление ролями, правами доступа и группами пользователей.",
     "Managing roles, access permissions, and user groups."),
    ("indexing", "индексация данных", "data indexing",
     "Индексация записей и настройка поисковых атрибутов.",
     "Indexing records and configuring searchable attributes."),
    ("api", "интеграция по api", "api integration",
     "Интеграция внешних систем через REST API и веб-хуки.",
     "Integrating external systems via REST API and webhooks."),
    ("backup", "резервное копирование", "backup and restore",
     "Создание резервных копий и восстановление базы данных.",
     "Creating backups and restoring the database."),
    ("reports", "построение отчётов", "building reports",
     "Построение отчётов, диаграмм и панелей мониторинга.",
     "Building reports, charts, and monitoring dashboards."),
]


def synthesize_dataset(per_topic_docs: int = 4, seed: int = 0) -> dict[str, Any]:
    rng = random.Random(seed)
    corpus = []
    queries = []
    kb = 4200
    for slug, ru_q, en_q, ru_body, en_body in TOPICS:
        topic_ids = []
        for j in range(per_topic_docs):
            kb += 1
            lang_ru = j % 2 == 0
            body = (ru_body if lang_ru else en_body)
            filler = " ".join(rng.choice(body.split()) for _ in range(30))
            corpus.append({
                "kb_id": str(kb),
                "title": f"{slug}-{j}",
                "content": f"{body} {filler} Раздел {j}." if lang_ru
                           else f"{body} {filler} Section {j}.",
            })
            topic_ids.append(str(kb))
        # graded: first doc most relevant, rest decreasing
        grades = {kb_id: max(1.0, 3.0 - i) for i, kb_id in enumerate(topic_ids)}
        queries.append({"query": ru_q, "language": "ru", "judgments": grades})
        queries.append({"query": en_q, "language": "en", "judgments": grades})
    return {"queries": queries, "corpus": corpus}


def dataset_fingerprint(dataset: dict[str, Any]) -> str:
    """Stable content hash of the judged query set (queries + judgments +
    corpus kb_ids). Committed into every EVAL artifact so round-over-round
    comparability of the judged set is checkable, not asserted (a silent
    dataset edit between artifacts shows up as a fingerprint change)."""
    import hashlib

    rows = sorted(
        (q["query"], q.get("language", ""),
         tuple(sorted((str(k), float(g))
                      for k, g in q.get("judgments", {}).items())))
        for q in dataset["queries"]
    )
    kb_ids = sorted(str(c["kb_id"]) for c in dataset["corpus"])
    blob = json.dumps([rows, kb_ids], ensure_ascii=False, sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def load_dataset(path: str | Path) -> dict[str, Any]:
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    assert "queries" in data and "corpus" in data, "bad dataset shape"
    return data


def save_dataset(data: dict[str, Any], path: str | Path) -> None:
    Path(path).write_text(json.dumps(data, ensure_ascii=False, indent=2),
                          encoding="utf-8")
