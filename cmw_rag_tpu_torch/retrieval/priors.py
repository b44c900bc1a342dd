"""Structural ranking priors: current-version and query-language match
(copy of ``cmw_rag_tpu/retrieval/priors.py``).

The product contract is "cite the CURRENT product version in the USER'S
language" — the reference enforces it prompt-side by forbidding stale kbIds
outright (reference ``llm/prompts.py`` citation rules) and boosts metadata
signals in its reranker (reference ``retrieval/reranker.py:322-362``). This
module is the retrieval-side analog: two deterministic, content-derivable
signals added to the rerank blend in z-space (an additive log-linear prior,
NOT the multiplicative boost stack — multiplying z-scores flips sign for
below-mean candidates).

Signals resolve from candidate metadata when the index carries it
(``language`` / ``version`` fields from ingest enrichment or the platform
connector) and fall back to the text itself: language via script detection,
version via the ``(vN)`` marker that article titles — and therefore every
chunk's contextual header (``chunker.split_text_with_context``) — carry.
"""

from __future__ import annotations

import re
from typing import Any, Optional

_CYRILLIC = re.compile(r"[Ѐ-ӿ]")
_LATIN = re.compile(r"[A-Za-z]")
# version markers as titles render them: "... (v5)"; tolerant of bare "v5"
# tokens in headers ("## Обновление v5")
_VERSION = re.compile(r"\(v(\d+)\)|(?:^|[\s#:])v(\d+)\b")


def detect_language(text: str, probe: int = 400) -> Optional[str]:
    """"ru" / "en" by script majority over the first ``probe`` chars;
    None when neither script clearly dominates (mixed or non-text)."""
    head = text[:probe]
    cyr = len(_CYRILLIC.findall(head))
    lat = len(_LATIN.findall(head))
    if cyr == 0 and lat == 0:
        return None
    # 3× script majority: RU technical queries embed latin API/product
    # terms routinely ("как настроить process designer") — a 2× margin
    # mislabels them "en"; mixed-script surfaces must yield None (the
    # judged eval grades both languages top for mixed queries)
    if cyr >= 3 * lat:
        return "ru"
    if lat >= 3 * cyr:
        return "en"
    return None


def extract_version(text: str, probe: int = 200) -> Optional[str]:
    """Version marker from the document head (the chunk header carries the
    article title, which renders as "Facet: Topic (vN)")."""
    m = _VERSION.search(text[:probe])
    if not m:
        return None
    return "v" + (m.group(1) or m.group(2))


def candidate_signals(metadata: dict[str, Any], text: str,
                      query_lang: Optional[str],
                      current_version: str) -> tuple[bool, bool]:
    """(language_match, is_current_version) for one candidate.

    Metadata wins over text-derived detection; a missing/undetectable
    signal contributes False (no prior), never a penalty.
    """
    lang = metadata.get("language") or detect_language(text)
    ver = metadata.get("version") or extract_version(text)
    lang_match = bool(query_lang and lang and lang == query_lang)
    is_current = bool(current_version and ver and ver == current_version)
    return lang_match, is_current


def apply_structural_priors(final, query: str, candidates,
                            current_version: str,
                            version_weight: float,
                            language_weight: float):
    """Add the prior terms to a z-space score vector ``final`` (numpy,
    aligned with ``candidates``). No-op when both weights are 0."""
    if not (version_weight or language_weight):
        return final
    q_lang = detect_language(query)
    for i, c in enumerate(candidates):
        lang_match, is_current = candidate_signals(
            c.metadata, c.text, q_lang, current_version)
        if lang_match:
            final[i] += language_weight
        if is_current:
            final[i] += version_weight
    return final
