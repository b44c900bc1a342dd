"""Metadata-driven sibling expansion: version/translation families (copy of
``cmw_rag_tpu/retrieval/siblings.py``; the same ``sibling_index.json``).

Versioned bilingual KBs (the reference's production corpus, and this
repo's judged eval corpus) publish each article as a FAMILY — one article
per (version, language) combination — distinguished by structural tags
(``v5``, ``ru``) on top of shared identity tags (topic/facet/category).
The reference leans on that structure downstream: its prompts forbid
citing stale-version kbIds and its reranker boosts version/language
metadata (reference ``retrieval/reranker.py:322-362``); its retriever
groups chunk hits by kbId (``retrieval/retriever.py:233-244``).

This module is the retrieval-side completion of that contract: when the
pipeline surfaces ONE member of a family, the rest of the family is
findable by metadata alone — no model required. That matters because the
measured failure mode of every model-side route to the family is total:
the other-language siblings of a matched article appear 0.00/4 times in
stage-1 top-20 (recall-structure teardown §§2–8 — translit grams, PRF,
rerank depth, curriculum scaling, and dual-view injection are all
measured negatives at this model scale). Expansion recovers them for the
price of a dictionary lookup, and guarantees the CURRENT-version sibling
enters the agent's context even when lexical stage-1 matched a stale
version's phrasing.

Measured on the judged eval (r5 joint sweep: 312 queries incl. the
two-family multi-intent slice, 8 320 articles;
``scripts/sweep_expansion_priors.py``): the shipped point slots=6,
anchors=3 (w20/cw0.35/pv0.4) moves ndcg@10 0.3355 → 0.3712, recall@10
0.166 → 0.253, judged_avg@10 0.842 → 0.969 with mrr_grade3 held by the
guarded pick (0.2516 → 0.2517); slots=6/anchors=3 is chosen by all 5 CV
split-halves (+0.03..+0.05 test ndcg) and the multi-intent slice
improves too (ndcg 0.220 → 0.244). The documented trade: mrr(grade>=2)
0.353 → 0.326 — expanded siblings displace some grade-2 hits from ranks
2-5 while every other metric gains
(docs/analysis/20260820-r5-operating-point.md §2).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Iterable, Optional

# structural tags: version markers and language codes; everything else on
# an article is identity (topic/facet/category/product-area...)
_VERSION_TAG = re.compile(r"^v\d+(?:\.\d+)*$", re.IGNORECASE)
_LANGUAGE_TAGS = {"ru", "en", "ru-ru", "en-us", "en-gb", "rus", "eng"}


def _version_rank(tag: str) -> tuple:
    """Sortable version value: 'v6' > 'v5.1' > 'v5'."""
    nums = [int(p) for p in re.findall(r"\d+", tag)]
    return tuple(nums)


def split_tags(tags: Iterable[str]) -> tuple[list[str], Optional[str],
                                             Optional[str]]:
    """(identity_tags, version_tag, language_tag) from an article's tags."""
    identity: list[str] = []
    version: Optional[str] = None
    language: Optional[str] = None
    for raw in tags:
        t = str(raw).strip()
        if not t:
            continue
        low = t.lower()
        if _VERSION_TAG.match(low):
            version = low
        elif low in _LANGUAGE_TAGS:
            language = low[:2]
        else:
            identity.append(low)
    return identity, version, language


def sibling_key(tags: Iterable[str]) -> Optional[str]:
    """Family key = the sorted identity tags — shared by every version and
    language of one article. None when the tags carry no version/language
    structure (nothing to expand) or no identity (key would be global)."""
    identity, version, language = split_tags(tags)
    if not identity or (version is None and language is None):
        return None
    return "|".join(sorted(identity))


class SiblingIndex:
    """kb_id ↔ family map, built at index time from article tags.

    Persisted as ``sibling_index.json`` next to the vector-store manifest
    (``scripts/build_index.py``); the retriever loads it lazily. Size is
    O(n_articles), not O(n_chunks).
    """

    def __init__(self) -> None:
        self._families: dict[str, list[str]] = {}
        self._info: dict[str, dict[str, Any]] = {}

    def add(self, kb_id: str, tags: Iterable[str]) -> None:
        """Insert or REPLACE an article's family record. Delete-then-add,
        matching the store's own reindex semantics (reference
        ``core/indexer.py:183-209``): a tag change moves the article to its
        new family; tags that lose version/language structure drop it."""
        kb = str(kb_id)
        key = sibling_key(tags)
        if kb in self._info:
            if self._info[kb].get("key") == key and key is not None:
                _, version, language = split_tags(tags)
                self._info[kb].update(version=version, language=language)
                return
            self.remove(kb)
        if key is None:
            return
        _, version, language = split_tags(tags)
        self._info[kb] = {"key": key, "version": version,
                          "language": language}
        self._families.setdefault(key, []).append(kb)

    def remove(self, kb_id: str) -> bool:
        """Drop an article from its family (prune / tag-change path)."""
        kb = str(kb_id)
        rec = self._info.pop(kb, None)
        if rec is None:
            return False
        fam = self._families.get(rec["key"])
        if fam is not None:
            try:
                fam.remove(kb)
            except ValueError:
                pass
            if not fam:
                del self._families[rec["key"]]
        return True

    def __len__(self) -> int:
        return len(self._info)

    def __contains__(self, kb_id: str) -> bool:
        return str(kb_id) in self._info

    def info(self, kb_id: str) -> dict[str, Any]:
        return dict(self._info.get(str(kb_id), {}))

    def siblings_of(self, kb_id: str) -> list[str]:
        """Family members other than ``kb_id`` (insertion = corpus order)."""
        rec = self._info.get(str(kb_id))
        if rec is None:
            return []
        return [kb for kb in self._families.get(rec["key"], ())
                if kb != str(kb_id)]

    def ordered_siblings(self, kb_id: str, current_version: str = "",
                         query_language: Optional[str] = None) -> list[str]:
        """Siblings ordered by the product contract: current product
        version first, the query's language first, then newest version."""
        sibs = self.siblings_of(kb_id)
        cur = (current_version or "").lower()

        def order(kb: str) -> tuple:
            rec = self._info[kb]
            ver = rec.get("version") or ""
            lang = rec.get("language")
            return (
                0 if (cur and ver == cur) else 1,
                0 if (query_language and lang == query_language) else 1,
                tuple(-n for n in _version_rank(ver)) if ver else (0,),
            )

        return sorted(sibs, key=order)

    # ------------------------------------------------------- persistence
    def to_dict(self) -> dict[str, Any]:
        return {"articles": self._info}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SiblingIndex":
        idx = cls()
        for kb, rec in d.get("articles", {}).items():
            idx._info[str(kb)] = dict(rec)
            idx._families.setdefault(rec["key"], []).append(str(kb))
        return idx

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), ensure_ascii=False),
                              encoding="utf-8")

    @classmethod
    def load(cls, path: str | Path) -> "SiblingIndex":
        return cls.from_dict(json.loads(Path(path).read_text("utf-8")))


def expand_ranked_kb_ids(
    ranked: list[str],
    index: SiblingIndex,
    top_k: int,
    slots: int,
    anchors: int = 1,
    current_version: str = "",
    query_language: Optional[str] = None,
    exclude: Optional[set[str]] = None,
) -> list[str]:
    """The measured policy on a ranked kb_id list: originals keep
    ``top_k - slots`` positions; the final ``slots`` are filled with the
    ordered siblings of the top ``anchors`` results; originals backfill
    when families run short. Pure function — shared by the retriever and
    the eval runner so the committed metrics price the serving behavior."""
    if slots <= 0 or not ranked:
        return ranked[:top_k]
    slots = min(slots, max(top_k - 1, 0))
    excl = {str(k) for k in exclude} if exclude else set()
    seen: set[str] = set()
    head: list[str] = []
    for kb in ranked:
        if len(head) >= top_k - slots:
            break
        if kb in seen:
            continue
        seen.add(kb)
        head.append(kb)
    pool: list[str] = []
    for kb in head[:anchors]:
        pool.extend(s for s in index.ordered_siblings(
            kb, current_version, query_language)
            if s not in seen and s not in excl)
    out = list(head)
    for kb in pool:
        if len(out) >= top_k:
            break
        if kb not in seen:
            seen.add(kb)
            out.append(kb)
    for kb in ranked:  # backfill with the displaced originals
        if len(out) >= top_k:
            break
        if kb not in seen:
            seen.add(kb)
            out.append(kb)
    return out
