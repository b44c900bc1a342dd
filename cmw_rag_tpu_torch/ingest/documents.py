"""Frontmatter splitting (port of ``cmw_rag_tpu/ingest/documents.py:25-62``).

The JAX package parses the frontmatter block with ``yaml.safe_load`` and,
when that fails, line by line. The card's machine has no yaml, so the port
always takes the line-wise form: top-level ``key: value`` lines split at
the first colon, values kept as stripped strings, indented and comment
lines skipped. The body that follows the block is the same in both.
"""

from __future__ import annotations

import re
from typing import Any

_FRONTMATTER_RE = re.compile(r"\A---\s*\n(.*?)\n---\s*\n?", re.DOTALL)


def parse_frontmatter(text: str) -> tuple[dict[str, Any], str]:
    """Split leading frontmatter from the body: → (metadata, body); ({}, text)
    when no frontmatter block is present."""
    m = _FRONTMATTER_RE.match(text)
    if not m:
        return {}, text
    meta: dict[str, Any] = {}
    for ln in m.group(1).splitlines():
        if ln[:1] in (" ", "\t") or ln.lstrip().startswith("#"):
            continue
        k, sep, v = ln.partition(":")
        if sep and k.strip():
            meta[k.strip()] = v.strip()
    return meta, text[m.end():]

