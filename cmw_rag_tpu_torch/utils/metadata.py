"""kbId normalisation (copy of ``cmw_rag_tpu/utils/metadata.py:17-23``)."""

from __future__ import annotations

import re
from typing import Any, Optional

_NUM_RE = re.compile(r"\d+")


def extract_numeric_kbid(kb_id: Any) -> Optional[str]:
    """First run of digits in the kbId, as a string; None when absent."""
    if kb_id is None:
        return None
    m = _NUM_RE.search(str(kb_id))
    return m.group() if m else None
