"""Write ``tests/eval_reference_jax.json``: the JAX package's judged eval,
query by query, for the port's paired gate (``chip_smoke.py`` phase 12).

    JAX_PLATFORMS=cpu python tests/eval_reference_jax.py [--out PATH]

Runs ``cmw_rag_tpu.scripts.eval_retrieval --shipped --chunk-tokens 128
--per-query`` (the generated dataset, the bundled embedder and 4-member
ensemble at their defaults, bf16) and keeps, for the rows
``shipped_stage1`` and ``shipped``, the aggregate metrics and each
query's metric values, with the seconds the run took. The JAX script
also writes its result over ``EVAL_latest.json`` beside ``--out``, so it
is pointed at a temporary directory here.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = ("shipped_stage1", "shipped")
PER_QUERY_KEYS = ("query", "language", "source", "recall", "ndcg", "mrr",
                  "mrr_grade3", "judged_avg")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=str(ROOT / "tests" /
                                         "eval_reference_jax.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import jax

    from cmw_rag_tpu.scripts.eval_retrieval import main as eval_main

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        full = Path(tmp) / "eval.json"
        rc = eval_main(["--shipped", "--chunk-tokens", "128", "--per-query",
                        "--out", str(full)])
        if rc:
            return rc
        result = json.loads(full.read_text(encoding="utf-8"))
    seconds = time.time() - t0
    out = {
        "made_by": "tests/eval_reference_jax.py",
        "backend": jax.default_backend(),
        "seconds": round(seconds, 1),
        "dataset": result["dataset"],
        "shipped_config": result["shipped_config"],
    }
    for row in ROWS:
        r = result[row]
        out[row] = {
            **{k: v for k, v in r.items()
               if not isinstance(v, (dict, list))},
            "chunk_level": r.get("chunk_level"),
            "per_query": [{k: q[k] for k in PER_QUERY_KEYS}
                          for q in r["per_query"]],
        }
    Path(args.out).write_text(json.dumps(out, ensure_ascii=False, indent=1),
                              encoding="utf-8")
    print(f"wrote {args.out} in {seconds:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
