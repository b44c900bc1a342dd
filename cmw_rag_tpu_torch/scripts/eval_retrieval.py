"""Judged retrieval-quality eval (port of
``cmw_rag_tpu/scripts/eval_retrieval.py``).

The generated bilingual corpus and its judged queries
(``eval/corpus_gen.py``, ``eval/judged_queries.py``) through
``eval/runner.evaluate_retrieval``, on the card unless ``--device cpu``:

    python -m cmw_rag_tpu_torch.scripts.eval_retrieval --shipped \\
        --chunk-tokens 128 --ablations \\
        --compare-rerankers llm_reranker_solo=qwen3-reranker-micro \\
        --out EVAL_torch.json

Every flag of the JAX script is here, with these differences:
- ``--device`` (default ``cuda``) and ``--fp32`` (float32 towers; bf16 by
  default, as the JAX package's);
- ``--out`` writes that file only: the JAX script also writes its result
  over ``EVAL_latest.json`` beside it, the JAX package's record of quality;
- in ``--shipped`` mode a reranker that falls back to ``IdentityReranker``
  (a missing checkpoint) exits instead of evaluating another cascade;
- on a card the result carries the card's ``nvidia-smi`` name and power
  limit; each row carries its seconds by stage and the bootstrap standard
  error of each headline metric (``bootstrap_se``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def bootstrap_se(values, resamples: int = 1000, seed: int = 0) -> float:
    """Standard error of the mean of ``values``: the standard deviation of
    the mean over ``resamples`` resamples with replacement, drawn with
    ``numpy.random.default_rng(seed)`` (the same draws for every list of
    one length, so paired differences resample alike)."""
    import numpy as np

    vals = np.asarray(values, np.float64)
    idx = np.random.default_rng(seed).integers(0, len(vals),
                                               (resamples, len(vals)))
    return float(vals[idx].mean(axis=1).std())


def build_dataset(path: str | None):
    if path:
        from cmw_rag_tpu_torch.eval.dataset import load_dataset

        return load_dataset(path)
    from cmw_rag_tpu_torch.eval.corpus_gen import generate_corpus
    from cmw_rag_tpu_torch.eval.judged_queries import build_judged_dataset

    return build_judged_dataset(generate_corpus())


class _CachedEmbedder:
    """Memoizing wrapper: one corpus/query embed shared by every eval row
    in a multi-config run (the corpus forward dominates run time; reranker
    comparisons change nothing upstream of it)."""

    def __init__(self, inner):
        self.inner = inner
        self._cache: dict[tuple, object] = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _memo(self, kind, texts, fn):
        key = (kind, len(texts), hash(tuple(texts)))
        if key not in self._cache:
            self._cache[key] = fn(list(texts))
        return self._cache[key]

    def embed_documents(self, texts):
        return self._memo("docs", texts, self.inner.embed_documents)

    def embed_queries(self, texts):
        return self._memo("queries", texts, self.inner.embed_queries)


def make_embedder(model: str | None, checkpoint: str | None, device: str,
                  dtype, seed: int = 0):
    from cmw_rag_tpu_torch.config import Settings, get_embedding_model
    from cmw_rag_tpu_torch.retrieval.embedder import TorchEmbedder

    spec = get_embedding_model(model or Settings().embedding_model)
    return TorchEmbedder(spec, seed=seed, checkpoint=checkpoint or None,
                         device=device, dtype=dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default=None, help="judged dataset JSON; "
                    "default = generated corpus + hand-judged queries")
    ap.add_argument("--model", default="frida-mini", help="registry slug")
    ap.add_argument("--checkpoint", default=None, help="trained npz")
    ap.add_argument("--compare-random", action="store_true",
                    help="also evaluate random init and report both")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reranker", default=None,
                    help="registry reranker slug for a two-stage eval")
    ap.add_argument("--reranker-checkpoint", default=None)
    ap.add_argument("--vector-weight", type=float, default=0.0,
                    help="blend the vector-stage score into the CE score "
                    "(final = CE + w*cos) — the conservative cascade")
    ap.add_argument("--blend", default="raw", choices=["raw", "z"],
                    help="z: per-candidate-set z-normalized blend "
                    "z(cos) + ce_weight*z(CE)")
    ap.add_argument("--ce-weight", type=float, default=0.55)
    ap.add_argument("--prior-version", type=float, default=0.0,
                    help="structural prior: z-space bonus for current-"
                    "product-version candidates (retrieval/priors.py)")
    ap.add_argument("--prior-language", type=float, default=0.0,
                    help="structural prior: z-space bonus for query-"
                    "language-matching candidates")
    ap.add_argument("--current-version", default="",
                    help="current product version marker; default = the "
                    "generated corpus's CURRENT_VERSION")
    ap.add_argument("--sibling-slots", type=int, default=None,
                    help="version/translation family expansion slots "
                    "(retrieval/siblings.py); default = shipped setting in "
                    "--shipped mode, else 0")
    ap.add_argument("--sibling-anchors", type=int, default=None)
    ap.add_argument("--pre-rerank-k", type=int, default=None,
                    help="rerank window (unique articles); default = the "
                    "SERVING operating point (settings.rerank_article_"
                    "window) in --shipped mode, else 30")
    ap.add_argument("--compare-rerankers", action="append", default=[],
                    metavar="TAG=SLUG[,SLUG...]",
                    help="extra eval rows at the shipped operating point "
                    "with a different reranker config (bundled "
                    "checkpoints), e.g. llm_solo=qwen3-reranker-micro")
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="index at chunk granularity (production shape); "
                    "0 = whole articles")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--per-query", action="store_true",
                    help="include per-query rows in the output")
    ap.add_argument("--shipped", action="store_true",
                    help="evaluate the SHIPPING defaults: embedder/reranker "
                    "built exactly as a fresh deploy would "
                    "(create_embedder/create_reranker from the settings, "
                    "bundled checkpoints) — rows 'shipped_stage1'/'shipped'")
    ap.add_argument("--ablations", action="store_true",
                    help="emit floor rows into the artifact: random dense "
                    "init, lexical-only, dense-only (stage 1, no reranker)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--fp32", action="store_true",
                    help="float32 towers (default bf16)")
    args = ap.parse_args(argv)
    if args.pre_rerank_k is None and not args.shipped:
        args.pre_rerank_k = 30

    import torch

    from cmw_rag_tpu_torch.config import Settings, get_reranker
    from cmw_rag_tpu_torch.device import resolve_device
    from cmw_rag_tpu_torch.eval.corpus_gen import CURRENT_VERSION
    from cmw_rag_tpu_torch.eval.dataset import dataset_fingerprint
    from cmw_rag_tpu_torch.eval.runner import evaluate_retrieval
    from cmw_rag_tpu_torch.retrieval.embedder import (
        TorchEmbedder,
        create_embedder,
    )
    from cmw_rag_tpu_torch.retrieval.embedder import (
        _bundled_checkpoint as _bundled_embedder,
    )
    from cmw_rag_tpu_torch.retrieval.reranker import (
        EnsembleReranker,
        IdentityReranker,
        TorchReranker,
        _bundled_checkpoint,
        create_reranker,
    )
    from cmw_rag_tpu_torch.retrieval.siblings import SiblingIndex

    device = str(resolve_device(args.device))
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    on_device = dict(device=device, dtype=dtype)

    dataset = build_dataset(args.dataset)
    result: dict = {"model": args.model, "dataset": {
        "n_queries": len(dataset["queries"]), "n_corpus": len(dataset["corpus"]),
        "fingerprint": dataset_fingerprint(dataset),
    }}
    result["device"] = device
    result["dtype"] = "float32" if args.fp32 else "bfloat16"
    if device.startswith("cuda"):
        from cmw_rag_tpu_torch.scripts.shipping import card

        result["card"] = card()

    reranker = None
    if args.reranker:
        if "," in args.reranker:
            slugs = [p_.strip() for p_ in args.reranker.split(",") if p_.strip()]
            ckpts = ([c.strip() for c in args.reranker_checkpoint.split(",")]
                     if args.reranker_checkpoint
                     else [_bundled_checkpoint(sl) for sl in slugs])
            members = [TorchReranker(get_reranker(sl), checkpoint=ck,
                                     **on_device)
                       for sl, ck in zip(slugs, ckpts)]
            reranker = EnsembleReranker(
                members, weights=[args.ce_weight] * len(members))
        else:
            reranker = TorchReranker(get_reranker(args.reranker),
                                     checkpoint=args.reranker_checkpoint,
                                     vector_weight=args.vector_weight,
                                     blend=args.blend,
                                     ce_weight=args.ce_weight, **on_device)
        result["reranker"] = args.reranker
        result["vector_weight"] = args.vector_weight
        result["blend"] = args.blend
        if args.blend == "z":
            result["ce_weight"] = args.ce_weight

    def _apply_priors(rr):
        if rr is not None and (args.prior_version or args.prior_language):
            rr.current_version = args.current_version or CURRENT_VERSION
            rr.prior_version_weight = args.prior_version
            rr.prior_language_weight = args.prior_language
            result["priors"] = {
                "current_version": rr.current_version,
                "version_weight": args.prior_version,
                "language_weight": args.prior_language,
            }

    _apply_priors(reranker)

    # version/translation family expansion (retrieval/siblings.py): the
    # judged corpus carries the article tags a production KB carries; the
    # index the retriever would load is built from exactly those tags
    sib_index = SiblingIndex()
    for c in dataset["corpus"]:
        if c.get("tags"):
            sib_index.add(c["kb_id"], c["tags"])
    cur_version = args.current_version or CURRENT_VERSION

    def run(tag: str, checkpoint: str | None, rr=None, emb=None,
            sibling_slots: int = 0, sibling_anchors: int = 1):
        if emb is None:
            emb = make_embedder(args.model, checkpoint, **on_device)
        timings: dict[str, float] = {}
        t0 = time.perf_counter()
        r = evaluate_retrieval(emb, dataset, k=args.k, reranker=rr,
                               pre_rerank_k=args.pre_rerank_k,
                               chunk_tokens=args.chunk_tokens,
                               sibling_index=sib_index if sibling_slots else None,
                               sibling_slots=sibling_slots,
                               sibling_anchors=sibling_anchors,
                               current_version=cur_version, device=device,
                               timings=timings)
        r["seconds"] = round(time.perf_counter() - t0, 3)
        r["seconds_by_stage"] = {s: round(v, 3) for s, v in timings.items()}
        # each headline metric's SE, by its name in the row
        names = {"ndcg": f"ndcg@{args.k}", "recall": f"recall@{args.k}",
                 "mrr": "mrr", "mrr_grade3": "mrr_grade3",
                 "judged_avg": f"judged_avg@{args.k}"}
        if r["per_query"]:
            r["bootstrap_se"] = {
                name: bootstrap_se([q[m] for q in r["per_query"]])
                for m, name in names.items()}
        if not args.per_query:
            r.pop("per_query", None)
        result[tag] = r
        print(f"[{tag}] recall@{args.k}={r[f'recall@{args.k}']:.4f} "
              f"ndcg@{args.k}={r[f'ndcg@{args.k}']:.4f} mrr={r['mrr']:.4f} "
              f"judged_avg@{args.k}={r[f'judged_avg@{args.k}']:.4f}",
              flush=True)

    # comparison rows' bundled checkpoints, resolved before any row runs
    compare = []
    for spec_str in args.compare_rerankers:
        tag, slugs_s = spec_str.split("=", 1)
        slugs = [s.strip() for s in slugs_s.split(",") if s.strip()]
        for s in slugs:
            if _bundled_checkpoint(s) is None:
                raise SystemExit(f"no bundled checkpoint for {s!r}")
        compare.append((tag, slugs))

    if args.shipped:
        # the number of record: what create_embedder()/create_reranker()
        # serve on a fresh deploy, with the default settings
        settings = Settings()
        if args.pre_rerank_k is None:
            # the serving operating point, not an eval-only window
            args.pre_rerank_k = settings.rerank_article_window
        emb = _CachedEmbedder(create_embedder(settings.embedding_model,
                                              **on_device))
        rr = create_reranker(settings, **on_device)
        if (isinstance(rr, IdentityReranker)
                and settings.reranker_model.lower()
                not in ("", "identity", "none")):
            raise SystemExit(f"reranker {settings.reranker_model!r} fell back "
                             "to the identity reranker (missing checkpoint)")
        if (rr is not None and not getattr(rr, "current_version", "")
                and getattr(rr, "prior_version_weight", 0.0)):
            # current_product_version is a deployment fact; for the judged
            # eval it IS the dataset's current version, so the shipped
            # prior_version_weight acts on the eval corpus
            rr.current_version = args.current_version or CURRENT_VERSION
        _apply_priors(rr)  # CLI overrides on top of shipped settings
        args.model = settings.embedding_model  # ablation rows use shipped slug
        result["model"] = settings.embedding_model
        result["reranker"] = settings.reranker_model
        result["shipped_config"] = {
            "embedding_model": settings.embedding_model,
            "embedder_checkpoint": "(bundled)",
            "reranker_model": settings.reranker_model,
            "reranker_blend": settings.reranker_blend,
            "reranker_ce_weight": settings.reranker_ce_weight,
            "prior_version_weight": settings.prior_version_weight,
            "prior_language_weight": settings.prior_language_weight,
            "current_version": getattr(rr, "current_version", ""),
            "pre_rerank_k": args.pre_rerank_k,
            "sibling_expand_slots": settings.sibling_expand_slots,
            "sibling_expand_anchors": settings.sibling_expand_anchors,
        }
        sl = (args.sibling_slots if args.sibling_slots is not None
              else settings.sibling_expand_slots)
        an = (args.sibling_anchors if args.sibling_anchors is not None
              else settings.sibling_expand_anchors)
        run("shipped_stage1", None, emb=emb)
        run("shipped", None, rr, emb=emb, sibling_slots=sl,
            sibling_anchors=an)
        # comparison rows: alternative reranker configs at the SAME
        # operating point (window/priors/siblings), bundled checkpoints
        for tag, slugs in compare:
            members = [TorchReranker(get_reranker(s),
                                     checkpoint=_bundled_checkpoint(s),
                                     **on_device) for s in slugs]
            cw = settings.reranker_ce_weight
            if len(members) == 1:
                rr_c = members[0]
                rr_c.blend, rr_c.ce_weight = "z", cw
            else:
                rr_c = EnsembleReranker(members, weights=[cw] * len(members))
            rr_c.current_version = getattr(rr, "current_version", "")
            rr_c.prior_version_weight = settings.prior_version_weight
            rr_c.prior_language_weight = settings.prior_language_weight
            result.setdefault("compare_rerankers", {})[tag] = slugs
            run(tag, None, rr_c, emb=emb, sibling_slots=sl,
                sibling_anchors=an)
    elif args.checkpoint:
        run("trained", args.checkpoint)
        if reranker is not None:
            # the two-stage shape: same trained bi-encoder + cross-encoder
            # on top — the uplift claim compares this row against "trained"
            run("trained_plus_cross_encoder", args.checkpoint, reranker)
        if args.compare_random:
            run("random", None)
    else:
        if not args.ablations:
            run("random", None)
        if reranker is not None:
            run(f"random_plus_{args.reranker}", None, reranker)

    if args.ablations:
        # floor rows, committed with the artifact so that later changes
        # read against the hash-function floor
        from cmw_rag_tpu_torch.config import get_embedding_model

        spec = get_embedding_model(args.model or "frida-hybrid")
        run("random", None)  # random dense init + untrained lexical block
        if getattr(spec, "lexical_dim", 0):
            lex_only = dataclasses.replace(spec, lexical_weight=1.0)
            run("lexical_only", None,
                emb=TorchEmbedder(lex_only, **on_device))
            dense_only = dataclasses.replace(
                spec, lexical_dim=0, lexical_weight=0.0,
                dimensions=spec.d_model)
            ckpt = args.checkpoint
            if not ckpt and args.shipped:
                ckpt = _bundled_embedder(spec.slug)
            run("dense_only", None,
                emb=TorchEmbedder(dense_only, checkpoint=ckpt, **on_device))

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, ensure_ascii=False, indent=2)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
