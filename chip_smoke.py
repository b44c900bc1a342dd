#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds beside the card's name and power limit:

1. build - compile every hand-written kernel source
   (``cmw_rag_tpu_torch/csrc/*.cu``) with nvcc for sm_90a into
   ``build/cmw_rag_tpu_torch/``, one nvcc per source, all started together.
2. kernels - hold each kernel against its plain PyTorch twin on the card.
   Scan top-k (bf16 and int8) at N = 1,000,000 rows x D = 5120: k = 20 for
   Q = 8 (the query batch of the fused path) and Q = 32 (8 queries x 4
   segments), k = 129 and k = 1000 for Q = 8, and k = N on the first 4,096
   rows. 1% of rows are tombstones and duplicate rows plant exact ties.
   Scores must agree to 1e-4 absolute, ids wherever neighbouring scores
   differ by more than 1e-4, exact ties must come out in ascending id order.
   Flash attention forward, causal, bf16, with ragged key masks, at the
   rerank shape (B 32, H 16, L 1024, D 128) and the window shape (B 1, H 16,
   L 8192, D 128), against the twin run over the kernel's own 64-row,
   64-key tiles, so that both round p to bf16 against the same running
   maxima: O within one bf16 step of the twin's |O| (both round O to bf16,
   so values a hair apart may round one step apart) plus ``O_ABS`` (a p
   may still round one step apart: the kernel's ``__expf`` and
   ``torch.exp`` differ in the last float32 bits), the log-sum-exp within
   1e-4. Times: the kernel, its twin, one library call
   timed here only (chunked ``torch.matmul`` + ``torch.topk``;
   ``scaled_dot_product_attention`` with the same mask) and the bound (the
   larger of the bytes the function needs / 3.35 TB/s and the operations
   it needs / 989 TFLOP/s, both counted over the real keys of this run's
   masks).
3. pipeline - the port's ``FusedPipeline`` with ``frida-hybrid`` and the
   shipping 4-member rerank ensemble on their bundled checkpoints, over a
   1M x 5120 corpus in which 8 bilingual chunk texts are planted
   (``cmw_rag_tpu_torch/scripts/shipping.py``); one warm-up batch and 40
   timed batches of the 8 planted texts against the bf16 corpus, then the
   int8 one. Each planted text must return its slot in the top 10, scores
   finite and descending. The queries/s printed is a smoke reading.
4. card-vs-cpu - the same pipeline on the card and on this machine's CPU
   (the path the CPU tests hold to the JAX package), over identical rows:
   the same fixed markdown in 192-token chunks plus the 8 planted texts,
   embedded once on the card. Real texts, so that the vector stage ranks by
   clear margins (random rows score within a few thousandths of each other
   and make the rerank pool itself a near tie). The blended scores of every
   id both return must agree within ``CPU_DRIFT``; top-1 must be equal for
   every query; any other position may differ only where the CPU's blended
   scores of neighbouring positions are within ``CPU_GAP`` = 2 x
   ``CPU_DRIFT``, the most two scores that each move by the drift can close
   (the last position, whose lower neighbour is not returned, is never
   compared).
5. long-context - ``Retriever.retrieve`` with full-width
   ``qwen3-embedding-0.6b`` and ``qwen3-reranker-0.6b`` (random weights from
   seeded CPU generators) over 512 chunks of 768 tokens windowed from a
   fixed list of the checkout's markdown
   (``cmw_rag_tpu_torch/scripts/long_context.py``), 8
   queries, top_k_retrieve 20, top_k 10. The flash kernel must run while
   the chunks are embedded and while pairs are reranked; scores finite and
   descending. Then the plain attention route (``flash_min_seq`` out of
   reach): the chunk vectors must agree with the flash route's (cosine
   at least ``LC_COS``), and the same queries over the same index must give
   every shared kbId's score within ``LC_DRIFT`` and the same ranked kbIds
   wherever the flash route's neighbouring scores are more than ``LC_GAP`` =
   2 x ``LC_DRIFT`` apart.

Every kernel's launch count is set to 0 just before each path (3 and 5) is
driven and read just after; each kernel of a path must have launched. The
script then prints one JSON line with every kernel's numbers, the card's
``nvidia-smi`` name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero; without CUDA, or outside a checkout, it exits non-zero
before printing any result. It imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOP_K = 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak, H100 SXM
TOL = 1e-4
LSE_TOL = 1e-4
O_ABS = 2e-3
CPU_DRIFT = 0.05
CPU_GAP = 2 * CPU_DRIFT
LC_COS = 0.99
LC_DRIFT = 0.05
LC_GAP = 2 * LC_DRIFT


def log(phase: str, seconds: float, card_line: str, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[chip_smoke] phase={phase} seconds={seconds:.3f} "
          f"card=\"{card_line}\" {extra}".rstrip(), flush=True)


def fmt(entry: dict) -> dict:
    return {k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in entry.items()}


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, ops: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_step(x):
    """One bf16 step (unit in the last place) at each element's magnitude;
    0 where the element is 0."""
    import torch

    x = x.float()
    step = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
    return torch.where(x == 0, torch.zeros_like(x), step)


def reset_counts() -> None:
    from cmw_rag_tpu_torch.ops import flash_attention as F
    from cmw_rag_tpu_torch.ops import topk as T

    T.topk_scan_bf16.launches = 0
    T.topk_scan_int8.launches = 0
    F.reset_launches()


def read_counts() -> dict:
    from cmw_rag_tpu_torch.ops import flash_attention as F
    from cmw_rag_tpu_torch.ops import topk as T

    return {"topk_scan_bf16": T.topk_scan_bf16.launches,
            "topk_scan_int8": T.topk_scan_int8.launches,
            "flash_attention_fwd": F.total_launches()}


# ------------------------------------------------------------------ kernels


def library_scan(corpus, scales, ids, queries, k, chunk=131072):
    """Yardstick only: chunked bf16 ``torch.matmul`` + ``torch.topk``."""
    import torch

    best_s = best_i = None
    for a in range(0, corpus.shape[0], chunk):
        rows = corpus[a : a + chunk]
        s = torch.matmul(queries, rows.T if scales is None
                         else rows.to(torch.bfloat16).T).float()
        if scales is not None:
            s = s * scales[a : a + chunk][None, :]
        s = s.masked_fill(ids[a : a + chunk][None, :] < 0, float("-inf"))
        ts, ti = torch.topk(s, min(k, s.shape[1]), dim=1)
        ti = ids[a : a + chunk][ti]
        if best_s is not None:
            ts, j = torch.topk(torch.cat([best_s, ts], 1), k, dim=1)
            ti = torch.cat([best_i, ti], 1).gather(1, j)
        best_s, best_i = ts, ti
    return best_s, best_i


def check_against_plain(name, got, want, ids, tie_groups):
    """Scores to TOL; ids equal wherever neighbours differ by more than TOL;
    exact ties in ascending id order; no tombstone; planted tie groups
    surface whole and in id order. Returns the largest score error."""
    import torch

    (gs, gi), (ws, wi) = got, want
    err = (gs - ws).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name}: max |score - plain| = {err}")
    gap = (ws[:, 1:] - ws[:, :-1]).abs() > TOL
    clear = torch.ones_like(wi, dtype=torch.bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    if not torch.equal(gi[clear], wi[clear]):
        raise AssertionError(f"{name}: ids differ from the plain twin")
    live = gi >= 0
    tie = (gs[:, 1:] == gs[:, :-1]) & live[:, 1:] & live[:, :-1]
    if bool((tie & (gi[:, 1:] <= gi[:, :-1])).any()):
        raise AssertionError(f"{name}: exact ties not in ascending id order")
    if not torch.equal(live, wi >= 0) or bool((ids[gi[live].long()] < 0).any()):
        raise AssertionError(f"{name}: a tombstoned or empty row surfaced")
    for q, group in tie_groups:
        if gi[q, : len(group)].tolist() != group:
            raise AssertionError(f"{name}: tie group of query {q} came out "
                                 f"{gi[q, :len(group)].tolist()}, want {group}")
    return err


def scan_phase(card_line: str) -> dict:
    """Hold both scan kernels against their plain twins; time all four."""
    import torch
    from cmw_rag_tpu_torch.ops import topk as T
    from cmw_rag_tpu_torch.scripts.shipping import (DIM, N_ROWS,
                                                    fill_unit_rows,
                                                    quantize_slices)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.time()
    corpus = fill_unit_rows(N_ROWS, DIM, gen)
    ids = torch.arange(N_ROWS, dtype=torch.int32, device="cuda")
    ids[torch.rand((N_ROWS,), generator=gen, device="cuda") < 0.01] = -1
    # 8 tie groups: row src copied to 3 other slots, one copy tombstoned;
    # query j equals row src, so the live copies are its exact top ties
    srcs = torch.randperm(N_ROWS, generator=gen, device="cuda")[:8].tolist()
    groups = []
    for j, src in enumerate(srcs):
        copies = [(src + 99_991 * (i + 1)) % N_ROWS for i in range(3)]
        corpus[copies] = corpus[src].clone()
        ids[src] = src
        ids[copies[0]] = -1
        ids[copies[1:]] = torch.tensor(copies[1:], dtype=torch.int32,
                                       device="cuda")
        groups.append((j, sorted([src] + copies[1:])))
    q_all = fill_unit_rows(32, DIM, gen)
    q_all[:8] = corpus[srcs]
    corpus8, scales = quantize_slices(corpus)
    torch.cuda.synchronize()
    log("kernels-setup", time.time() - t0, card_line, rows=N_ROWS, dim=DIM)

    n_small = 4096
    cases = [("main", 8, TOP_K, N_ROWS), ("q32", 32, TOP_K, N_ROWS),
             ("k129", 8, 129, N_ROWS), ("k1000", 8, 1000, N_ROWS),
             ("kN", 8, n_small, n_small)]
    report = {}
    for name, route in (("topk_scan_bf16", "cmw_rag_tpu/ops/topk.py:164"),
                        ("topk_scan_int8", "cmw_rag_tpu/ops/topk.py:210")):
        int8 = name.endswith("int8")
        for case, nq, k, n in cases:
            t0 = time.time()
            q = q_all[:nq].contiguous()
            c, c8, sc, cid = corpus[:n], corpus8[:n], scales[:n], ids[:n]
            if int8:
                kern = lambda: T.topk_scan_int8(c8, sc, cid, q, k)  # noqa: E731
                plain = lambda: T.topk_plain_int8(c8, sc, cid, q, k)  # noqa: E731
                lib = lambda: library_scan(c8, sc, cid, q, k)  # noqa: E731
                nbytes = n * DIM + 4 * n + 4 * n
            else:
                kern = lambda: T.topk_scan_bf16(c, cid, q, k)  # noqa: E731
                plain = lambda: T.topk_plain(c, cid, q, k)  # noqa: E731
                lib = lambda: library_scan(c, None, cid, q, k)  # noqa: E731
                nbytes = 2 * n * DIM + 4 * n
            nbytes += 2 * nq * DIM + 8 * nq * k
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            ties = [g for g in groups if g[0] < nq] if n == N_ROWS else []
            err = check_against_plain(f"{name} {case}", got, want, cid, ties)
            entry = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
                     "library_ms": cuda_ms(lib, 3), "max_abs_err": err,
                     **bound(nbytes, 2.0 * nq * n * DIM)}
            log(f"kernel-{name}-{case}", time.time() - t0, card_line, Q=nq,
                N=n, D=DIM, k=k, **fmt(entry))
            report[(name, case)] = dict(entry, replaces=route,
                                        shape={"Q": nq, "N": n, "D": DIM,
                                               "k": k})
    del corpus, corpus8, scales, ids
    torch.cuda.empty_cache()
    return report


def flash_phase(card_line: str) -> dict:
    """Hold the flash kernel against its plain twin at the rerank and the
    window shapes; time it, the twin and SDPA."""
    import torch
    import torch.nn.functional as Fn
    from cmw_rag_tpu_torch.ops import flash_attention as F

    gen = torch.Generator(device="cuda").manual_seed(4321)
    report = {}
    for case, (b, h, L, d) in (("rerank", (32, 16, 1024, 128)),
                               ("window", (1, 16, 8192, 128))):
        t0 = time.time()
        q, k, v = (torch.randn((b * h, L, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.randint(L // 2, L + 1, (b,), generator=gen, device="cuda")
        pos = torch.arange(L, device="cuda")
        mask = (pos[None, :] < lens[:, None]).to(torch.int32)
        tile = F.kernel_tile()
        o, lse = F.flash_attention_fwd(q, k, v, mask, h, True)
        po, plse = F.flash_attention_plain(q, k, v, mask, h, True, tile, tile)
        torch.cuda.synchronize()
        o_err = (o.float() - po.float()).abs()
        step = bf16_step(po)
        lse_err = (lse - plse).abs().max().item()
        excess = (o_err - step).max().item()
        if not bool((o_err <= step + O_ABS).all()):
            raise AssertionError(
                f"flash {case}: O differs from the twin by "
                f"{o_err.max().item()}, {excess} past one bf16 step")
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash {case}: LSE differs by {lse_err}")
        keep = ((pos[None, :, None] >= pos[None, None, :])
                & (mask[:, None, :] > 0))[:, None]       # [B, 1, L, L]
        qs, ks, vs = (x.view(b, h, L, d) for x in (q, k, v))
        lib = lambda: Fn.scaled_dot_product_attention(qs, ks, vs,  # noqa: E731
                                                      attn_mask=keep)
        # the work these inputs need: each row against its visible real
        # keys; bytes: q and o whole, k and v over the real keys only (the
        # output does not depend on masked ones), the mask and the LSE
        vis = torch.minimum(pos[None, :] + 1, lens[:, None]).sum().item()
        ops = 4.0 * h * d * vis
        nbytes = (2.0 * 2 * b * h * L * d + 2.0 * 2 * h * d * lens.sum().item()
                  + 4 * b * L + 4 * b * h * L)
        entry = {"ms": cuda_ms(lambda: F.flash_attention_fwd(q, k, v, mask, h,
                                                              True), 20),
                 "plain_ms": cuda_ms(lambda: F.flash_attention_plain(
                     q, k, v, mask, h, True, tile, tile), 3),
                 "library_ms": cuda_ms(lib, 10),
                 "max_abs_err": o_err.max().item(), "lse_max_abs_err": lse_err,
                 "max_err_past_one_step": excess, **bound(nbytes, ops)}
        log(f"kernel-flash_attention_fwd-{case}", time.time() - t0, card_line,
            B=b, H=h, L=L, D=d, causal=True, **fmt(entry))
        report[case] = dict(entry, shape={"B": b, "H": h, "L": L, "D": d,
                                          "causal": True})
        del q, k, v, o, po, keep
        torch.cuda.empty_cache()
    return report


# -------------------------------------------------------------- pipelines


def check_answers(out, n_rows: int, slots, label: str) -> None:
    import numpy as np

    ids, scores = out["ids"], out["rerank_scores"]
    if ids.shape != (len(slots), 10):
        raise AssertionError(f"{label}: ids shape {ids.shape}")
    if not ((ids >= 0) & (ids < n_rows)).all():
        raise AssertionError(f"{label}: invalid ids {ids}")
    if not np.isfinite(scores).all():
        raise AssertionError(f"{label}: non-finite scores")
    if not (np.diff(scores, axis=1) <= 0).all():
        raise AssertionError(f"{label}: scores not descending")
    for i, slot in enumerate(slots):
        if slot not in ids[i].tolist():
            raise AssertionError(f"{label}: planted slot {slot} missing from "
                                 f"query {i}'s top 10 {ids[i].tolist()}")


def pipeline_phase(card_line: str) -> dict:
    import torch
    from cmw_rag_tpu_torch.scripts import shipping as S

    t0 = time.time()
    path = S.ShippingPath()
    torch.cuda.synchronize()
    log("pipeline-setup", time.time() - t0, card_line,
        embedder="frida-hybrid", rerankers=len(path.reranker.members))

    texts, slots = S.PLANTED_TEXTS, S.PLANTED_SLOTS
    qps = {}
    reset_counts()
    for quantize in (False, True):
        t0 = time.time()
        pipe = path.pipeline(quantize)
        label = "int8" if quantize else "bf16"
        name = f"topk_scan_{label}"
        before = read_counts()[name]
        check_answers(pipe.query(texts), S.N_ROWS, slots,
                      label)  # the first batch also warms up
        torch.cuda.synchronize()
        t1 = time.time()
        for i in range(S.TIMED_BATCHES):
            r = i % len(texts)
            out = pipe.query(texts[r:] + texts[:r])
            check_answers(out, S.N_ROWS, slots[r:] + slots[:r], label)
        torch.cuda.synchronize()
        qps[label] = S.TIMED_BATCHES * len(texts) / (time.time() - t1)
        n = read_counts()[name] - before
        if n < 1:
            raise AssertionError(f"{label}: the scan kernel was not launched")
        log(f"pipeline-{label}", time.time() - t0, card_line,
            qps=f"{qps[label]:.2f}", batch=len(texts),
            batches=S.TIMED_BATCHES, launches=n)
        del pipe  # free this corpus before the next one is built
        torch.cuda.empty_cache()
    launches = read_counts()
    for name in ("topk_scan_bf16", "topk_scan_int8"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was launched no time on the path")
    del path
    torch.cuda.empty_cache()
    return {"launches": launches, "qps": qps}


def near_tie_free(scores, gap: float):
    """[Q, K] descending scores → bool mask of positions whose score is more
    than ``gap`` from both neighbours; the last position is never free (its
    lower neighbour is not returned)."""
    import numpy as np

    d = np.abs(np.diff(scores, axis=1)) > gap
    free = np.ones(scores.shape, bool)
    free[:, 1:] &= d
    free[:, :-1] &= d
    free[:, -1] = False
    return free


def card_vs_cpu_phase(card_line: str) -> dict:
    """The shipping pipeline on identical small rows, card against CPU."""
    import numpy as np
    from cmw_rag_tpu_torch.scripts import shipping as S

    t0 = time.time()
    gpu_pipe, vecs, slots = S.small_pipeline("cuda")
    cpu_pipe, _, _ = S.small_pipeline("cpu", vecs)
    texts, n_rows = S.PLANTED_TEXTS, len(vecs)
    out_c, out_g = cpu_pipe.query(texts), gpu_pipe.query(texts)
    check_answers(out_c, n_rows, slots, "small cpu")
    check_answers(out_g, n_rows, slots, "small card")
    ic, ig = out_c["ids"], out_g["ids"]
    sc, sg = out_c["rerank_scores"], out_g["rerank_scores"]
    if not np.array_equal(ic[:, 0], ig[:, 0]):
        raise AssertionError(f"card-vs-cpu: top-1 differs {ic[:, 0]} {ig[:, 0]}")
    free = near_tie_free(sc, CPU_GAP)
    bad = sorted({int(i) for i, _ in zip(*np.nonzero(free & (ic != ig)))})
    if bad:
        raise AssertionError("card-vs-cpu: ids differ away from near ties: " + "; ".join(
            f"query {i}: cpu {ic[i].tolist()} {np.round(sc[i], 4).tolist()} "
            f"card {ig[i].tolist()} {np.round(sg[i], 4).tolist()}" for i in bad))
    drift = 0.0
    for i in range(len(texts)):
        shared = set(ic[i]) & set(ig[i])
        for j in shared:
            a = sc[i][list(ic[i]).index(j)]
            b = sg[i][list(ig[i]).index(j)]
            drift = max(drift, abs(float(a) - float(b)))
    if not drift <= CPU_DRIFT:
        raise AssertionError(f"card-vs-cpu: blended score drift {drift}")
    result = {"positions_equal": int((ic == ig).sum()),
              "positions": int(ic.size),
              "top1_equal": True, "max_score_drift": drift,
              "min_cpu_gap": float(np.abs(np.diff(sc, axis=1)).min()),
              "gap_bound": CPU_GAP, "drift_bound": CPU_DRIFT}
    log("card-vs-cpu", time.time() - t0, card_line, rows=n_rows,
        **fmt(result))
    del cpu_pipe, gpu_pipe
    return result


class Timed:
    """Wraps one stage object's method: host ms per call (the stage returns
    host arrays, so its device work is done) and flash launches inside."""

    def __init__(self, obj, method: str, sink: list):
        from cmw_rag_tpu_torch.ops import flash_attention as F

        self._obj, self._method, self._sink, self._F = obj, method, sink, F

    def __getattr__(self, name):
        attr = getattr(self._obj, name)
        if name != self._method:
            return attr

        def timed(*a, **kw):
            n0, t0 = self._F.total_launches(), time.perf_counter()
            out = attr(*a, **kw)
            self._sink.append((1e3 * (time.perf_counter() - t0),
                               self._F.total_launches() - n0))
            return out
        return timed


def run_queries(lc, emb, store, rr, queries, card_line: str, label: str):
    """Retrieve every query; → (per-query (kb ids, scores), stage stats)."""
    import numpy as np

    stages = {"embed": [], "search": [], "rerank": []}
    ret = lc.retriever(Timed(emb, "embed_queries", stages["embed"]),
                       Timed(store, "search", stages["search"]),
                       Timed(rr, "rerank", stages["rerank"]), ROOT)
    answers, wall = [], []
    for q in queries:
        t0 = time.perf_counter()
        arts = ret.retrieve(q, top_k=10)
        wall.append(1e3 * (time.perf_counter() - t0))
        scores = np.asarray([a.score for a in arts], np.float64)
        if not arts or not np.isfinite(scores).all() \
                or not (np.diff(scores) <= 0).all():
            raise AssertionError(f"{label}: bad answer to {q!r}: "
                                 f"{[(a.kb_id, a.score) for a in arts]}")
        answers.append(([a.kb_id for a in arts], scores))
    stats = {s: {"ms": [round(x[0], 3) for x in v],
                 "flash_launches": sum(x[1] for x in v)}
             for s, v in stages.items()}
    log(f"long-context-{label}", sum(wall) / 1e3, card_line,
        query_ms=json.dumps([round(w, 3) for w in wall]),
        stage_ms=json.dumps({s: v["ms"] for s, v in stats.items()}),
        articles=json.dumps([len(a[0]) for a in answers]))
    return answers, stats


def long_context_phase(card_line: str) -> dict:
    import numpy as np
    import torch
    from cmw_rag_tpu_torch.scripts import long_context as lc

    t0 = time.time()
    emb, rr = lc.build_models("cuda")
    texts, metas, ids = lc.window_chunks(ROOT, emb.tokenizer)
    torch.cuda.synchronize()
    log("long-context-setup", time.time() - t0, card_line,
        embedder=lc.EMBEDDER, reranker=lc.RERANKER, chunks=len(texts),
        layers=emb.cfg.num_layers, d_model=emb.cfg.d_model)

    reset_counts()
    t0 = time.time()
    vecs = emb.embed_documents(texts)
    embed_launches = read_counts()["flash_attention_fwd"]
    store = lc.build_store(emb, texts, metas, ids, vectors=vecs)
    torch.cuda.synchronize()
    log("long-context-index", time.time() - t0, card_line, chunks=len(texts),
        flash_launches=embed_launches)
    answers, stats = run_queries(lc, emb, store, rr, lc.QUERIES, card_line,
                                 "flash")
    launches = read_counts()
    rerank_launches = stats["rerank"]["flash_launches"]
    if embed_launches < 1 or rerank_launches < 1:
        raise AssertionError(f"flash launches: embed {embed_launches}, "
                             f"rerank {rerank_launches}")
    if launches["topk_scan_bf16"] < 1:
        raise AssertionError("topk_scan_bf16 was launched no time on the path")

    # the plain attention route on the card
    t0 = time.time()
    emb.flash_min_seq = rr.flash_min_seq = 1 << 30
    n0 = read_counts()["flash_attention_fwd"]
    plain_vecs = emb.embed_documents(texts)
    cos = float((np.sum(vecs * plain_vecs, axis=1)).min())
    if not cos >= LC_COS:
        raise AssertionError(f"plain vs flash chunk vectors: min cos {cos}")
    plain_answers, _ = run_queries(lc, emb, store, rr, lc.QUERIES, card_line,
                                   "plain")
    if read_counts()["flash_attention_fwd"] != n0:
        raise AssertionError("the plain route launched the flash kernel")
    drift, diffs = 0.0, 0
    for (f_ids, f_s), (p_ids, p_s) in zip(answers, plain_answers):
        common = set(f_ids) & set(p_ids)
        for kb in common:
            drift = max(drift, abs(f_s[f_ids.index(kb)] - p_s[p_ids.index(kb)]))
        n = min(len(f_ids), len(p_ids))
        free = near_tie_free(f_s[None, :n], LC_GAP)[0] if n > 1 else [True]
        for j in range(n):
            if f_ids[j] != p_ids[j]:
                diffs += 1
                if free[j]:
                    raise AssertionError(f"plain route ranks {p_ids} where "
                                         f"flash ranks {f_ids}")
    if not drift <= LC_DRIFT:
        raise AssertionError(f"plain vs flash score drift {drift}")
    result = {"embed_flash_launches": embed_launches,
              "rerank_flash_launches": rerank_launches,
              "launches": launches, "min_chunk_cos": cos,
              "max_score_drift": drift, "near_tie_swaps": diffs,
              "stages": stats}
    log("long-context-plain", time.time() - t0, card_line,
        min_chunk_cos=f"{cos:.6f}", max_score_drift=f"{drift:.6f}",
        near_tie_swaps=diffs)
    del emb, rr, store
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cmw_rag_tpu_torch.ops import cuda_build
    from cmw_rag_tpu_torch.scripts.shipping import card

    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    t0 = time.time()
    cuda_build.build()
    log("build", time.time() - t0, card_line,
        sources=",".join(cuda_build.SOURCES))

    scans = scan_phase(card_line)
    flash = flash_phase(card_line)
    fused = pipeline_phase(card_line)
    card_cpu = card_vs_cpu_phase(card_line)
    long_ctx = long_context_phase(card_line)

    by_path = {"fused": fused["launches"], "long_context": long_ctx["launches"]}
    rows = []
    for name in ("topk_scan_bf16", "topk_scan_int8"):
        main_shape = scans[(name, "main")]
        row = {"name": name, "route": "cuda",
               "source": "cmw_rag_tpu_torch/csrc/topk_scan.cu",
               "replaces": main_shape["replaces"],
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "max_abs_err": max(scans[(name, c)]["max_abs_err"]
                                  for c in ("main", "q32", "k129", "k1000",
                                            "kN"))}
        row.update({k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms",
                                               "shape")})
        for case in ("q32", "k129", "k1000", "kN"):
            row[case] = {k: scans[(name, case)][k]
                         for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "max_abs_err", "shape")}
        rows.append(row)
    fa = flash["rerank"]
    rows.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "cmw_rag_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cmw_rag_tpu/ops/flash_attention.py:306",
        "also_replaces": "cmw_rag_tpu/ops/flash_attention.py:92",
        "launches": long_ctx["launches"]["flash_attention_fwd"],
        "launches_by_stage": {"embed": long_ctx["embed_flash_launches"],
                              "rerank": long_ctx["rerank_flash_launches"]},
        "max_abs_err": max(fa["max_abs_err"], flash["window"]["max_abs_err"]),
        **{k: fa[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "lse_max_abs_err",
                              "max_err_past_one_step", "shape")},
        "window": {k: flash["window"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "lse_max_abs_err", "max_err_past_one_step",
            "shape")},
    })
    print(json.dumps({"kernels": rows, "pipeline_qps": fused["qps"],
                      "card_vs_cpu": card_cpu,
                      "long_context": {k: v for k, v in long_ctx.items()
                                       if k != "launches"},
                      "seconds": round(time.time() - t_all, 3),
                      "card": card_line}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
