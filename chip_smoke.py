#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's shipping query path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds beside the card's name and power limit:

1. build  - compile the hand-written kernels
   (``cmw_rag_tpu_torch/csrc/topk_scan.cu``) with nvcc for sm_90a into
   ``build/cmw_rag_tpu_torch/``.
2. kernels - hold each scan top-k kernel against its plain PyTorch twin on
   the card at N = 1,000,000 rows x D = 5120, k = 20, for Q = 8 (the query
   batch the pipeline below sends) and Q = 32 (8 queries x 4 segments). The
   corpus is filled on the device in slices; 1% of rows are tombstones and
   duplicate rows plant exact ties. Scores must agree to 1e-4 absolute, ids
   must be equal wherever neighbouring scores differ by more than 1e-4, and
   exact ties must come out in ascending id order. Times: the kernel, its
   plain twin, a library yardstick (chunked ``torch.matmul`` + ``torch.topk``,
   timed here only) and the bound (the larger of bytes / 3.35 TB/s and
   operations / 989 TFLOP/s).
3. pipeline - the port's ``FusedPipeline`` with ``frida-hybrid`` and the
   shipping 4-member rerank ensemble on their bundled checkpoints, over a
   1M x 5120 corpus filled on the device with random rows and random chunk
   tokens, in which 8 bilingual chunk texts are planted at known slots
   (``cmw_rag_tpu_torch/scripts/shipping.py``). One warm-up batch and 40
   timed batches of the 8 planted texts run against the bf16 corpus, then
   against the int8 corpus (``quantize=True``). Each planted text, used as
   a query, must return its slot in the top 10; ids must be valid; scores
   finite and descending; each kernel's launch count must rise during this
   phase. The queries/s printed is a smoke reading, not a benchmark.

It then prints one JSON line with every kernel's numbers, the card's
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


def log(phase: str, seconds: float, card_line: str, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[chip_smoke] phase={phase} seconds={seconds:.3f} "
          f"card=\"{card_line}\" {extra}".rstrip(), flush=True)


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
        ts, ti = torch.topk(s, k, dim=1)
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
    tie = gs[:, 1:] == gs[:, :-1]
    if bool((tie & (gi[:, 1:] <= gi[:, :-1])).any()):
        raise AssertionError(f"{name}: exact ties not in ascending id order")
    if bool((gi < 0).any()) or bool((ids[gi.long()] < 0).any()):
        raise AssertionError(f"{name}: a tombstoned or empty row surfaced")
    for q, live in tie_groups:
        if gi[q, : len(live)].tolist() != live:
            raise AssertionError(f"{name}: tie group of query {q} came out "
                                 f"{gi[q, :len(live)].tolist()}, want {live}")
    return err


def kernel_phase(card_line: str) -> dict:
    """Hold both kernels against their plain twins; time all four."""
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

    report = {}
    for name, route in (("topk_scan_bf16", "cmw_rag_tpu/ops/topk.py:164"),
                        ("topk_scan_int8", "cmw_rag_tpu/ops/topk.py:210")):
        int8 = name.endswith("int8")
        for nq in (8, 32):
            t0 = time.time()
            q = q_all[:nq].contiguous()
            if int8:
                kern = lambda: T.topk_scan_int8(corpus8, scales, ids, q, TOP_K)  # noqa: E731
                plain = lambda: T.topk_plain_int8(corpus8, scales, ids, q, TOP_K)  # noqa: E731
                lib = lambda: library_scan(corpus8, scales, ids, q, TOP_K)  # noqa: E731
                nbytes = corpus8.numel() + 4 * N_ROWS + 4 * N_ROWS
            else:
                kern = lambda: T.topk_scan_bf16(corpus, ids, q, TOP_K)  # noqa: E731
                plain = lambda: T.topk_plain(corpus, ids, q, TOP_K)  # noqa: E731
                lib = lambda: library_scan(corpus, None, ids, q, TOP_K)  # noqa: E731
                nbytes = 2 * corpus.numel() + 4 * N_ROWS
            nbytes += 2 * nq * DIM + 8 * nq * TOP_K
            ops = 2.0 * nq * N_ROWS * DIM
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err = check_against_plain(f"{name} Q={nq}", got, want, ids,
                                      [g for g in groups if g[0] < nq])
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 3)
            library_ms = cuda_ms(lib, 3)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
            entry = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": 1e3 * max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "max_abs_err": err}
            log(f"kernel-{name}", time.time() - t0, card_line, Q=nq, N=N_ROWS,
                D=DIM, k=TOP_K, **{k: (f"{v:.4f}" if isinstance(v, float)
                                       else v) for k, v in entry.items()})
            report[(name, nq)] = dict(entry, replaces=route)
    del corpus, corpus8, scales, ids
    torch.cuda.empty_cache()
    return report


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
    from cmw_rag_tpu_torch.ops import topk as T
    from cmw_rag_tpu_torch.scripts import shipping as S

    t0 = time.time()
    path = S.ShippingPath()
    torch.cuda.synchronize()
    log("pipeline-setup", time.time() - t0, card_line,
        embedder="frida-hybrid", rerankers=len(path.reranker.members))

    texts, slots = S.PLANTED_TEXTS, S.PLANTED_SLOTS
    T.topk_scan_bf16.launches = 0
    T.topk_scan_int8.launches = 0
    qps = {}
    for quantize in (False, True):
        t0 = time.time()
        pipe = path.pipeline(quantize)
        label = "int8" if quantize else "bf16"
        before = (T.topk_scan_bf16.launches, T.topk_scan_int8.launches)
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
        after = (T.topk_scan_bf16.launches, T.topk_scan_int8.launches)
        if after[int(quantize)] <= before[int(quantize)]:
            raise AssertionError(f"{label}: the scan kernel was not launched")
        log(f"pipeline-{label}", time.time() - t0, card_line,
            qps=f"{qps[label]:.2f}", batch=len(texts),
            batches=S.TIMED_BATCHES,
            launches=after[int(quantize)] - before[int(quantize)])
        del pipe  # free this corpus before the next one is built
        torch.cuda.empty_cache()
    launches = {"topk_scan_bf16": T.topk_scan_bf16.launches,
                "topk_scan_int8": T.topk_scan_int8.launches}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was launched no time on the path")
    return {"launches": launches, "qps": qps}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cmw_rag_tpu_torch.ops import cuda_build
    from cmw_rag_tpu_torch.scripts.shipping import DIM, N_ROWS, card

    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    cuda_build.build()
    log("build", time.time() - t0, card_line, source=cuda_build.SOURCE.name)

    kernels = kernel_phase(card_line)
    path = pipeline_phase(card_line)

    rows = []
    for name in ("topk_scan_bf16", "topk_scan_int8"):
        main_shape = kernels[(name, 8)]
        q32 = kernels[(name, 32)]
        rows.append({
            "name": name, "route": "cuda",
            "source": "cmw_rag_tpu_torch/csrc/topk_scan.cu",
            "replaces": main_shape["replaces"],
            "launches": path["launches"][name],
            "max_abs_err": max(main_shape["max_abs_err"], q32["max_abs_err"]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": {"Q": 8, "N": N_ROWS, "D": DIM, "k": TOP_K},
            "q32": {k: q32[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")},
        })
    print(json.dumps({"kernels": rows, "pipeline_qps": path["qps"],
                      "card": card_line}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
