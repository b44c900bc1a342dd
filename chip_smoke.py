#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed with its seconds beside the card's name and power limit:

1. build - compile every hand-written kernel source
   (``cmw_rag_tpu_torch/csrc/*.cu``) with nvcc for sm_90a into
   ``build/cmw_rag_tpu_torch/``, one nvcc per source, all started together.
2. kernels - hold each kernel against its plain PyTorch twin on the card.
   Scan top-k (bf16 and int8) at N = 1,000,000 rows x D = 5120: k = 20 for
   Q = 8 (the query batch of the fused path), Q = 32 (8 queries x 4
   segments) and Q = 128 (one chunk, two groups of 64), k = 129 and k = 1000
   for Q = 8, and k = N on the first 4,096 rows; each call's scan and
   selection device times apart (one profiler window, in a process of its
   own) and its workspace's MiB. 1% of rows are tombstones and duplicate rows plant exact ties.
   Scores must agree to 1e-4 absolute, ids wherever neighbouring scores
   differ by more than 1e-4, exact ties must come out in ascending id order.
   Flash attention forward, causal, bf16, with ragged key masks, at the
   rerank shape (B 32, H 16, L 1024, D 128), the window shape (B 1, H 16,
   L 8192, D 128) and the trainer's (B 8, H 16, L 1024, D 128), and at the
   rerank shape with every key real (``full``, also timed beside SDPA's
   unmasked ``is_causal`` call), against the twin run over the kernel's own
   blocks, 128 query rows and 64 keys (``kernel_tiles()``), so that both
   round p to bf16 against the same running maxima: O within one bf16 step
   of the twin's
   |O| (both round O to bf16,
   so values a hair apart may round one step apart) plus ``O_ABS`` (a p
   may still round one step apart: the kernel's ``__expf`` and
   ``torch.exp`` differ in the last float32 bits), the log-sum-exp within
   1e-4. Times: the kernel, its twin, one library call
   timed here only (chunked ``torch.matmul`` + ``torch.topk``;
   ``scaled_dot_product_attention`` with the same mask) and the bound (the
   larger of the bytes the function needs / 3.35 TB/s and the operations
   it needs / 989 TFLOP/s, both counted over the real keys of this run's
   masks). Then the two scans reached only from tests: the int8 x int8
   scan (``topk_scan_int8mxu``: int8 queries quantized per row, exact int32
   sums) over the int8 corpus at Q = 8, k = 20, bit for bit its twin's
   (scores and ids), planted ties in id order; the streaming alias of the
   bf16 scan, bit for bit ``topk_scan_bf16``; each timed as above.
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

6. ivf-kernels - a seeded clustered corpus of 1,000,000 rows x 1024 (4,096
   centres plus noise, 8 rows copied twice for exact ties, 1% tombstones;
   ``cmw_rag_tpu_torch/scripts/ivf.py``) laid out by ``IVFIndex.build``
   with ``block_n`` 1024 and the default ``nlist``, bf16 and int8 (build
   seconds printed). The IVF path: ``IVFIndex.search`` of 32 queries at
   k 10 and ``nprobe`` 4, 16 and 64, as one batch (union kernels) and query
   by query (probed kernels); recall@10 against an exact bf16 scan top-k
   over the same rows (for int8, the rows it was quantised from), and for
   every query the union finding at least what the probed search finds of
   the exact top-10 in the index's own arithmetic. Then each IVF kernel against its plain twin at ``nprobe``
   64, with the phase-2 rules: probed Q 1 and Q 8 at k 20, union Q 8 and
   Q 32 at k 20 and Q 8 at k 129, 256 and 1000. Times: the kernel, its
   twin, one library yardstick timed here only (``index_select`` of the
   probed blocks' rows, ``torch.matmul``, ``torch.topk``) and the bound
   (the rows of the distinct blocks read once, 2D + 4 bytes a row in bf16
   and D + 8 in int8, against 2 x Q x rows scanned x D operations); each
   union record also the scan's and the selection's device times apart,
   from one complete profiler window over all union cases, in a process
   of its own that builds the indexes again (``ivf_union_timings``: late
   in one long process the profiler drops kernel records). The manual-DMA
   alias of the probed kernel (``ivf_probed_scan_dma``) once at Q 1,
   bit for bit ``ivf_probed_scan``.
7. segmented - ``Retriever`` with ``frida-hybrid`` and the rerank ensemble
   over ``TorchVectorStore(kind="segmented")`` with the ``SegmentedIndex``
   defaults: 250,000 rows in batches of 8,192 (the checkout's markdown in
   192-token chunks, the 8 planted texts, seeded random filler), two sealed
   segments and a tail. Each planted text must return its own article in
   the top 10; one ``store.search`` of the 8 planted query vectors as a
   batch runs the union kernel beside the single queries' probed kernel;
   planted chunks deleted from a segment and from the tail never come
   back; after ``save``/``load`` every live id and row comes back (rows
   within one bf16 step: the load normalises and rounds again) and every
   planted chunk not deleted is found. The top-20 overlap of the IVF stage
   with an exact ``FlatIndex`` over the same rows is printed.

8. local-llm - the three paged decode attention kernels against their
   plain twins at qwen3guard-0.6b's attention shapes (Hq 16, Hkv 8, Dh 128,
   page 64) over 28-layer pools read a layer at a time in turn: 4 slots x
   2048 (the serving settings), 8 slots with a 256-token prompt in a
   1024-token context (the decode bench shape) and 32 slots x 1024, ragged
   lengths covering 1, 63, 64, 65 and 2047 and one idle slot on the null
   page; then, at the same three shapes, lengths on both sides of the
   page, split and table boundaries (1, 63, 64, 65, split - 1, split,
   split + 1, the table's width less one and its width). Outputs within one
   bf16 step of the twin's plus ``PAGED_TOL`` (bf16 pages: float32 sums in
   another order) or ``PAGED_INT8_TOL`` (int8 pages: the twin, as JAX's
   golden, rounds dequantized K and V to bf16, the kernel does not); the
   scatter leaves the twin's pools bit for bit (this step's row NaN in the
   pool before the call: the kernel takes it from k_new/v_new); a second
   launch bit for bit the first; one kernel a call (a complete profiled
   window of 56 calls holds 56 paged kernels and nothing else).
   Device times (the union of a call's kernels under ``torch.profiler``: a
   few microseconds of kernel are shorter than the wrapper's Python, which
   events around back-to-back calls would time; that call time is printed
   beside them): kernel at the host's split (``paged_split``) and at each
   of ``PAGED_SPLITS``, twin, a composite library yardstick timed here only
   (the context gathered by index, then ``scaled_dot_product_attention``
   with the length mask) and the bound (K and V of the real positions, q
   and out, over 3.35 TB/s) with the kernel's share of it. Then the engine (``cmw_rag_tpu_torch/scripts/local_llm.py``)
   at full width and depth with seeded random weights (vocabulary 151,680),
   4 slots, context 2048, page 64: 6 ChatML requests of 32 greedy tokens,
   through the gather golden, the scatter kernel, the plain kernel
   (``scatter_fused=False``), int8 KV (golden and kernel) and chunked
   prefill (256): every request finishes; each kernel run launches its
   kernel exactly 28 times a decode step; while a request has been fed the
   same ids as in its reference run, its logits agree within ``LLM_DRIFT``
   at every step and its greedy id is equal unless the reference's top-2
   gap there is under ``LLM_GAP`` = 0.2, where the walk stops
   (``LLM_DRIFT`` is twice the model's bf16 noise floor on random weights:
   the bucketed and chunked prefills, which run no kernel, differ by about
   0.05 in the logits); one decode step at 4 active slots is profiled
   (device busy, idle share, the paged kernel's share). Last, the
   engine transport over an ``EngineLoop`` at full width with the
   tokenizer's vocabulary: a JSON and an SSE chat sent together, their
   wire shapes and usage counts checked.

9. local-llm-int8 - the same engine with int8 weights (the reference's
   ``local_llm_weights = "int8"``). The four int8-path kernels against their
   plain twins over 28 layers' weights read in turn: ``int8_matmul`` at
   (4, 1024, 4096) and (16, 1024, 4096) bf16 and the head (4 and 16,
   1024, 151,680) float32, within one bf16 step plus ``INT8_MM_TOL`` of
   the largest output, bit for bit on a second call, one kernel a call (a
   complete profiler window of 56 calls, its device time the whole
   call's; these records in a process of their own); slot-major
   attention at 4 slots with caps 2 and 6 and at 16 slots, as the paged
   kernel; the fused MLP at 4 and 16 slots and
   the decoder-layer megakernel at 4 slots on its slot-major route and on
   its paged route (one slot of 2,047 positions), within one bf16 step plus
   ``INT8_LAYER_TOL`` of the largest output, the megakernel's written pool
   rows within the same of the twin's and every other row unchanged, bit
   for bit.
   Times as in phase 8, beside a composite library yardstick (dequantize,
   ``torch.matmul``, scale; gather + ``scaled_dot_product_attention``).
   Then the engine at full width, each kernel run against the same
   engine's golden route (``use_kernel=False``) under phase 8's rule: 4
   slots (the megakernel, slot-major while contexts fit 384 tokens, paged
   once a 614-token request joins 8 steps in; both must run), 16 slots
   (``int8_matmul``, slot attention, then the scatter kernel once the long
   request joins, the fused MLP) and 4 slots with int8 KV; every launch
   count exact. The first-step
   logits of int8 against native weights (cosine); one int8 decode step
   profiled (the megakernel's share); a JSON and an SSE chat through
   ``create_local_llm_transport(weights="int8")``.

10. local-llm-w8a8-kv8 - the last decode routes of the same engine at full
   width and depth. ``int8_matmul_w8a8`` against its twin over 28 layers'
   weights read in turn at QKV (4 and 16 slots), wo, gate-up and down (4
   slots; down also at 16) and the head (4 and 16 slots, float32 x), bit
   for bit, and bit for bit itself at other splits of the contraction;
   each call one kernel launch (a complete profiler window of 56 calls
   holds 56 ``w8a8_mma_kernel`` kernels and nothing else), the whole
   call's device time read off that window (these records in a process
   of their own, whose profiler has traced nothing yet); the int8-KV
   megakernel
   ``decoder_layer_int8_kv8`` at 4 slots (contexts 65, 200 and 384, then
   one of 2,047, and an idle slot) under
   phase 9's rule for x, each written int8 value within 1 of the twin's,
   each updated page scale within one bf16 step, every other row and scale
   (the null page's excepted) bit for bit; the batched attention alias bit
   for bit ``paged_decode_attention_dma`` at 4 x 2048. Times as in phase
   9; yardsticks ``torch._int_mm`` with the scales (M padded to 32, the
   least it takes), phase 9's composite with a dequantizing gather, and
   phase 8's gather + SDPA. Then the engine, each route against its golden
   route (``use_kernel=False``) under phase 8's rule, every launch count
   exact: ``weights="w8a8"`` at 4 and 16 slots (W8A8 products and head,
   the scatter kernel) within twice W8A8's own kernel-free floor as this
   run measures it, not ``LLM_DRIFT`` (quantized activations turn a bf16
   rounding change into int8 steps: the golden route with bucketed and
   with chunked prefill differ by 0.144, against 0.058 with native or
   int8 weights; the floor must stay under ``W8A8_FLOOR_MAX``), ids still
   equal unless the top-2 gap is under ``LLM_GAP``, int8
   weights with int8 KV and ``layer_fused=True``
   at 4 slots (the int8-KV megakernel a layer, the 614-token request
   joining 8 steps in), and ``attn_batched=True`` with native weights at 4
   slots (``scatter_fused=False``, so that the batched wrapper itself
   runs). The first-step logits of w8a8 against int8 weights (cosine,
   reported); one profiled decode step each of w8a8 and of the int8-KV
   megakernel; one profiled step each of the ``noattn`` and ``noscatter``
   ablations (native weights, host ms a step); a JSON and an SSE chat
   through ``create_local_llm_transport(weights="w8a8")``.

11. train - the flash attention backward and the contrastive trainer. The
   dQ and dK/dV kernels (``csrc/flash_attention_bwd.cu``) against the
   backward twins, each run over its kernel's own tiles
   (``bwd_kernel_tiles()``: (128, 128) for dQ, (64, 64) for dK/dV, so
   that both skip the same causal blocks), on random bf16 q, k, v and dO
   with the forward kernel's o and lse: first over degenerate key masks
   (B 5, H 4, L 384, causal and not: an end inside a tile, leading zeros
   past the first tile, a row with no real key, holes in the first tile),
   where dK and dV past each row's last real key must be exactly 0; then
   with ragged key masks at the trainer's shape (B 8, H 16, L 1024, D 128,
   causal), the window shape (B 1, H 16, L 8192, causal) and the trainer's
   shape without causality: dQ, dK and dV each within one bf16 step of the
   twin's |value| plus ``BWD_TOL`` of the tensor's largest |value| (both
   round ds to bf16; a ds a float32 bit apart rounds one step apart and
   moves every product it feeds). Times: each kernel (with its share of
   its bound), its twin, the backward of
   ``scaled_dot_product_attention`` with the same boolean mask timed alone
   (one call for dQ, dK and dV), and the bound (bytes: q, dO, lse, delta,
   the mask and the outputs whole, k and v over the real keys; operations:
   2 D per visible (query, real key) pair for each product, 3 for dQ, 4 for
   dK/dV, 5 for the whole backward). Then ``ContrastiveTrainer`` on
   full-width, full-depth ``qwen3-embedding-0.6b`` (bf16, random weights
   from a seeded CPU generator) with ``use_flash=True``, last-token
   pooling, 1024 tokens, a batch of 8 pairs of the checkout's markdown
   (768-token windows of ``scripts/long_context.py``, each query the first
   300 characters of the window after its document): (a) the first step's loss within
   ``TRAIN_LOSS`` of plain attention's on the same weights and batch and
   every leaf's gradient cosine at least ``TRAIN_COS`` (the plain route's
   gradients by the chain rule from the pooled vectors, 4 rows at a time,
   since its float32 [B, H, L, L] probabilities for both towers at once do
   not fit the card); (b) 5 AdamW steps (lr 1e-4) through ``train``: every
   loss finite, the last below the first; (c) exactly 56 forward, 56 dQ
   and 56 dK/dV launches a step (28 layers, two towers); host ms a step,
   device busy ms of one more step under ``torch.profiler``, peak memory
   and tokens a second; (d) ``save``, then ``restore`` into a fresh
   trainer: every parameter bit for bit.

12. eval - the judged retrieval eval through the port's entry points at
   ``EVAL_latest.json``'s ``shipped_config``: the generated dataset
   (fingerprint ``2b4c73b23aac7cf6``, 312 queries, 8,320 articles), chunks
   of 128 / 16 (31,841), ``create_embedder`` / ``create_reranker`` on the
   card in bf16 (``frida-hybrid``; the 4-member ensemble, current version
   v6: an identity fallback fails the phase), then ``evaluate_retrieval``
   for ``shipped_stage1`` and ``shipped`` (rerank window 20, sibling
   expansion 6 / 3). Gate 1: ndcg@10, recall@10 and mrr_grade3 of each row
   within 2 bootstrap standard errors (the standard deviation of the mean
   of the run's own 312 per-query values over 1,000 resamples drawn with
   ``numpy.random.default_rng(0)``) of the record. Gate 2: the mean per-query
   difference from the JAX package's rows (``tests/eval_reference_jax.json``,
   made on a CPU by ``tests/eval_reference_jax.py``) within 3 paired
   bootstrap standard errors, with the share of queries whose metrics are
   equal. Seconds by stage; #1 launched (one search a row), its plain twin
   never called; #1 at the eval's shape (all 312 queries over the index's
   rows in one call, k 30 and 60) against its twin, timed beside its bound
   and the library call.

Every kernel's launch count is set to 0 just before each path (3, 5, 6, 7,
8, 9, 10, 11 and 12) is driven and read just after; each kernel of a path must have launched. The
script then prints one JSON line with every kernel's numbers, the card's
``nvidia-smi`` name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero; without CUDA, or outside a checkout, it exits non-zero
before printing any result. It imports torch, numpy and the port only.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOP_K = 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak, H100 SXM
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak, H100 SXM
TOL = 1e-4
LSE_TOL = 1e-4
O_ABS = 2e-3
CPU_DRIFT = 0.05
CPU_GAP = 2 * CPU_DRIFT
LC_COS = 0.99
LC_DRIFT = 0.05
LC_GAP = 2 * LC_DRIFT
PAGED_TOL = 1e-5
PAGED_INT8_TOL = 2e-2
# the full-width model on random weights turns any one bf16 rounding that
# lands otherwise into a logit drift of about 0.05: two kernel-free
# computations of the same prompt's logits (bucketed and chunked prefill)
# differ by 0.054 on the card, so the engine checks allow twice that floor,
# and greedy ids may differ only where the reference's top-2 gap is under
# twice that drift (two logits that each move by at most the drift can
# swap only there)
LLM_DRIFT = 0.1
LLM_GAP = 2 * LLM_DRIFT
# the same rule for W8A8 weights, with the floor measured in the run:
# quantizing the activations turns a bf16 rounding that lands otherwise
# into an int8 step on some elements, so two kernel-free computations
# differ more (the golden route with bucketed and with chunked prefill:
# 0.144 on the card, against 0.058 with native or int8 weights). Phase 10
# holds the W8A8 routes to twice the floor it measures, which itself must
# stay under this; their ids may still swap only under LLM_GAP
W8A8_FLOOR_MAX = LLM_GAP
# int8_matmul against its twin: one bf16 step where the output is bf16, plus
# this share of the largest |output| (the tensor cores' truncating sums of
# at most 3,072 exact products, in another order: a few 1e-7 of it on the
# model of tests/tensor_core_model.py)
INT8_MM_TOL = 1e-5
# the fused MLP and the megakernel against their twins (outputs and the
# megakernel's written K/V rows): one bf16 step plus this share of the
# largest |value|. Both round the normed input, y and h to bf16; where
# float32 sums in another order (or rsqrtf against torch.rsqrt) put one of
# those a bf16 step apart, every product it feeds moves by that step times
# a weight: up to ~5e-4 of the output's scale (a K row two bf16 steps apart
# in a card test)
INT8_LAYER_TOL = 1e-3
# the flash backward kernels against their twin: one bf16 step at the twin's
# magnitude plus this share of the tensor's largest |value|. Both round ds to
# bf16 before dS K and dS^T Q; where p or dP comes out a float32 bit apart
# (expf against torch.exp, sums in another order) a ds rounds one bf16 step
# (2^-8 of itself) apart, and every dQ or dK element it feeds moves by that
# step times a K or Q value: up to 3.5e-4 of the largest |dQ| or |dK| at
# the trainer's shape on the card, so this allows about three times that
BWD_TOL = 1e-3
# the trainer's first step, flash route against plain attention on the same
# weights and batch: every leaf's gradient cosine at least TRAIN_COS, the
# loss within TRAIN_LOSS (the two routes round p to bf16 against other
# running maxima, which moves a pooled unit vector by ~1e-3 and a logit,
# divided by the temperature 0.05, by a few hundredths)
TRAIN_COS = 0.99
TRAIN_LOSS = 0.05


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


def device_profile(fn, iters: int, kernel: str | None = None) -> tuple:
    """Device time of one ``fn()`` (the union of its CUDA kernels'
    intervals under ``torch.profiler``, over ``iters`` calls), the names of
    the CUDA kernels the window recorded and the windows dropped as
    short of their count (``profile_query.kernel_window``: ``iters``
    ``kernel`` events, or without ``kernel`` any kernel; three short
    windows raise, so no time is read off an empty window). Events around
    back-to-back calls would time the host once a kernel is shorter than
    its wrapper's Python."""
    from cmw_rag_tpu_torch.scripts.profile_query import _busy_us, kernel_window

    events, dropped = kernel_window(fn, iters, kernel)
    return (_busy_us(events) / 1e3 / iters, [e.name for e in events],
            dropped)


def device_ms(fn, iters: int, kernel: str | None = None) -> float:
    """``device_profile``'s time alone."""
    return device_profile(fn, iters, kernel)[0]


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_step(x):
    """One bf16 step (unit in the last place) at each element's magnitude;
    0 where the element is 0."""
    import torch

    x = x.float()
    step = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
    return torch.where(x == 0, torch.zeros_like(x), step)


#: phase 2's flat scan records: (case, Q, k, rows) over the 1M x 5120
#: corpus (rows None: all; ``kN``: its first 4,096 rows, k = N); Q 32 is 8
#: queries x 4 segments, Q 128 one chunk of two groups of 64
SCAN_CASES = (("main", 8, TOP_K, None), ("q32", 32, TOP_K, None),
              ("q128", 128, TOP_K, None), ("k129", 8, 129, None),
              ("k1000", 8, 1000, None), ("kN", 8, 4096, 4096))
SCAN_QUERIES = max(q for _, q, _, _ in SCAN_CASES)

#: phase 6's kernel records: (case, route, Q, k) at nprobe 64
IVF_CASES = (("q1", "probed", 1, TOP_K), ("q8", "probed", 8, TOP_K),
             ("q8", "union", 8, TOP_K), ("q32", "union", 32, TOP_K),
             ("q8k129", "union", 8, 129), ("q8k256", "union", 8, 256),
             ("q8k1000", "union", 8, 1000))
#: the IVF wrappers and the TPU kernels they replace
IVF_KERNELS = {"ivf_probed_scan": "cmw_rag_tpu/ops/ivf_scan.py:95",
               "ivf_probed_scan_int8": "cmw_rag_tpu/ops/ivf_scan.py:567",
               "ivf_union_scan": "cmw_rag_tpu/ops/ivf_scan.py:340",
               "ivf_union_scan_int8": "cmw_rag_tpu/ops/ivf_scan.py:452"}


#: the paged attention wrappers and the TPU kernels they replace
PAGED_KERNELS = {
    "paged_decode_attention_dma": "cmw_rag_tpu/ops/paged_attention.py:469",
    "paged_decode_attention_dma_scatter":
        "cmw_rag_tpu/ops/paged_attention.py:559",
    "paged_decode_attention_dma_kv_int8":
        "cmw_rag_tpu/ops/paged_attention.py:858"}


#: the paged TPU kernels whose function the port gives through another
#: wrapper's kernel (aliases; the card tests hold them bit for bit equal)
PAGED_ALIASES = {"paged_decode_attention_dma": [
    "cmw_rag_tpu/ops/paged_attention.py:187",
    "cmw_rag_tpu/ops/paged_attention.py:641"]}


#: the int8-weight decode wrappers: (TPU kernel replaced, CUDA source)
INT8_KERNELS = {
    "int8_matmul": ("cmw_rag_tpu/ops/int8_matmul.py:59",
                    "cmw_rag_tpu_torch/csrc/int8_matmul.cu"),
    "paged_decode_attention_dma_slot": (
        "cmw_rag_tpu/ops/paged_attention.py:1024",
        "cmw_rag_tpu_torch/csrc/slot_attention.cu"),
    "fused_mlp_int8": ("cmw_rag_tpu/ops/fused_mlp.py:101",
                       "cmw_rag_tpu_torch/csrc/fused_mlp.cu"),
    "decoder_layer_int8": ("cmw_rag_tpu/ops/decoder_layer.py:264",
                           "cmw_rag_tpu_torch/csrc/decoder_layer.cu")}


#: the wrappers reached only from tests (no main path): (TPU kernel, CUDA
#: source); each is launched once in its phase, bit for bit its kernel
OFF_PATH_KERNELS = {
    "topk_scan_int8mxu": ("cmw_rag_tpu/ops/topk.py:290",
                          "cmw_rag_tpu_torch/csrc/topk_scan.cu"),
    "topk_scan_stream": ("cmw_rag_tpu/ops/topk.py:418",
                         "cmw_rag_tpu_torch/csrc/ivf_scan.cu"),
    "ivf_probed_scan_dma": ("cmw_rag_tpu/ops/ivf_scan.py:231",
                            "cmw_rag_tpu_torch/csrc/ivf_scan.cu")}

#: phase 10's W8A8 cases: each product of a layer and the head, at 4 and
#: 16 slots
W8A8_CASES = ("qkv-s4", "wo-s4", "gateup-s4", "down-s4", "head-s4",
              "qkv-s16", "down-s16", "head-s16")

#: the phase-10 decode wrappers: (TPU kernel replaced, CUDA source)
W8A8_KV8_KERNELS = {
    "int8_matmul_w8a8": ("cmw_rag_tpu/ops/int8_matmul.py:133",
                         "cmw_rag_tpu_torch/csrc/int8_matmul.cu"),
    "decoder_layer_int8_kv8": ("cmw_rag_tpu/ops/decoder_layer.py:618",
                               "cmw_rag_tpu_torch/csrc/decoder_layer_kv8.cu"),
    "paged_decode_attention_dma_batched": (
        "cmw_rag_tpu/ops/paged_attention.py:1241",
        "cmw_rag_tpu_torch/csrc/paged_attention.cu")}


#: the flash backward wrappers: (TPU kernel replaced, CUDA source); both
#: pallas_calls are in ``_fa_bwd_rule`` (``flash_attention.py:365``)
BWD_KERNELS = {
    "flash_attention_bwd_dq": ("cmw_rag_tpu/ops/flash_attention.py:388",
                               "cmw_rag_tpu_torch/csrc/flash_attention_bwd.cu"),
    "flash_attention_bwd_dkv": ("cmw_rag_tpu/ops/flash_attention.py:418",
                                "cmw_rag_tpu_torch/csrc/flash_attention_bwd.cu")}


def new_wrappers() -> dict:
    """The wrappers of phase 10 and the off-path aliases, by name."""
    from cmw_rag_tpu_torch.ops import decoder_layer as DL
    from cmw_rag_tpu_torch.ops import int8_matmul as IM
    from cmw_rag_tpu_torch.ops import ivf_scan as V
    from cmw_rag_tpu_torch.ops import paged_attention as PA
    from cmw_rag_tpu_torch.ops import topk as T

    return {"int8_matmul_w8a8": IM.int8_matmul_w8a8,
            "decoder_layer_int8_kv8": DL.decoder_layer_int8_kv8,
            "paged_decode_attention_dma_batched":
                PA.paged_decode_attention_dma_batched,
            "topk_scan_int8mxu": T.topk_scan_int8mxu,
            "topk_scan_stream": T.topk_scan_stream,
            "ivf_probed_scan_dma": V.ivf_probed_scan_dma}


def int8_wrappers() -> dict:
    from cmw_rag_tpu_torch.ops import decoder_layer as DL
    from cmw_rag_tpu_torch.ops import fused_mlp as FM
    from cmw_rag_tpu_torch.ops import int8_matmul as IM
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    return {"int8_matmul": IM.int8_matmul,
            "paged_decode_attention_dma_slot":
                PA.paged_decode_attention_dma_slot,
            "fused_mlp_int8": FM.fused_mlp_int8,
            "decoder_layer_int8": DL.decoder_layer_int8}


def reset_counts() -> None:
    from cmw_rag_tpu_torch.ops import flash_attention as F
    from cmw_rag_tpu_torch.ops import ivf_scan as V
    from cmw_rag_tpu_torch.ops import paged_attention as PA
    from cmw_rag_tpu_torch.ops import topk as T

    T.topk_scan_bf16.launches = 0
    T.topk_scan_int8.launches = 0
    F.reset_launches()
    for name in IVF_KERNELS:
        getattr(V, name).launches = 0
    PA.reset_launches()
    for fn in (*int8_wrappers().values(), *new_wrappers().values()):
        fn.launches = 0


def read_counts() -> dict:
    from cmw_rag_tpu_torch.ops import flash_attention as F
    from cmw_rag_tpu_torch.ops import ivf_scan as V
    from cmw_rag_tpu_torch.ops import paged_attention as PA
    from cmw_rag_tpu_torch.ops import topk as T

    return {"topk_scan_bf16": T.topk_scan_bf16.launches,
            "topk_scan_int8": T.topk_scan_int8.launches,
            "flash_attention_fwd": F.total_launches(),
            **{name: getattr(F, name).launches for name in BWD_KERNELS},
            **{name: getattr(V, name).launches for name in IVF_KERNELS},
            **{name: getattr(PA, name).launches for name in PAGED_KERNELS},
            **{name: fn.launches for name, fn in int8_wrappers().items()},
            **{name: fn.launches for name, fn in new_wrappers().items()}}


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


def check_against_plain(name, got, want, ids, tie_groups, beyond=None):
    """Scores to TOL; ids equal wherever neighbours differ by more than TOL
    (``beyond``, the twin's score just past its k-th [Q], when given,
    stands as the last position's lower neighbour); exact ties in
    ascending id order; no tombstone; planted tie groups surface whole and
    in id order. Returns the largest score error."""
    import torch

    (gs, gi), (ws, wi) = got, want
    err = (gs - ws).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name}: max |score - plain| = {err}")
    gap = (ws[:, 1:] - ws[:, :-1]).abs() > TOL
    clear = torch.ones_like(wi, dtype=torch.bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    if beyond is not None:
        clear[:, -1] &= (ws[:, -1] - beyond).abs() > TOL
    if not torch.equal(gi[clear], wi[clear]):
        where = (gi != wi) & clear
        q, j = (int(x) for x in where.nonzero()[0])
        raise AssertionError(
            f"{name}: ids differ from the plain twin at {int(where.sum())} "
            f"places, first query {q} position {j}: {int(gi[q, j])} against "
            f"{int(wi[q, j])}, twin scores "
            f"{ws[q, max(j - 1, 0):j + 2].tolist()}")
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


def scan_inputs() -> tuple:
    """Phase 2's corpus over the card, from a seed: → (bf16 rows [N, D],
    ids [N] with 1% tombstones, the 8 planted tie groups as (query, ids),
    queries [SCAN_QUERIES, D] whose first 8 equal the groups' rows, int8
    rows, their scales)."""
    import torch
    from cmw_rag_tpu_torch.scripts.shipping import (DIM, N_ROWS,
                                                    fill_unit_rows,
                                                    quantize_slices)

    gen = torch.Generator(device="cuda").manual_seed(1234)
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
    q_all = torch.cat([q_all, fill_unit_rows(SCAN_QUERIES - 32, DIM, gen)])
    q_all[:8] = corpus[srcs]
    corpus8, scales = quantize_slices(corpus)
    return corpus, ids, groups, q_all, corpus8, scales


def scan_calls(corpus, ids, q_all, corpus8, scales):
    """#1's and #2's call at each of ``SCAN_CASES``: → {"name/case":
    (call, Q, k, rows)}."""
    from cmw_rag_tpu_torch.ops import topk as T
    from cmw_rag_tpu_torch.scripts.shipping import N_ROWS

    calls = {}
    for case, nq, k, n in SCAN_CASES:
        n = n or N_ROWS
        q = q_all[:nq].contiguous()
        calls[f"topk_scan_bf16/{case}"] = (functools.partial(
            T.topk_scan_bf16, corpus[:n], ids[:n], q, k), nq, k, n)
        calls[f"topk_scan_int8/{case}"] = (functools.partial(
            T.topk_scan_int8, corpus8[:n], scales[:n], ids[:n], q, k), nq,
            k, n)
    return calls


def scan_timings() -> dict:
    """Device ms of #1's and #2's scan and selection apart at each of
    ``SCAN_CASES`` (``scan_select_ms``, one a chunk of queries), over
    phase 2's corpus made again, for ``timings_child``: → {"name/case":
    {"ms", "scan_ms", "select_ms"}}."""
    import torch
    from cmw_rag_tpu_torch.ops import ivf_scan as V

    corpus, ids, _, q_all, corpus8, scales = scan_inputs()
    calls = scan_calls(corpus, ids, q_all, corpus8, scales)
    stream = torch.cuda.current_stream().cuda_stream
    chunks = {key: -(-nq // V.flat_launch_sizes(corpus.device, stream, nq, n,
                                                k)["chunk"])
              for key, (_, nq, k, n) in calls.items()}
    times = scan_select_ms({key: c[0] for key, c in calls.items()},
                           chunks=chunks)
    return {key: {"ms": t["scan_ms"] + t["select_ms"], **t}
            for key, t in times.items()}


def scan_phase(card_line: str) -> dict:
    """Hold both scan kernels against their plain twins and time all four
    (``scan_records``), then #1's and #2's scan and selection launches
    apart in a process of their own (``scan_timings``: late in one long
    process the profiler drops kernel records, so phase 2 opens none)."""
    import gc

    import torch

    report = scan_records(card_line)
    gc.collect()
    torch.cuda.empty_cache()
    for key, t in timings_child(card_line, "scan_timings").items():
        report[tuple(key.split("/"))].update(
            {x: t[x] for x in ("scan_ms", "select_ms")})
    return report


def scan_records(card_line: str) -> dict:
    """Phase 2's records of the four scans against their twins."""
    import torch
    from cmw_rag_tpu_torch.ops import ivf_scan as V
    from cmw_rag_tpu_torch.ops import topk as T
    from cmw_rag_tpu_torch.scripts.shipping import DIM, N_ROWS

    t0 = time.time()
    corpus, ids, groups, q_all, corpus8, scales = scan_inputs()
    torch.cuda.synchronize()
    log("kernels-setup", time.time() - t0, card_line, rows=N_ROWS, dim=DIM)

    calls = scan_calls(corpus, ids, q_all, corpus8, scales)
    stream = torch.cuda.current_stream().cuda_stream
    report = {}
    for name, route in (("topk_scan_bf16", "cmw_rag_tpu/ops/topk.py:164"),
                        ("topk_scan_int8", "cmw_rag_tpu/ops/topk.py:210")):
        int8 = name.endswith("int8")
        for case, nq, k, n in SCAN_CASES:
            t0 = time.time()
            n = n or N_ROWS
            q = q_all[:nq].contiguous()
            c, c8, sc, cid = corpus[:n], corpus8[:n], scales[:n], ids[:n]
            kern = calls[f"{name}/{case}"][0]
            if int8:
                plain = lambda: T.topk_plain_int8(c8, sc, cid, q, k)  # noqa: E731
                lib = lambda: library_scan(c8, sc, cid, q, k)  # noqa: E731
                nbytes = n * DIM + 4 * n + 4 * n
            else:
                plain = lambda: T.topk_plain(c, cid, q, k)  # noqa: E731
                lib = lambda: library_scan(c, None, cid, q, k)  # noqa: E731
                nbytes = 2 * n * DIM + 4 * n
            nbytes += 2 * nq * DIM + 8 * nq * k
            # the workspace this call makes: the tensors the stream holds
            # after it, made anew
            V._WORKSPACES.pop((corpus.device.index, stream), None)
            got = kern()
            held = V.workspace_bytes(corpus.device, stream)
            want = plain()
            torch.cuda.synchronize()
            ties = [g for g in groups if g[0] < nq] if n == N_ROWS else []
            err = check_against_plain(f"{name} {case}", got, want, cid, ties)
            entry = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
                     "library_ms": cuda_ms(lib, 3), "max_abs_err": err,
                     **bound(nbytes, 2.0 * nq * n * DIM),
                     "workspace_mib": held / 2**20}
            log(f"kernel-{name}-{case}", time.time() - t0, card_line, Q=nq,
                N=n, D=DIM, k=k, **fmt(entry))
            report[(name, case)] = dict(entry, replaces=route,
                                        shape={"Q": nq, "N": n, "D": DIM,
                                               "k": k})
    # the scans reached only from tests, each once at the main shape
    nq, k = 8, TOP_K
    q = q_all[:nq].contiguous()
    off_path = {
        "topk_scan_int8mxu": (
            lambda: T.topk_scan_int8mxu(corpus8, scales, ids, q, k),
            lambda: T.topk_plain_int8mxu(corpus8, scales, ids, q, k),
            lambda: library_scan(corpus8, scales, ids, q, k),
            N_ROWS * DIM + 8 * N_ROWS + nq * DIM, INT8_OPS_PER_S),
        "topk_scan_stream": (
            lambda: T.topk_scan_stream(corpus, ids, q, k),
            lambda: T.topk_scan_bf16(corpus, ids, q, k),
            lambda: library_scan(corpus, None, ids, q, k),
            2 * N_ROWS * DIM + 4 * N_ROWS + 2 * nq * DIM, BF16_OPS_PER_S)}
    for name, (kern, twin, lib, nbytes, rate) in off_path.items():
        t0 = time.time()
        got, want = kern(), twin()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: differs from "
                                 f"{'its twin' if 'int8' in name else 'topk_scan_bf16'}")
        err = check_against_plain(f"{name} main", got, want, ids, groups)
        plain = (lambda: T.topk_plain(corpus, ids, q, k)) \
            if name == "topk_scan_stream" else twin
        entry = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
                 "library_ms": cuda_ms(lib, 3), "max_abs_err": err,
                 **bound(nbytes + 8 * nq * k, 2.0 * nq * N_ROWS * DIM, rate)}
        log(f"kernel-{name}-main", time.time() - t0, card_line, Q=nq,
            N=N_ROWS, D=DIM, k=k, **fmt(entry))
        report[(name, "main")] = dict(entry, shape={"Q": nq, "N": N_ROWS,
                                                    "D": DIM, "k": k})
    return report


def flash_phase(card_line: str) -> dict:
    """Hold the flash kernel against its plain twin at the rerank, window,
    trainer's and ``full`` (every key real) shapes; time it, the twin and
    SDPA (masked; for ``full`` also unmasked)."""
    import torch
    import torch.nn.functional as Fn
    from cmw_rag_tpu_torch.ops import flash_attention as F

    gen = torch.Generator(device="cuda").manual_seed(4321)
    report = {}
    for case, (b, h, L, d) in (("rerank", (32, 16, 1024, 128)),
                               ("window", (1, 16, 8192, 128)),
                               ("train", (8, 16, 1024, 128)),
                               ("full", (32, 16, 1024, 128))):
        t0 = time.time()
        q, k, v = (torch.randn((b * h, L, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        lens = (torch.full((b,), L, device="cuda") if case == "full" else
                torch.randint(L // 2, L + 1, (b,), generator=gen,
                              device="cuda"))
        pos = torch.arange(L, device="cuda")
        mask = (pos[None, :] < lens[:, None]).to(torch.int32)
        tiles = F.kernel_tiles()
        o, lse = F.flash_attention_fwd(q, k, v, mask, h, True)
        po, plse = F.flash_attention_plain(q, k, v, mask, h, True, *tiles)
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
                     q, k, v, mask, h, True, *tiles), 3),
                 "library_ms": cuda_ms(lib, 10),
                 "max_abs_err": o_err.max().item(), "lse_max_abs_err": lse_err,
                 "max_err_past_one_step": excess, **bound(nbytes, ops)}
        if case == "full":   # every key real: SDPA may take its flash route
            entry["library_unmasked_ms"] = cuda_ms(
                lambda: Fn.scaled_dot_product_attention(qs, ks, vs,
                                                        is_causal=True), 10)
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


# ---------------------------------------------------------------- IVF path


def library_ivf(corpus, scales, ids, queries, table, k, block_n):
    """Yardstick only: ``index_select`` of the listed blocks' rows (table
    [Q, P]: each query its own; [1, U]: shared), ``torch.matmul`` (bf16),
    ``torch.topk``."""
    import torch

    qn, d = queries.shape
    rows = (table.long()[:, :, None] * block_n
            + torch.arange(block_n, device=table.device)).reshape(
                table.shape[0], -1)
    c = corpus.index_select(0, rows.reshape(-1)).to(torch.bfloat16)
    if table.shape[0] == 1:
        s = torch.matmul(queries, c.T).float()
    else:
        s = torch.matmul(c.view(qn, -1, d), queries[:, :, None])[..., 0].float()
    if scales is not None:
        s = s * scales[rows]
    i = ids[rows].expand(qn, -1)
    s = s.masked_fill(i < 0, float("-inf"))
    ts, ti = torch.topk(s, k, dim=1)
    return ts, i.gather(1, ti)


def scan_select_ms(kerns: dict, iters: int = 10, tries: int = 3,
                   chunks: dict | None = None) -> dict:
    """Device ms of each IVF or flat scan call's launches apart, the scan
    (``ivf_scan_kernel``) and the selection (``select_kernel``), one of
    each a chunk of queries (``chunks``: key -> chunks a call, 1 where not
    given), for every call of ``kerns`` (key -> call) from one complete
    ``torch.profiler`` window over all of them, ``iters`` calls each in
    turn (one window for all, not one a call: many profiler sessions in
    one process lose later windows' records); a window short of any
    record is taken again, ``tries`` in all. → {key: {"scan_ms",
    "select_ms"}}, each summed over a call's chunks."""
    from cmw_rag_tpu_torch.scripts.profile_query import kernel_window

    keys = list(kerns)
    per = {key: (chunks or {}).get(key, 1) for key in keys}

    def run():
        for key in keys:
            for _ in range(iters):
                kerns[key]()

    def ms(events):
        return sum(e.time_range.end - e.time_range.start
                   for e in events) / 1e3 / iters

    for _ in range(tries):
        events, _ = kernel_window(run, 1, "ivf_scan_kernel")
        ours = sorted((e for e in events if "ivf_scan_kernel" in e.name
                       or "select_kernel" in e.name),
                      key=lambda e: e.time_range.start)
        if len(ours) != 2 * iters * sum(per.values()):
            continue
        out, at = {}, 0
        for key in keys:
            mine = ours[at: at + 2 * iters * per[key]]
            at += len(mine)
            scan = [e for e in mine if "ivf_scan_kernel" in e.name]
            select = [e for e in mine if "select_kernel" in e.name]
            if len(scan) != iters * per[key] or len(select) != len(scan):
                break
            out[key] = {"scan_ms": ms(scan), "select_ms": ms(select)}
        else:
            return out
    raise RuntimeError(f"{tries} profiler windows of {iters} calls of "
                       f"{len(keys)} scan cases were all incomplete")


def ivf_recall(idx, q, truth, own_truth, card_line: str, label: str) -> dict:
    """The IVF path: ``IVFIndex.search`` of the queries ``q`` (float32, unit)
    as a batch (union) and query by query (probed) at nprobe 4, 16, 64;
    recall@10 against the exact bf16 ids ``truth``. Against ``own_truth``,
    the exact top-10 over the index's own rows in its own arithmetic, the
    union, which scans a superset of each query's blocks, must find at
    least as many as the probed search."""
    import numpy as np
    from cmw_rag_tpu_torch.scripts import ivf as I

    out = {}
    for nprobe in (4, 16, I.NPROBE):
        _, union = idx.search(q, 10, nprobe=nprobe)
        probed = np.concatenate([idx.search(q[j : j + 1], 10, nprobe=nprobe)[1]
                                 for j in range(len(q))])
        hits_u = [len(set(u) & set(t)) for u, t in zip(union, truth)]
        hits_p = [len(set(p) & set(t)) for p, t in zip(probed, truth)]
        worse = [j for j, (u, p, t) in enumerate(zip(union, probed, own_truth))
                 if len(set(u) & set(t)) < len(set(p) & set(t))]
        if worse:
            raise AssertionError(f"ivf {label} nprobe {nprobe}: union recall "
                                 f"below probed for queries {worse}")
        out[nprobe] = {"union": sum(hits_u) / (10 * len(q)),
                       "probed": sum(hits_p) / (10 * len(q))}
    log(f"ivf-recall-{label}", 0.0, card_line,
        recall_at_10=json.dumps({str(p): v for p, v in out.items()}))
    return out


def ivf_phase(card_line: str) -> dict:
    """Build the 1M x 1024 IVF index (bf16, int8), drive its search path,
    and hold each IVF kernel against its plain twin."""
    import torch
    from cmw_rag_tpu_torch.index.ivf import IVFIndex, union_blocks
    from cmw_rag_tpu_torch.ops import ivf_scan as V
    from cmw_rag_tpu_torch.ops import topk as T
    from cmw_rag_tpu_torch.scripts import ivf as I

    t0 = time.time()
    rows, ids, queries, groups = I.clustered_corpus()
    torch.cuda.synchronize()
    log("ivf-setup", time.time() - t0, card_line, rows=I.N_ROWS, dim=I.DIM)
    build_s, index = {}, {}
    for label, quantize in (("bf16", False), ("int8", True)):
        t0 = time.time()
        index[label] = IVFIndex.build(rows, ids, block_n=I.BLOCK_N,
                                      quantize=quantize)
        torch.cuda.synchronize()
        build_s[label] = time.time() - t0
        log(f"ivf-build-{label}", build_s[label], card_line,
            nlist=index[label].n_blocks, block_n=I.BLOCK_N)
    del rows
    torch.cuda.empty_cache()

    # exact top-10 over each index's own rows (outside the path's counts)
    b, b8 = index["bf16"], index["int8"]
    qf = queries.float()
    qf = (qf / qf.norm(dim=1, keepdim=True)).cpu().numpy()
    qt = torch.from_numpy(qf).cuda().bfloat16()
    truth = {"bf16": T.topk_scan_bf16(b.corpus, b.ids, qt, 10)[1].cpu().numpy(),
             "int8": T.topk_scan_int8(b8.corpus, b8.scales, b8.ids, qt,
                                      10)[1].cpu().numpy()}
    reset_counts()
    t0 = time.time()
    recall = {label: ivf_recall(index[label], qf, truth["bf16"], truth[label],
                                card_line, label) for label in ("bf16", "int8")}
    launches = read_counts()
    for name in IVF_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was launched no time on the IVF path")
    log("ivf-path", time.time() - t0, card_line, launches=json.dumps(
        {n: launches[n] for n in IVF_KERNELS}))

    report = {}
    d, bn = I.DIM, I.BLOCK_N
    for label, idx in (("bf16", b), ("int8", b8)):
        sc = idx.scales
        for case, kind, nq, k in IVF_CASES:
            t0 = time.time()
            q = queries[:nq].contiguous()
            probes = idx.probe(q.float(), I.NPROBE)
            name = f"ivf_{kind}_scan" + ("_int8" if sc is not None else "")
            fn = getattr(V, name)
            if kind == "union":
                table, nu = union_blocks(probes)
                blocks = table[: int(nu.item())]
                args = (table, k, bn, nu)
                plain = lambda: V.ivf_union_plain(  # noqa: E731
                    idx.corpus, idx.ids, q, *args, scales=sc)
                lib_table = blocks[None, :]
                scanned = nq * blocks.numel() * bn
            else:
                args = (probes, k, bn)
                plain = lambda: V.ivf_probed_plain(  # noqa: E731
                    idx.corpus, idx.ids, q, *args, scales=sc)
                lib_table = probes
                blocks = torch.unique(probes)
                scanned = probes.numel() * bn
            if sc is None:
                kern = lambda: fn(idx.corpus, idx.ids, q, *args)  # noqa: E731
                row_bytes = 2 * d + 4
            else:
                kern = lambda: fn(idx.corpus, sc, idx.ids, q, *args)  # noqa: E731
                row_bytes = d + 8
            lib = lambda: library_ivf(idx.corpus, sc, idx.ids, q,  # noqa: E731
                                      lib_table, k, bn)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = check_against_plain(f"{name} {case}", got, want, ids, [])
            ties = sum(got[1][j, :3].tolist() == g for j, g in enumerate(groups)
                       if j < nq)
            nbytes = (blocks.numel() * bn * row_bytes + 2 * nq * d
                      + 4 * lib_table.numel() + 8 * nq * k)
            entry = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
                     "library_ms": cuda_ms(lib, 3), "max_abs_err": err,
                     **bound(nbytes, 2.0 * scanned * d)}
            log(f"kernel-{name}-{case}", time.time() - t0, card_line, Q=nq,
                k=k, nprobe=I.NPROBE, blocks=blocks.numel(), tie_groups=ties,
                **fmt(entry))
            report[(name, case)] = dict(entry, shape={
                "Q": nq, "k": k, "nprobe": I.NPROBE, "block_n": bn, "D": d,
                "blocks_read": blocks.numel(), "N": I.N_ROWS})
    # the manual-DMA alias of the probed kernel, once at Q 1: bit for bit
    # the probed kernel, then held and timed against its own twin
    t0 = time.time()
    q = queries[:1].contiguous()
    probes = b.probe(q.float(), I.NPROBE)
    blocks = torch.unique(probes)
    kern = lambda: V.ivf_probed_scan_dma(b.corpus, b.ids, q, probes,  # noqa: E731
                                         TOP_K, bn)
    plain = lambda: V.ivf_probed_plain(b.corpus, b.ids, q, probes,  # noqa: E731
                                       TOP_K, bn)
    lib = lambda: library_ivf(b.corpus, None, b.ids, q, probes,  # noqa: E731
                              TOP_K, bn)
    got, want = kern(), V.ivf_probed_scan(b.corpus, b.ids, q, probes, TOP_K,
                                          bn)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("ivf_probed_scan_dma differs from ivf_probed_scan")
    err = check_against_plain("ivf_probed_scan_dma q1", got, plain(), ids, [])
    nbytes = (blocks.numel() * bn * (2 * d + 4) + 2 * d + 4 * probes.numel()
              + 8 * TOP_K)
    entry = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
             "library_ms": cuda_ms(lib, 3), "max_abs_err": err,
             **bound(nbytes, 2.0 * probes.numel() * bn * d)}
    log("kernel-ivf_probed_scan_dma-q1", time.time() - t0, card_line,
        **fmt(entry))
    report[("ivf_probed_scan_dma", "q1")] = dict(
        entry, shape=report[("ivf_probed_scan", "q1")]["shape"])
    del index, b, b8
    torch.cuda.empty_cache()
    for key, t in timings_child(card_line, "ivf_union_timings").items():
        report[tuple(key.split("/"))].update(
            {x: t[x] for x in ("scan_ms", "select_ms")})
    return {"kernels": report, "launches": launches, "recall_at_10": recall,
            "build_s": build_s}


def ivf_union_timings() -> dict:
    """Device ms of each union case's two launches apart, the scan and the
    selection (``scan_select_ms``), over phase 6's indexes built again, for
    ``timings_child``: → {"name/case": {"ms", "scan_ms", "select_ms"}}."""
    from cmw_rag_tpu_torch.index.ivf import IVFIndex, union_blocks
    from cmw_rag_tpu_torch.ops import ivf_scan as V
    from cmw_rag_tpu_torch.scripts import ivf as I

    rows, ids, queries, _ = I.clustered_corpus()
    calls = {}
    for quantize in (False, True):
        idx = IVFIndex.build(rows, ids, block_n=I.BLOCK_N, quantize=quantize)
        name = "ivf_union_scan" + ("_int8" if quantize else "")
        extra = () if idx.scales is None else (idx.scales,)
        for case, kind, nq, k in IVF_CASES:
            if kind == "union":
                q = queries[:nq].contiguous()
                table, nu = union_blocks(idx.probe(q.float(), I.NPROBE))
                calls[f"{name}/{case}"] = functools.partial(
                    getattr(V, name), idx.corpus, *extra, idx.ids, q, table,
                    k, I.BLOCK_N, nu)
    times = scan_select_ms(calls)
    return {key: {"ms": t["scan_ms"] + t["select_ms"], **t}
            for key, t in times.items()}


def segmented_phase(card_line: str) -> dict:
    """The Retriever over a segmented store of 250,000 rows: planted texts,
    batch search, deletes across segments and tail, save/load."""
    import tempfile

    import numpy as np
    import torch
    from cmw_rag_tpu_torch.index.shards import SegmentedIndex
    from cmw_rag_tpu_torch.scripts import ivf as I

    t0 = time.time()
    path = I.SegmentedPath(ROOT)
    torch.cuda.synchronize()
    log("segmented-setup", time.time() - t0, card_line,
        embedder="frida-hybrid", rerankers=len(path.reranker.members),
        markdown_chunks=len(path.md_texts))

    reset_counts()
    t0 = time.time()
    store, flat = path.build()
    seg = store.index
    torch.cuda.synchronize()
    tail = I.SEG_ROWS - len(seg.sealed) * seg.seal_threshold
    if len(seg.sealed) != 2 or seg.fresh.n_live != tail:
        raise AssertionError(f"segmented: {len(seg.sealed)} segments, tail "
                             f"{seg.fresh.n_live} rows")
    log("segmented-ingest", time.time() - t0, card_line, rows=I.SEG_ROWS,
        segments=len(seg.sealed), tail_rows=tail,
        seal_threshold=seg.seal_threshold)

    t0 = time.time()
    ret = path.retriever(store)
    kb = [str(I.PLANTED_KB + j) for j in range(len(path.planted))]
    ranks = []
    for j, text in enumerate(path.planted):
        got = [a.kb_id for a in ret.retrieve(text, top_k=10)]
        if kb[j] not in got:
            raise AssertionError(f"segmented: planted text {j} missing from "
                                 f"its top 10 {got}")
        ranks.append(got.index(kb[j]))
    qv = np.asarray(path.embedder.embed_queries(path.planted), np.float32)
    hits = store.search(qv, TOP_K)
    for j, row in enumerate(hits):
        if path.planted_sid(j) not in [h.id for h in row]:
            raise AssertionError(f"segmented: batch search lost planted {j}")
    _, i_seg = seg.search(qv, TOP_K)
    _, i_flat = flat.search(qv, TOP_K)
    overlap = float(np.mean([len(set(a) & set(b)) / TOP_K
                             for a, b in zip(i_seg, i_flat)]))

    gone = [0, 4, 7]                      # segment 0, segment 1, the tail
    for j in gone:
        store.delete_where({"kbId": kb[j]})
    for j in gone:
        got = [a.kb_id for a in ret.retrieve(path.planted[j], top_k=10)]
        if kb[j] in got:
            raise AssertionError(f"segmented: deleted planted {j} came back")
    dead = {path.planted_sid(j) for j in gone}
    for row in store.search(qv, TOP_K):
        if dead & {h.id for h in row}:
            raise AssertionError("segmented: a deleted chunk came back")
    log("segmented-queries", time.time() - t0, card_line,
        planted_ranks=json.dumps(ranks), top20_overlap_with_flat=overlap,
        deleted=json.dumps(gone))

    t0 = time.time()
    hv, hi = seg.to_host()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        seg.save(tmp)
        loaded = SegmentedIndex.load(tmp)
    lv, li = loaded.to_host()
    keep_h, keep_l = hi >= 0, li >= 0
    oh, ol = np.argsort(hi[keep_h]), np.argsort(li[keep_l])
    if not np.array_equal(hi[keep_h][oh], li[keep_l][ol]):
        raise AssertionError("segmented: the loaded ids differ")
    hv, lv = hv[keep_h], lv[keep_l]
    worst = 0.0
    for a in range(0, len(oh), 16384):    # one bf16 step: 2^-7 relative
        x = torch.from_numpy(hv[oh[a : a + 16384]]).cuda()
        y = torch.from_numpy(lv[ol[a : a + 16384]]).cuda()
        worst = max(worst, ((y - x).abs() - x.abs() / 128).max().item())
    del hv, lv
    if worst > 1e-7:
        raise AssertionError(f"segmented: loaded rows off by {worst}")
    _, i_load = loaded.search(qv, 10)
    ints = [store._int_by_sid.get(path.planted_sid(j)) for j in range(8)]
    for j, row in enumerate(i_load):
        if j not in gone and ints[j] not in row:
            raise AssertionError(f"segmented: loaded index lost planted {j}")
    launches = read_counts()
    for name in ("ivf_probed_scan", "ivf_union_scan", "topk_scan_bf16"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was launched no time on the "
                                 f"segmented path")
    log("segmented-save-load", time.time() - t0, card_line,
        live_rows=int(keep_h.sum()), launches=json.dumps(launches))
    result = {"launches": launches, "planted_ranks": ranks,
              "top20_overlap_with_flat": overlap,
              "live_rows": int(keep_h.sum())}
    del store, flat, seg, loaded, path
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------- local LLM


def paged_inputs(s: int, maxp: int, lens: list, layers: int, seed: int):
    """qwen3guard-0.6b's attention shapes (Hq 16, Hkv 8, Dh 128, page 64):
    pools of ``layers`` layers, distinct random pages per slot, the active
    slots' ``lens`` and, as the last slot, one idle slot on the null page
    (table all 0, length 1)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    hq, hkv, dh, page = 16, 8, 128, 64
    n_pages = 1 + s * maxp
    shape = (layers, n_pages, page, hkv, dh)
    kp = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    q = torch.randn((s, hq, dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(s, maxp).to(torch.int32)
    tables[-1] = 0
    lens_t = torch.tensor(list(lens) + [1], dtype=torch.int32, device="cuda")
    k_new = torch.randn((s, hkv, dh), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    v_new = torch.randn((s, hkv, dh), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    pos = (lens_t - 1).long()
    page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
    return {"q": q, "kp": kp, "vp": vp, "tables": tables, "lens": lens_t,
            "k_new": k_new, "v_new": v_new,
            "page_idx": page_idx.to(torch.int32),
            "off": (pos % page).to(torch.int32)}


def library_paged(q, kl, vl, tables, lens, ks=None, vs=None):
    """Yardstick only, a composite: the context gathered by index (and
    dequantized for int8 pages), then ``scaled_dot_product_attention`` with
    the length mask."""
    import torch
    import torch.nn.functional as Fn

    s, hq, dh = q.shape
    _, page, hkv, _ = kl.shape
    m = tables.shape[1] * page
    t = tables.long()
    k, v = kl[t], vl[t]
    if ks is not None:
        k = (k.float() * ks[t][:, :, None, :, None]).to(q.dtype)
        v = (v.float() * vs[t][:, :, None, :, None]).to(q.dtype)
    k = k.reshape(s, m, hkv, dh).transpose(1, 2)
    v = v.reshape(s, m, hkv, dh).transpose(1, 2)
    keep = (torch.arange(m, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return Fn.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                           attn_mask=keep, enable_gqa=True)[:, :, 0]


def cycling(call, layers: int):
    """``call(layer)`` over the layers in turn, as the engine's 28 calls a
    step read 28 different pools (so repeats do not find them in L2)."""
    import itertools

    it = itertools.count()
    return lambda: call(next(it) % layers)


#: phase 8's shapes: (case, slots, pages a slot, active lengths); an idle
#: slot on the null page follows the active ones
PAGED_CASES = (("serving", 4, 32, [1, 63, 2047]),
               ("bench", 8, 16, [64, 65, 257, 263, 270, 280, 288]),
               ("s32", 32, 16, [1 + 33 * i for i in range(31)]))
#: the splits (positions) phase 8 also times each paged kernel at
PAGED_SPLITS = (64, 128, 256, 512)


def paged_calls(name: str, x: dict, q8: dict):
    """The paged kernel ``name`` over the inputs ``x`` (``paged_inputs``;
    ``q8``: their int8 pools and scales): → (kern, plain, lib, tol), each
    ``f(layer)`` → [S, Hq, Dh]; ``kern(layer, split)`` launches the kernel
    at another split than the host's (not through the wrapper, whose
    ``launches`` it leaves alone); the scatter's kern writes this step's
    rows into the pools, its plain and lib write them first."""
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    q, kp, vp, tables, lens_t = (x[k] for k in ("q", "kp", "vp", "tables",
                                                "lens"))
    if name.endswith("int8"):
        kq, ks, vq, vs = (q8[k] for k in ("kq", "ks", "vq", "vs"))

        def kern(li, split=None):
            if split:
                return PA._launch(q, kq, vq, li, tables, lens_t, k_scales=ks,
                                  v_scales=vs, split=split)
            return PA.paged_decode_attention_dma_kv_int8(
                q, kq, ks, vq, vs, tables, lens_t, layer=li)

        def plain(li):
            return PA.paged_decode_attention_xla_kv_int8(
                q, kq[li], ks[li], vq[li], vs[li], tables, lens_t)

        def lib(li):
            return library_paged(q, kq[li], vq[li], tables, lens_t, ks[li],
                                 vs[li])
        return kern, plain, lib, PAGED_INT8_TOL
    if name.endswith("scatter"):
        pi, off, kn, vn = (x[k] for k in ("page_idx", "off", "k_new",
                                          "v_new"))

        def kern(li, split=None):
            if split:
                return PA._launch(q, kp, vp, li, tables, lens_t, k_new=kn,
                                  v_new=vn, page_idx=pi, off=off, split=split)
            return PA.paged_decode_attention_dma_scatter(
                q, kn, vn, pi, off, kp, vp, tables, lens_t, layer=li)[0]

        def written(li):
            kp[li, pi.long(), off.long()] = kn
            vp[li, pi.long(), off.long()] = vn
            return kp[li], vp[li]

        def plain(li):
            return PA.paged_decode_attention_xla(q, *written(li), tables,
                                                 lens_t)

        def lib(li):
            return library_paged(q, *written(li), tables, lens_t)
        return kern, plain, lib, PAGED_TOL

    def kern(li, split=None):
        if split:
            return PA._launch(q, kp, vp, li, tables, lens_t, split=split)
        return PA.paged_decode_attention_dma(q, kp, vp, tables, lens_t,
                                             layer=li)

    def plain(li):
        return PA.paged_decode_attention_xla(q, kp[li], vp[li], tables,
                                             lens_t)

    def lib(li):
        return library_paged(q, kp[li], vp[li], tables, lens_t)
    return kern, plain, lib, PAGED_TOL


def paged_held(name: str, label: str, x: dict, q8: dict, layer: int) -> dict:
    """One call of the paged kernel ``name`` at ``layer`` against its twin:
    the active slots within one bf16 step plus the kernel's tolerance, the
    scatter's pools bit for bit the twin's (this step's row NaN in the pool
    before the call: the kernel takes it from k_new/v_new), and a second
    launch bit for bit the first."""
    import torch
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    kern, plain, _, tol = paged_calls(name, x, q8)
    s = x["q"].shape[0]
    if name.endswith("scatter"):
        kp, vp, pi, off = (x[k] for k in ("kp", "vp", "page_idx", "off"))
        k_want, v_want = kp[layer].clone(), vp[layer].clone()
        k_want[pi.long(), off.long()] = x["k_new"]
        v_want[pi.long(), off.long()] = x["v_new"]
        want = PA.paged_decode_attention_xla(x["q"], k_want, v_want,
                                             x["tables"], x["lens"])
        kp[layer, pi.long(), off.long()] = float("nan")
        vp[layer, pi.long(), off.long()] = float("nan")
        got = kern(layer)
        torch.cuda.synchronize()
        if not (torch.equal(kp[layer], k_want)
                and torch.equal(vp[layer], v_want)):
            raise AssertionError(f"{name} {label}: the pools differ from "
                                 f"the twin's")
    else:
        want, got = plain(layer), kern(layer)
    again = kern(layer)
    torch.cuda.synchronize()
    act = slice(0, s - 1)
    err = (got[act].float() - want[act].float()).abs()
    step = bf16_step(want[act])
    excess = (err - step).max().item()
    if not bool((err <= step + tol).all()):
        raise AssertionError(f"{name} {label}: differs from the twin by "
                             f"{err.max().item()}, {excess} past one bf16 "
                             f"step (tolerance {tol})")
    if not torch.equal(got, again):
        raise AssertionError(f"{name} {label}: two launches differ")
    return {"max_abs_err": err.max().item(), "max_err_past_one_step": excess,
            "tolerance": tol, "bit_equal_launches": True}


def paged_edge_lens(positions: int, split: int) -> list:
    """Lengths on both sides of the page (64), split and table boundaries."""
    return sorted({1, 63, 64, 65, split - 1, split, split + 1, positions - 1,
                   positions} - {0})


def paged_kernel_phase(card_line: str) -> dict:
    """Hold the three paged attention kernels against their plain twins at
    the serving shape (4 slots x 2048), the decode bench shape (8 slots, a
    256-token prompt in a 1024-token context) and 32 slots x 1024, with an
    idle slot on the null page; time each (at the host's split and at each
    of ``PAGED_SPLITS``), its twin and the composite yardstick; count the
    kernels a call runs; then hold each at lengths on both sides of the
    page, split and table boundaries at the same shapes."""
    import torch
    from cmw_rag_tpu_torch.device import sm_count
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    layers = 28
    report = {}
    for case, s, maxp, lens in PAGED_CASES:
        x = paged_inputs(s, maxp, lens, layers, seed=s)
        q, kp, tables, lens_t = x["q"], x["kp"], x["tables"], x["lens"]
        kq, ks = PA.quantize_kv_page(kp)
        vq, vs = PA.quantize_kv_page(x["vp"])
        q8 = {"kq": kq, "ks": ks, "vq": vq, "vs": vs}
        hq, dh, hkv = q.shape[1], q.shape[2], kp.shape[3]
        pos = int(lens_t.sum().item())
        positions = maxp * 64
        for name in PAGED_KERNELS:
            t0 = time.time()
            int8 = name.endswith("int8")
            kern, plain, lib, _ = paged_calls(name, x, q8)
            held_ = paged_held(name, case, x, q8, layer=5)
            split = PA.paged_split(s, hkv, maxp, 64, sm_count(q.device),
                                   PA._resident(int8, dh, hq // hkv,
                                                q.device))
            elem = 1 if int8 else 2
            nbytes = (2 * pos * hkv * dh * elem + 2 * 2 * q.numel()
                      + tables.numel() * 4 + 4 * s)
            if int8:
                pages_used = sum(-(-n // 64) for n in lens) + 1
                nbytes += 2 * 4 * pages_used * hkv
            if name.endswith("scatter"):
                nbytes += 2 * 2 * x["k_new"].numel() * 2
            # one kernel a call: a complete window of 56 calls holds 56
            # paged kernels and nothing else
            ms, seen, dropped = device_profile(cycling(kern, layers), 56,
                                               "paged_decode_kernel")
            others = sorted({n for n in seen
                             if "paged_decode_kernel" not in n})
            per_call = (len(seen) - len(others)) / 56
            if per_call != 1 or others:
                raise AssertionError(f"{name} {case}: {per_call} paged "
                                     f"kernels a call, others {others}")
            entry = {"ms": ms, "kernels_per_call": per_call,
                     "dropped_windows": dropped,
                     "plain_ms": device_ms(cycling(plain, layers), 5),
                     "library_ms": device_ms(cycling(lib, layers), 5),
                     "call_ms": cuda_ms(cycling(kern, layers), 56),
                     "split": split, "n_split": -(-positions // split),
                     "ms_by_split": {
                         str(sp): device_ms(cycling(
                             lambda li, sp=sp: kern(li, sp), layers), 56,
                             "paged_decode_kernel")
                         for sp in PAGED_SPLITS if sp <= positions},
                     **held_, **bound(nbytes, 4.0 * hq * dh * pos)}
            entry["bound_share"] = entry["bound_ms"] / ms
            log(f"kernel-{name}-{case}", time.time() - t0, card_line, S=s,
                maxp=maxp, page=64, positions=pos,
                **fmt({k: v for k, v in entry.items()
                       if k != "ms_by_split"}),
                ms_by_split=json.dumps(entry["ms_by_split"]))
            report[(name, case)] = dict(entry, shape={
                "S": s, "Hq": hq, "Hkv": hkv, "Dh": dh, "page": 64,
                "maxp": maxp, "lens": lens + [1], "layers": layers})
        del x, q, kp, kq, vq, ks, vs, q8
        torch.cuda.empty_cache()
        # the same shape at the boundary lengths, S - 1 active slots a call
        for name in PAGED_KERNELS:
            t0 = time.time()
            edges = paged_edge_lens(positions, report[(name, case)]["split"])
            worst = {"max_abs_err": 0.0, "max_err_past_one_step": -1.0}
            for i in range(0, len(edges), s - 1):
                group = edges[i:i + s - 1]
                x = paged_inputs(s, maxp, group + [1] * (s - 1 - len(group)),
                                 1, seed=1000 + i)
                kq, ks = PA.quantize_kv_page(x["kp"])
                vq, vs = PA.quantize_kv_page(x["vp"])
                got = paged_held(name, f"{case} lengths {group}", x,
                                 {"kq": kq, "ks": ks, "vq": vq, "vs": vs},
                                 layer=0)
                worst = {k: max(worst[k], got[k]) for k in worst}
            report[(name, case)]["edges"] = {"lens": edges, **worst}
            log(f"kernel-{name}-{case}-edges", time.time() - t0, card_line,
                lens=json.dumps(edges), **fmt(worst))
            del x
        torch.cuda.empty_cache()
    return report


def recording_engine():
    """A ``PagedLLMEngine`` that keeps, per request, the logits of every
    step it samples."""
    from cmw_rag_tpu_torch.models.engine import PagedLLMEngine

    class Recording(PagedLLMEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.trace: dict = {}

        def _sample_row(self, logits_row, req):
            self.trace.setdefault(req.rid, []).append(logits_row.copy())
            return super()._sample_row(logits_row, req)

    return Recording


def compare_runs(ref, test, label: str, drift: float = LLM_DRIFT,
                 gap: float = LLM_GAP) -> dict:
    """Request by request, walk the steps while both runs have fed the
    model the same ids: the logits must agree within ``drift``
    (``LLM_DRIFT`` by default) at every such step, and the greedy ids must
    be equal unless the reference's top-2 gap there is under ``gap``
    (``LLM_GAP`` by default); the walk stops at such a near tie. → steps
    compared, the largest drift at each step index over the requests, and
    the near-tie swaps."""
    import numpy as np

    by_step: dict = {}
    compared, ties = 0, []
    for rid in sorted(ref.trace):
        a, b = ref.trace[rid], test.trace[rid]
        for i in range(min(len(a), len(b))):
            d = float(np.abs(a[i] - b[i]).max())
            by_step[i] = max(by_step.get(i, 0.0), d)
            if not d <= drift:
                raise AssertionError(f"{label}: request {rid} step {i}: "
                                     f"logits drift {d} > {drift}")
            compared += 1
            if int(a[i].argmax()) != int(b[i].argmax()):
                top2 = np.partition(a[i], -2)[-2:]
                top_gap = float(top2[1] - top2[0])
                if not top_gap < gap:
                    raise AssertionError(f"{label}: request {rid} step {i}: "
                                         f"ids differ at a top-2 gap of "
                                         f"{top_gap}")
                ties.append((rid, i, top_gap))
                break
        else:
            if len(a) != len(b):
                raise AssertionError(f"{label}: request {rid} ran {len(b)} "
                                     f"steps, the reference {len(a)}")
    walk = [round(by_step[i], 6) for i in sorted(by_step)]
    return {"steps_compared": compared, "max_logit_drift": max(walk),
            "drift_by_step": walk, "near_tie_swaps": ties, "gate": drift,
            "gap": gap}


def engine_phase(card_line: str) -> dict:
    """The full-width engine: native KV through the scatter kernel, then
    through the plain kernel, int8 KV, and chunked prefill, each against
    its reference run (the gather golden on the card; the bucketed
    prefill)."""
    import torch
    from cmw_rag_tpu_torch.ops import paged_attention as PA
    from cmw_rag_tpu_torch.scripts import local_llm as LL

    t0 = time.time()
    cfg = LL.config()
    params = LL.build_params(cfg, seed=0, device="cuda")
    prompts = LL.chat_prompts()
    torch.cuda.synchronize()
    log("llm-setup", time.time() - t0, card_line, spec=LL.SPEC,
        layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        requests=len(prompts))
    Rec = recording_engine()
    runs = [("golden", "native", dict(use_kernel=False), None),
            ("scatter", "native", dict(), "paged_decode_attention_dma_scatter"),
            ("dma", "native", dict(scatter_fused=False),
             "paged_decode_attention_dma"),
            ("golden-int8", "int8", dict(use_kernel=False, kv_dtype="int8"),
             None),
            ("int8", "int8", dict(kv_dtype="int8"),
             "paged_decode_attention_dma_kv_int8"),
            ("chunked", "chunked", dict(prefill_chunk=256),
             "paged_decode_attention_dma_scatter")]
    engines, result = {}, {"runs": {}}
    for label, _, kw, kernel in runs:
        t0 = time.time()
        eng = LL.build_engine(params, cfg, engine_cls=Rec, **kw)
        n0 = read_counts()
        reqs = LL.run_requests(eng, prompts)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n1 = read_counts()
        bad = [(r.rid, r.finish_reason) for r in reqs
               if not r.done or r.finish_reason not in ("length", "stop")]
        if bad:
            raise AssertionError(f"llm {label}: unfinished requests {bad}")
        launches = {k: n1[k] - n0[k] for k in PAGED_KERNELS}
        want = {k: (cfg.num_layers * eng.decode_steps if k == kernel else 0)
                for k in PAGED_KERNELS}
        if launches != want:
            raise AssertionError(f"llm {label}: launches {launches}, want "
                                 f"{want} ({eng.decode_steps} decode steps)")
        tokens = sum(len(r.out) for r in reqs)
        run = {"decode_steps": eng.decode_steps, "tokens": tokens,
               "wall_s": wall, "ms_per_step": 1e3 * wall / eng.decode_steps,
               "tokens_per_s": tokens / wall,
               "finish": sorted({r.finish_reason for r in reqs}),
               "kernel_launches": sum(launches.values())}
        engines[label] = eng
        ref = {"scatter": "golden", "dma": "golden", "int8": "golden-int8",
               "chunked": "scatter"}.get(label)
        if ref is not None:
            run.update(compare_runs(engines[ref], eng, f"llm {label}"))
        log(f"llm-{label}", wall, card_line, **fmt(
            {k: v for k, v in run.items() if k != "drift_by_step"}),
            drift_by_step=json.dumps(run.get("drift_by_step", [])))
        result["runs"][label] = run
    # where a decode step spends its time: 4 active slots, short contexts
    t0 = time.time()
    eng = LL.build_engine(params, cfg)
    for p in prompts[:4]:
        eng.submit(p, max_new_tokens=64)
    for _ in range(16):
        eng.step()
    profile = LL.profile_decode(eng)
    log("llm-decode-profile", time.time() - t0, card_line,
        **fmt({k: v for k, v in profile.items()
               if not isinstance(v, (list, dict))}))
    result["decode_profile"] = profile
    del engines, eng, params
    torch.cuda.empty_cache()
    return result


def transport_phase(card_line: str, weights: str = "native") -> dict:
    """EngineLoop + the engine transport at full width with the tokenizer's
    vocabulary (``weights`` native or int8): two chats sent together, one
    for a JSON body and one for an SSE stream."""
    import threading

    import torch
    from cmw_rag_tpu_torch.llm.local_transport import (
        create_local_llm_transport, format_chatml)
    from cmw_rag_tpu_torch.scripts import local_llm as LL
    from cmw_rag_tpu_torch.tokenizer import get_tokenizer

    t0 = time.time()
    tok = get_tokenizer()
    llm = create_local_llm_transport(
        spec=LL.spec_with_tokenizer_vocab(), tokenizer=tok,
        continuous_batching=True, page_size=LL.PAGE, weights=weights,
        device="cuda")
    chats = {False: [{"role": "user", "content": LL.PLANTED_TEXTS[1]}],
             True: [{"role": "system", "content": "Answer briefly."},
                    {"role": "user", "content": LL.PLANTED_TEXTS[2]}]}
    max_tokens, replies = 24, {}

    def ask(stream: bool):
        body = json.dumps({"messages": chats[stream], "max_tokens": max_tokens,
                           "stream": stream}).encode()
        resp = llm.transport("local", body, {}, 60.0, stream)
        replies[stream] = ((resp._req, list(resp)) if stream
                           else json.loads(resp.read()))

    try:
        threads = [threading.Thread(target=ask, args=(st,))
                   for st in (False, True)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        llm.engine_loop.stop()
    if llm.engine_loop.fatal is not None or len(replies) != 2:
        raise AssertionError(f"transport: loop failed {llm.engine_loop.fatal}")
    n_prompt = {st: len(tok.encode(format_chatml(m), allowed_special="all"))
                for st, m in chats.items()}

    def usage_ok(u, stream):
        return (u["prompt_tokens"] == n_prompt[stream]
                and 0 < u["completion_tokens"] <= max_tokens
                and u["total_tokens"] == u["prompt_tokens"]
                + u["completion_tokens"])

    body = replies[False]
    choice = body["choices"][0]
    if (set(body) != {"id", "model", "choices", "usage"}
            or body["model"] != "local-tpu"
            or choice["message"]["role"] != "assistant"
            or not isinstance(choice["message"]["content"], str)
            or choice["finish_reason"] not in ("stop", "length")
            or not usage_ok(body["usage"], False)):
        raise AssertionError(f"transport: bad JSON body {body}")
    req, chunks = replies[True]
    lines = [c.decode() for c in chunks]
    if lines[-1] != "data: [DONE]\n\n" or not all(
            c.startswith("data: ") and c.endswith("\n\n") for c in lines):
        raise AssertionError(f"transport: bad SSE stream {lines[-3:]}")
    events = [json.loads(c[6:]) for c in lines[:-1]]
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events[:-1])
    last = events[-1]
    if (not usage_ok(last["usage"], True)
            or last["usage"]["completion_tokens"] != len(req.out)
            or last["choices"][0]["finish_reason"] not in ("stop", "length")
            or text != tok.decode(req.out)):
        raise AssertionError(f"transport: bad SSE stream {events[-2:]}")
    result = {"vocab": llm.cfg.vocab_size, "sse_events": len(events),
              "json_usage": body["usage"], "sse_usage": last["usage"],
              "finish_reasons": [choice["finish_reason"],
                                 last["choices"][0]["finish_reason"]]}
    log(f"llm-transport-{weights}", time.time() - t0, card_line,
        vocab=result["vocab"],
        sse_events=len(events), json_usage=json.dumps(body["usage"]),
        sse_usage=json.dumps(last["usage"]))
    del llm
    torch.cuda.empty_cache()
    return result


def local_llm_phase(card_line: str) -> dict:
    """Phase 8: the kernels against their twins, then the main path (the
    engine runs and the transport) with every count set to 0 before it."""
    kernels = paged_kernel_phase(card_line)
    reset_counts()
    engine = engine_phase(card_line)
    transport = transport_phase(card_line)
    launches = read_counts()
    for name in PAGED_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was launched no time on the LLM path")
    return {"kernels": kernels, "engine": engine, "transport": transport,
            "launches": launches}


# ---------------------------------------------------- int8-weight LLM path


def int8_layers(n: int, gen, d=1024, hq=16, hkv=8, dh=128, f=3072) -> list:
    """``n`` decoder layers at qwen3guard-0.6b's width, int8 weights
    quantized from seeded normal weights (std 0.05) on the card, norm scales
    near 1."""
    import torch
    from cmw_rag_tpu_torch.ops.int8_matmul import quantize_weight

    def q8(k, m):
        return quantize_weight(torch.randn((k, m), generator=gen,
                                           device="cuda") * 0.05)

    def norm(m):
        return 1.0 + 0.1 * torch.randn((m,), generator=gen, device="cuda")

    layers = []
    for _ in range(n):
        lay = {"attn_norm": norm(d), "ffn_norm": norm(d), "q_norm": norm(dh),
               "k_norm": norm(dh)}
        lay["wqkv_q"], lay["wqkv_s"] = q8(d, (hq + 2 * hkv) * dh)
        lay["wo_q"], lay["wo_s"] = q8(hq * dh, d)
        lay["w_gateup_q"], lay["w_gateup_s"] = q8(d, 2 * f)
        lay["w_down_q"], lay["w_down_s"] = q8(f, d)
        layers.append(lay)
    return layers


MLP_KEYS = ("wo_q", "wo_s", "ffn_norm", "w_gateup_q", "w_gateup_s",
            "w_down_q", "w_down_s")
LAYER_KEYS = ("attn_norm", "wqkv_q", "wqkv_s", "q_norm", "k_norm") + MLP_KEYS


def library_mm(x, w_q, scale):
    """Yardstick only, a composite: dequantize to bf16, ``torch.matmul``,
    scale."""
    import torch

    return (torch.matmul(x.to(torch.bfloat16), w_q.to(torch.bfloat16)).float()
            * scale).to(x.dtype)


def library_mlp(x, attn, lay, eps=1e-6):
    """Yardstick only, a composite of library calls for the fused MLP."""
    import torch
    import torch.nn.functional as Fn

    f = lay["w_down_q"].shape[0]
    x1 = x.float() + library_mm(attn, lay["wo_q"], lay["wo_s"]).float()
    y = x1 * torch.rsqrt(x1.square().mean(-1, keepdim=True) + eps) \
        * lay["ffn_norm"]
    gu = library_mm(y.to(torch.bfloat16), lay["w_gateup_q"],
                    lay["w_gateup_s"]).float()
    h = Fn.silu(gu[:, :f]) * gu[:, f:]
    return (x1 + library_mm(h.to(torch.bfloat16), lay["w_down_q"],
                            lay["w_down_s"]).float()).to(x.dtype)


def library_qkv(x, c2, s2, lay, hkv: int, eps=1e-6):
    """Yardstick only: the attention norm, dequantized ``torch.matmul`` QKV,
    head norms and RoPE in torch ops → q, k, v [S, H, Dh] float32."""
    import torch

    s, dh = x.shape[0], c2.shape[1]
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
         * lay["attn_norm"]).to(torch.bfloat16)
    qkv = library_mm(y, lay["wqkv_q"], lay["wqkv_s"]).float()
    hq = qkv.shape[1] // dh - 2 * hkv

    def nr(t, w):
        n = t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps) * w
        return n * c2[:, None] + torch.roll(n, dh // 2, -1) * s2[:, None]

    q = nr(qkv[:, :hq * dh].reshape(s, hq, dh), lay["q_norm"])
    k = nr(qkv[:, hq * dh:(hq + hkv) * dh].reshape(s, hkv, dh), lay["k_norm"])
    return q, k, qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)


def library_layer(x, c2, s2, lay, pi, off, kl, vl, tables, lens, eps=1e-6):
    """Yardstick only, a composite of library calls for the decoder layer:
    ``library_qkv``, the rows written by index,
    ``scaled_dot_product_attention`` over the gathered context, the MLP."""
    import torch

    q, k, v = library_qkv(x, c2, s2, lay, kl.shape[2], eps)
    kl[pi.long(), off.long()] = k.to(kl.dtype)
    vl[pi.long(), off.long()] = v.to(vl.dtype)
    attn = library_paged(q.to(torch.bfloat16), kl, vl, tables, lens)
    return library_mlp(x, attn.reshape(x.shape[0], -1), lay, eps)


def held(got, want, tol: float, label: str) -> dict:
    """``got`` within one bf16 step of ``want`` (where the output is bf16;
    the step at the larger of the two magnitudes, so that a rounding across
    a power of two counts one step) plus ``tol`` times the largest |want|;
    → the errors."""
    import torch

    err = (got.float() - want.float()).abs()
    big = want.float().abs().max().item()
    step = (bf16_step(torch.maximum(got.float().abs(), want.float().abs()))
            if want.dtype == torch.bfloat16 else torch.zeros_like(err))
    excess = (err - step).max().item()
    if not bool((err <= step + tol * big).all()):
        raise AssertionError(f"{label}: differs from the twin by "
                             f"{err.max().item()}, {excess} past one bf16 "
                             f"step (tolerance {tol} x {big})")
    return {"max_abs_err": err.max().item(), "max_err_past_one_step": excess,
            "tolerance": tol, "max_abs_want": big}


#: the split sizes (positions) of split decode attention that phase 9 times
ATTN_SPLITS = (64, 128)


def with_split(split: int, fn):
    """``fn`` run with split attention cut into ``split`` positions."""
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    def run(*a, **kw):
        old, PA.ATTN_SPLIT = PA.ATTN_SPLIT, split
        try:
            return fn(*a, **kw)
        finally:
            PA.ATTN_SPLIT = old
    return run


def split_times(kern, layers: int) -> dict:
    """Device ms of ``kern(layer)`` over the layers in turn at each split
    size of ``ATTN_SPLITS``."""
    return {str(sp): device_ms(cycling(with_split(sp, kern), layers), 56)
            for sp in ATTN_SPLITS}


def split_items(lens, positions: int, hkv: int, s: int) -> dict:
    """The split attention grid of one call at the split in force: the
    split, the splits a (slot, KV head), the work items and those under a
    slot's length (the rest return at once)."""
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    split = PA.ATTN_SPLIT
    n_split = PA.attention_splits(positions, split)
    live = sum(PA.attention_splits(min(n, positions), split) for n in lens)
    return {"split": split, "n_split": n_split, "items": s * hkv * n_split,
            "live_items": hkv * live}


def plan_info(plan, grid_waits: int) -> dict:
    """A weight-phase plan's numbers for a record: its grid, row tile,
    ring stages, the products' splits (QKV, wo, gate/up, down; the fused
    MLP's QKV slot is empty), the tiles merged from splits, the busiest
    block's 8 KB stages and the grid-wide waits a call."""
    from cmw_rag_tpu_torch.ops import weight_phases as WP

    return {"grid_blocks": plan.grid, "row_tile": plan.mt, "ring": plan.ring,
            "splits": [q.ks for q in plan.products],
            "merges": sum(plan.mtiles * q.ctiles for q in plan.products
                          if q.ks > 1),
            "block_stages": max(WP.layer_block_stages(plan)),
            "grid_waits": grid_waits}


def megakernel_plan(DL, s, d, hq, hkv, dh, f, device, kv8=False) -> dict:
    """The megakernel's host plan for a call (``layer_plan``)."""
    from cmw_rag_tpu_torch.ops import weight_phases as WP

    return plan_info(WP.layer_plan(s, d, hq, hkv, dh, f,
                                   DL._grid(device, WP.layer_tile(s), dh,
                                            kv8)), DL.GRID_WAITS)


def mlp_plan_info(s, d, a, f, device) -> dict:
    """The fused MLP's host plan for a call (``mlp_plan``)."""
    from cmw_rag_tpu_torch.ops import fused_mlp as FM
    from cmw_rag_tpu_torch.ops import weight_phases as WP

    return plan_info(WP.mlp_plan(s, d, a, f,
                                 FM._grid(device, WP.layer_tile(s))),
                     FM.GRID_WAITS)


#: the megakernels' cases: name, active lengths, idle slots (on the null
#: page), route; #24's (bf16 pages) and #25's (int8 pages, paged)
MEGA_CASES = {False: (("s4-slot", [63, 200, 384], 1, "slot"),
                      ("s4-paged", [1, 700, 2047], 1, "paged"),
                      ("s8-slot", [256] * 8, 0, "slot")),
              True: (("s4", [65, 200, 384], 1, "paged"),
                     ("s4-long", [1, 700, 2047], 1, "paged"))}
#: the megakernel's name in the profiler's records
MEGA_KERNEL = "decoder_layer_kernel"


def mega_inputs(gen, lens, idle, route, kv8, n_layers=28, d=1024, hkv=8,
                dh=128, page=64, maxp=32) -> dict:
    """One megakernel case of ``MEGA_CASES`` at qwen3guard-0.6b's widths:
    the active slots at ``lens``, ``idle`` more at length 1 writing row 0
    of the null page, on the slot-major or paged ``route``, over
    ``n_layers`` layers' bf16 pools or (``kv8``) int8 pools with their
    scale planes. → the inputs, by name (``pools``: (k, v) or (k, k
    scales, v, v scales); ``kw``: the route's keywords)."""
    import torch
    from cmw_rag_tpu_torch.ops import decoder_layer as DL
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    s = len(lens) + idle
    act = s - idle
    n_pages = 1 + s * maxp
    shape = (n_layers, n_pages, page, hkv, dh)
    if kv8:
        kq, ks = PA.quantize_kv_page(torch.randn(shape, generator=gen,
                                                 device="cuda"))
        vq, vs = PA.quantize_kv_page(torch.randn(shape, generator=gen,
                                                 device="cuda"))
        pools = (kq, ks, vq, vs)
    else:
        pools = tuple(torch.randn(shape, generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(2))
    lens_t = torch.tensor(lens + [1] * idle, dtype=torch.int32,
                          device="cuda")
    if route == "slot":
        tables = PA.slot_tables(s, maxp, maxp, 1, "cuda")
        kw = dict(attn_slot=True, slot_cap=-(-max(lens) // page),
                  slot_maxp=maxp)
    else:
        perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
        tables = perm[:s * maxp].reshape(s, maxp).to(torch.int32)
        tables[act:] = 0                                  # the idle slots
        kw = dict(tables=tables)
    pos = (lens_t - 1).long()
    page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
    page_idx[act:] = 0
    off = (pos % page).to(torch.int32)
    off[act:] = 0
    x = torch.randn((s, d), generator=gen, device="cuda").bfloat16()
    ang = torch.rand((s, dh // 2), generator=gen, device="cuda") * 6.28
    c2, s2 = DL.make_rope_maps(torch.cos(ang), torch.sin(ang))
    return {"s": s, "act": act, "kv8": kv8, "pools": pools, "lens_t": lens_t,
            "tables": tables, "kw": kw, "page_idx": page_idx.to(torch.int32),
            "off": off, "x": x, "c2": c2, "s2": s2}


def mega_call(c: dict, layer: dict, li: int, ablate: str = "",
              plain: bool = False):
    """The megakernel (``plain``: its twin) over layer ``li`` of case
    ``c`` (``mega_inputs``) with that layer's weights: → its output."""
    from cmw_rag_tpu_torch.ops import decoder_layer as DL

    head = (c["x"], c["c2"], c["s2"], *[layer[k] for k in LAYER_KEYS],
            c["page_idx"], c["off"])
    if c["kv8"]:
        kq, ks, vq, vs = c["pools"]
        fn = (DL.decoder_layer_int8_kv8_plain if plain
              else DL.decoder_layer_int8_kv8)
        return fn(*head, kq, ks[li], vq, vs[li], c["lens_t"], layer=li,
                  ablate=ablate, **c["kw"])[0]
    fn = DL.decoder_layer_int8_plain if plain else DL.decoder_layer_int8
    return fn(*head, *c["pools"], c["lens_t"], layer=li, ablate=ablate,
              **c["kw"])[0]


def window_ms(fn, iters: int, kernel: str, what: str) -> float:
    """Device ms of ``kernel``: the mean of its records in one complete
    profiler window of ``iters`` calls of ``fn``
    (``profile_query.kernel_window`` with its name: the profiler on the
    card drops some records even in a fresh process, PERF.md §7, and a
    window short of one is taken again, three times, then this raises)."""
    from cmw_rag_tpu_torch.scripts.profile_query import kernel_window

    events, _ = kernel_window(fn, iters, kernel)
    spans = [e.time_range.end - e.time_range.start for e in events
             if kernel in e.name]
    if len(spans) != iters:
        raise RuntimeError(f"{what}: {len(spans)} records in a window of "
                           f"{iters} calls")
    return sum(spans) / len(spans) / 1e3


#: the fused MLP's cases: name, rows (4 slots with int8 KV; 16, the int8
#: default past 8 slots; 32, two row tiles and a ring that runs ahead)
MLP_CASES = (("s4", 4), ("s16", 16), ("s32", 32))
#: the fused MLP's name in the profiler's records
MLP_KERNEL = "fused_mlp_kernel"


def mlp_inputs(gen, s: int, d: int = 1024, a: int = 2048):
    """The fused MLP's x [S, D] and attention output [S, A], bf16."""
    import torch

    x = torch.randn((s, d), generator=gen, device="cuda").bfloat16()
    attn = (0.1 * torch.randn((s, a), generator=gen, device="cuda")
            ).bfloat16()
    return x, attn


def mlp_timings() -> dict:
    """Device ms of the fused MLP at ``MLP_CASES`` over 28 layers' weights
    in turn, each the mean of its records in one complete profiler window
    of 56 calls (``window_ms``), with its plan (``mlp_plan_info``: splits,
    merges, the busiest block's stages, the ring, the grid-wide waits)."""
    import torch
    from cmw_rag_tpu_torch.ops import fused_mlp as FM

    n_layers, iters, d, a, f = 28, 56, 1024, 2048, 3072
    gen = torch.Generator(device="cuda").manual_seed(19)
    layers = int8_layers(n_layers, gen)
    out = {}
    for case, s in MLP_CASES:
        x, attn = mlp_inputs(gen, s, d, a)

        def call(li, x=x, attn=attn):
            return FM.fused_mlp_int8(x, attn, *[layers[li][k]
                                                for k in MLP_KEYS])
        out[case] = {"ms": window_ms(cycling(call, n_layers), iters,
                                     MLP_KERNEL, f"fused MLP {case}"),
                     **mlp_plan_info(s, d, a, f, x.device)}
    return out


def timings_child(card_line: str, fn: str, *args) -> dict:
    """``fn(*args)`` of this file in a process of its own, started from this
    file's directory: late in one long process the profiler drops kernel
    records (PERF.md §7), and these windows must be complete."""
    import subprocess

    code = ("import json, sys\nsys.path.insert(0, '.')\n"
            "import chip_smoke as c\n"
            f"r = c.{fn}(*{args!r})\n"
            "print('CHILD_RECORDS ' + json.dumps(r), flush=True)\n")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("CHILD_RECORDS "):
            result = json.loads(line[len("CHILD_RECORDS "):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or result is None:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"{fn} failed ({proc.returncode})")
    log(fn, time.time() - t0, card_line, args=list(args),
        **{case: r["ms"] for case, r in result.items()})
    return result


def megakernel_timings(kv8: bool = False) -> dict:
    """Device ms of the decoder-layer megakernel (``kv8``: the int8-KV
    one) at ``MEGA_CASES`` over 28 layers' weights in turn: whole, with
    attention ablated ("noattn") and at splits of 64 and 128 positions.
    Each is the mean of the megakernel's records in one complete profiler
    window of 56 calls (``window_ms``)."""
    import torch
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    n_layers, iters = 28, 56
    gen = torch.Generator(device="cuda").manual_seed(18)
    layers = int8_layers(n_layers, gen)
    out = {}
    for case, lens, idle, route in MEGA_CASES[kv8]:
        c = mega_inputs(gen, lens, idle, route, kv8, n_layers)

        def call(li, ablate="", c=c):
            return mega_call(c, layers[li], li, ablate)

        def dev(fn, case=case):
            return window_ms(cycling(fn, n_layers), iters, MEGA_KERNEL,
                             f"megakernel {case}")

        rec = {"ms": dev(call),
               "noattn_ms": dev(lambda li: call(li, "noattn")),
               "ms_by_split": {}}
        old = PA.ATTN_SPLIT
        try:
            for split in (64, 128):
                PA.ATTN_SPLIT = split
                rec["ms_by_split"][str(split)] = dev(call)
        finally:
            PA.ATTN_SPLIT = old
        out[case] = rec
        del c
        torch.cuda.empty_cache()
    return out


def split_bounds_phase(layers, card_line: str) -> dict:
    """Split decode attention at lengths on either side of every split
    boundary (1, split - 1, split, split + 1, 2 split + 1, cap * page) and
    an idle slot, at both split sizes: the slot-major kernel and the
    megakernel on both routes against their twins (phase 9's tolerances),
    each launched twice and bit for bit alike."""
    import torch
    from cmw_rag_tpu_torch.ops import decoder_layer as DL
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    hq, hkv, dh, page, d = 16, 8, 128, 64, 1024
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for split in ATTN_SPLITS:
        t0 = time.time()
        cap = -(-(2 * split + 1) // page) + 1
        lens = [1, split - 1, split, split + 1, 2 * split + 1, cap * page]
        s, maxp = len(lens) + 1, cap
        lens_t = torch.tensor(lens + [1], dtype=torch.int32, device="cuda")
        shape = (2, 1 + s * maxp, page, hkv, dh)
        kp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        vp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        q = torch.randn((s, hq, dh), generator=gen, device="cuda").bfloat16()
        slot = with_split(split, PA.paged_decode_attention_dma_slot)
        got = slot(q, kp, vp, lens_t, layer=1, cap=cap, maxp_slot=maxp)
        again = slot(q, kp, vp, lens_t, layer=1, cap=cap, maxp_slot=maxp)
        want = PA.paged_decode_attention_slot_plain(q, kp[1], vp[1], lens_t,
                                                    cap, maxp)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"slot attention, split {split}: two "
                                 f"launches differ")
        out[f"slot-{split}"] = {**held(got, want, PAGED_TOL,
                                       f"slot attention split {split}"),
                                "bit_equal_launches": True, "lens": lens}
        x = torch.randn((s, d), generator=gen, device="cuda").bfloat16()
        ang = torch.rand((s, dh // 2), generator=gen, device="cuda") * 6.28
        c2, s2 = DL.make_rope_maps(torch.cos(ang), torch.sin(ang))
        pos = (lens_t - 1).long()
        for route in ("slot", "paged"):
            if route == "slot":
                tables = PA.slot_tables(s, maxp, maxp, 1, "cuda")
                kw = dict(attn_slot=True, slot_cap=cap, slot_maxp=maxp)
            else:
                perm = torch.randperm(s * maxp, generator=gen,
                                      device="cuda") + 1
                tables = perm.reshape(s, maxp).to(torch.int32)
                tables[-1] = 0
                kw = dict(tables=tables)
            page_idx = tables.long().gather(1, (pos // page)[:, None])[:, 0]
            page_idx[-1] = 0
            off = (pos % page).to(torch.int32)
            off[-1] = 0
            args = (x, c2, s2, *[layers[0][k] for k in LAYER_KEYS],
                    page_idx.to(torch.int32), off)
            k_tw, v_tw = kp.clone(), vp.clone()
            layer = with_split(split, DL.decoder_layer_int8)
            got = layer(*args, kp, vp, lens_t, layer=1, **kw)[0]
            again = layer(*args, kp, vp, lens_t, layer=1, **kw)[0]
            want = DL.decoder_layer_int8_plain(*args, k_tw, v_tw, lens_t,
                                               layer=1, **kw)[0]
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"decoder_layer_int8 {route}, split "
                                     f"{split}: two launches differ")
            out[f"layer-{route}-{split}"] = {
                **held(got[:s - 1], want[:s - 1], INT8_LAYER_TOL,
                       f"decoder_layer_int8 {route} split {split}"),
                "bit_equal_launches": True, "lens": lens}
        log(f"split-bounds-{split}", time.time() - t0, card_line, lens=lens,
            **{k: f"{v['max_abs_err']:.3g}" for k, v in out.items()
               if k.endswith(str(split))})
        del kp, vp
    torch.cuda.empty_cache()
    return out


#: phase 9's int8_matmul records: (case, rows, output columns, x's dtype)
#: at qwen3guard-0.6b's width (K 1024): the fused QKV on the unfused routes
#: and the LM head on every int8 step, at 4 and 16 slots
INT8_MM_CASES = (("qkv-s4", 4, 4096, "bfloat16"),
                 ("qkv-s16", 16, 4096, "bfloat16"),
                 ("head-s4", 4, 151680, "float32"),
                 ("head-s16", 16, 151680, "float32"))


def int8_matmul_records(card_line: str) -> dict:
    """``int8_matmul`` against its twin at ``INT8_MM_CASES`` (the QKV over
    28 layers' weights read in turn), within one bf16 step plus
    ``INT8_MM_TOL`` of the largest output, and bit for bit on a second
    call; each call one kernel launch (a complete profiler window of 56
    calls holds 56 ``int8_matmul_kernel`` kernels and nothing else), the
    whole call's device time read off that window, its twin, the library
    yardstick (``library_mm``), the bound and the host plan (splits, ring,
    grid). → {case: record}."""
    import torch
    from cmw_rag_tpu_torch.device import sm_count
    from cmw_rag_tpu_torch.ops import int8_matmul as IM
    from cmw_rag_tpu_torch.ops import weight_phases as WP

    n_layers, d = 28, 1024
    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.time()
    layers = int8_layers(n_layers, gen)
    head_q, head_s = IM.quantize_weight(
        torch.randn((d, 151680), generator=gen, device="cuda") * 0.02)
    log("int8-matmul-setup", time.time() - t0, card_line, layers=n_layers)
    report = {}
    for case, m, n, dtype in INT8_MM_CASES:
        t1 = time.time()
        xdt = getattr(torch, dtype)
        x = torch.randn((m, d), generator=gen, device="cuda").to(xdt)
        ws = ([(head_q, head_s)] if case.startswith("head") else
              [(lay["wqkv_q"], lay["wqkv_s"]) for lay in layers])
        got, want = IM.int8_matmul(x, *ws[0]), IM.int8_matmul_plain(x, *ws[0])
        again = IM.int8_matmul(x, *ws[0])
        torch.cuda.synchronize()
        entry = held(got, want, INT8_MM_TOL, f"int8_matmul {case}")
        if not torch.equal(got, again):
            raise AssertionError(f"int8_matmul {case}: two calls differ")
        kern = cycling(lambda i: IM.int8_matmul(x, *ws[i]), len(ws))
        ms, seen, dropped = device_profile(kern, 56, "int8_matmul_kernel")
        others = sorted({e for e in seen if "int8_matmul_kernel" not in e})
        if len(seen) != 56 or others:
            raise AssertionError(f"int8_matmul {case}: {len(seen) / 56} "
                                 f"kernels a call, others {others}")
        plan = WP.matmul_plan(m, d, n, IM._grid(x.device, WP.layer_tile(m),
                                                xdt == torch.float32),
                              sm_count(x.device))
        xb = x.element_size()
        entry.update({
            "bit_equal_launches": True, "kernels_per_call": len(seen) / 56,
            "dropped_windows": dropped, "ms": ms,
            "split": plan.products[1].ks, "ring": plan.ring,
            "grid_blocks": plan.grid,
            "plain_ms": device_ms(cycling(
                lambda i: IM.int8_matmul_plain(x, *ws[i]), len(ws)), 5),
            "library_ms": device_ms(cycling(
                lambda i: library_mm(x, *ws[i]), len(ws)), 5),
            "call_ms": cuda_ms(kern, 56),
            **bound(d * n + 4 * n + m * d * xb + m * n * xb,
                    2.0 * m * d * n)})
        entry["bound_share"] = entry["bound_ms"] / ms
        log(f"kernel-int8_matmul-{case}", time.time() - t1, card_line,
            **fmt(entry))
        report[case] = dict(entry, shape={"M": m, "K": d, "N": n,
                                          "x": str(xdt)})
    return report


def int8_kernel_phase(card_line: str) -> dict:
    """Hold the four int8-path kernels against their plain twins at the
    main path's shapes (qwen3guard-0.6b, 28 layers' weights read in turn so
    that repeats do not find them in L2); time each, its twin and a library
    composite; split attention at both split sizes, its boundary lengths
    and two launches alike (``split_bounds_phase``)."""
    import torch
    from cmw_rag_tpu_torch.ops import decoder_layer as DL
    from cmw_rag_tpu_torch.ops import fused_mlp as FM
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    n_layers, d, hq, hkv, dh, f, page, maxp = 28, 1024, 16, 8, 128, 3072, 64, 32
    a, a3 = hq * dh, (hq + 2 * hkv) * dh
    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.time()
    layers = int8_layers(n_layers, gen)
    log("int8-setup", time.time() - t0, card_line, layers=n_layers)
    w_bytes = d * a3 + a * d + d * 2 * f + f * d
    report = {}

    def record(name, case, kern, plain, lib, got, want, tol, nbytes, ops,
               shape, iters=56, extra=None):
        t1 = time.time()
        entry = {**held(got, want, tol, f"{name} {case}"),
                 "plain_ms": device_ms(plain, 5),
                 "library_ms": device_ms(lib, 5),
                 "call_ms": cuda_ms(kern, iters), **bound(nbytes, ops),
                 **(extra or {})}
        entry.setdefault("ms", device_ms(kern, iters))
        log(f"kernel-{name}-{case}", time.time() - t1, card_line,
            **fmt(entry))
        report[(name, case)] = dict(entry, shape=shape)

    # int8_matmul: the fused QKV and the head at 4 and 16 slots, in a
    # process of its own (``int8_matmul_records``)
    for case, entry in timings_child(card_line, "int8_matmul_records",
                                     card_line).items():
        report[("int8_matmul", case)] = entry

    # slot attention: 4 slots at caps 2 and 6, 16 slots at cap 6, one idle
    for case, s, lens in (("s4-cap2", 4, [1, 64, 128]),
                          ("s4-cap6", 4, [65, 200, 384]),
                          ("s16-cap6", 16, [1 + 25 * i for i in range(15)])):
        cap = -(-max(lens) // page)
        n_pages = 1 + s * maxp
        shape = (n_layers, n_pages, page, hkv, dh)
        kp = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        q = torch.randn((s, hq, dh), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        lens_t = torch.tensor(lens + [1], dtype=torch.int32, device="cuda")
        tables = PA.slot_tables(s, cap, maxp, 1, "cuda")

        def kern(li):
            return PA.paged_decode_attention_dma_slot(
                q, kp, vp, lens_t, layer=li, cap=cap, maxp_slot=maxp)

        def plain(li):
            return PA.paged_decode_attention_slot_plain(
                q, kp[li], vp[li], lens_t, cap, maxp)

        def lib(li):
            return library_paged(q, kp[li], vp[li], tables, lens_t)
        got, want, again = kern(3), plain(3), kern(3)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"slot attention {case}: two launches "
                                 f"differ")
        pos = sum(lens) + 1
        extra = {**split_items(lens + [1], cap * page, hkv, s),
                 "bit_equal_launches": True,
                 "ms_by_split": split_times(kern, n_layers)}
        record("paged_decode_attention_dma_slot", case,
               cycling(kern, n_layers), cycling(plain, n_layers),
               cycling(lib, n_layers), got[:s - 1], want[:s - 1], PAGED_TOL,
               2 * pos * hkv * dh * 2 + 2 * 2 * q.numel() + 4 * s,
               4.0 * hq * dh * pos,
               {"S": s, "Hq": hq, "Hkv": hkv, "Dh": dh, "page": page,
                "cap": cap, "maxp_slot": maxp, "lens": lens + [1]},
               extra=extra)
        del kp, vp
        torch.cuda.empty_cache()

    # the fused MLP at 4, 16 and 32 slots; its device times from complete
    # profiler windows in a process of its own (``mlp_timings``)
    mlp = timings_child(card_line, "mlp_timings")
    for case, s in MLP_CASES:
        x, attn = mlp_inputs(gen, s, d, a)

        def kern(li):
            return FM.fused_mlp_int8(x, attn, *[layers[li][k]
                                                for k in MLP_KEYS])

        def plain(li):
            return FM.fused_mlp_int8_plain(x, attn, *[layers[li][k]
                                                      for k in MLP_KEYS])

        def lib(li):
            return library_mlp(x, attn, layers[li])
        got, want = kern(0), plain(0)
        torch.cuda.synchronize()
        mlp_w = a * d + d * 2 * f + f * d
        record("fused_mlp_int8", case, cycling(kern, n_layers),
               cycling(plain, n_layers), cycling(lib, n_layers), got, want,
               INT8_LAYER_TOL, mlp_w + 4 * (3 * d + 2 * f) + 2 * s * (2 * d + a),
               2.0 * s * mlp_w, {"S": s, "D": d, "A": a, "F": f},
               extra=mlp[case])

    # the megakernel at 4 slots: slot-major (contexts within cap 6) and
    # paged (one context of 2047, past the slot-major budget), one idle
    # slot; at 8 slots x 256, slot-major, every slot active (the decode
    # cell's batch); its device times (also with attention ablated,
    # "noattn", and at each split) from a process of its own
    # (``timings_child``)
    mega = timings_child(card_line, "megakernel_timings", False)
    for case, lens, idle, route in MEGA_CASES[False]:
        c = mega_inputs(gen, lens, idle, route, False, n_layers, d, hkv, dh,
                        page, maxp)
        s, act, kw, slot = c["s"], c["act"], c["kw"], route == "slot"
        kp, vp = c["pools"]
        x, c2, s2, page_idx, off, lens_t, tables = (
            c[k] for k in ("x", "c2", "s2", "page_idx", "off", "lens_t",
                           "tables"))

        def kern(li, c=c):
            return mega_call(c, layers[li], li)

        def plain(li, c=c):
            return mega_call(c, layers[li], li, plain=True)

        def lib(li, kp=kp, vp=vp):
            return library_layer(x, c2, s2, layers[li], page_idx, off,
                                 kp[li], vp[li], tables if not slot else
                                 PA.slot_tables(s, kw["slot_cap"], maxp, 1,
                                                "cuda"), lens_t)
        li = 5
        k0, v0 = kp[li].clone(), vp[li].clone()
        got, again = kern(li), kern(li)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"decoder_layer_int8 {case}: two launches "
                                 f"differ")
        k_got, v_got = kp[li].clone(), vp[li].clone()
        kp[li].copy_(k0)
        vp[li].copy_(v0)
        want = plain(li)
        rows = (page_idx.long(), off.long())
        for label, g_pool, w_pool, before in (("k", k_got, kp[li], k0),
                                              ("v", v_got, vp[li], v0)):
            keep = torch.ones(g_pool.shape[:2], dtype=torch.bool,
                              device="cuda")
            keep[rows] = False
            if not (torch.equal(g_pool[keep], before[keep])
                    and torch.equal(w_pool[keep], before[keep])):
                raise AssertionError(f"decoder_layer_int8 {case}: {label} "
                                     f"pool rows other than the new ones "
                                     f"changed")
            held(g_pool[rows], w_pool[rows], INT8_LAYER_TOL,
                 f"decoder_layer_int8 {case}: written {label} rows")
        positions = sum(lens) + idle
        width = kw["slot_cap"] if slot else maxp
        extra = {**split_items(lens + [1] * idle, width * page, hkv, s),
                 **megakernel_plan(DL, s, d, hq, hkv, dh, f, x.device),
                 "bit_equal_launches": True, **mega[case]}
        record("decoder_layer_int8", case, cycling(kern, n_layers),
               cycling(plain, n_layers), cycling(lib, n_layers), got[:act],
               want[:act], INT8_LAYER_TOL,
               w_bytes + 4 * (a3 + 4 * d + 2 * f + 2 * dh)
               + 2 * 2 * s * d + 2 * 4 * s * dh
               + 2 * positions * hkv * dh * 2 + 12 * s,
               2.0 * s * w_bytes + 4.0 * hq * dh * positions,
               {"S": s, "D": d, "Hq": hq, "Hkv": hkv, "Dh": dh, "F": f,
                "page": page, "lens": lens + [1] * idle,
                "route": "slot" if slot else "paged"}, extra=extra)
        del c, kp, vp, k0, v0, k_got, v_got
        torch.cuda.empty_cache()
    report["split_bounds"] = split_bounds_phase(layers, card_line)
    del layers
    torch.cuda.empty_cache()
    return report


def route_recording_engine():
    """``recording_engine`` that also keeps each decode step's route."""
    Rec = recording_engine()

    class Routes(Rec):
        def decode_options(self, active):
            opts = super().decode_options(active)
            self.routes = getattr(self, "routes", [])
            self.routes.append(opts["slot_cap"])
            return opts

    return Routes


def int8_engine_phase(card_line: str) -> dict:
    """The full-width engine with int8 weights, each kernel run against the
    same engine's golden route: 4 slots (megakernel, slot-major then paged
    attention as a 614-token request joins), 16 slots (int8_matmul, slot
    attention, then the scatter kernel once the 614-token request joins,
    fused MLP), 4 slots with int8 KV; the
    first-step logits against native weights; one decode step profiled."""
    import types

    import numpy as np
    import torch
    from cmw_rag_tpu_torch.models import engine as E
    from cmw_rag_tpu_torch.scripts import local_llm as LL

    t0 = time.time()
    cfg = LL.config()
    params = LL.build_params(cfg, seed=0, device="cuda")
    prompts = LL.chat_prompts() + [LL.long_chat_prompt()]
    torch.cuda.synchronize()
    log("int8-llm-setup", time.time() - t0, card_line, spec=LL.SPEC,
        requests=len(prompts))
    Rec = route_recording_engine()
    # the slot-major route's page cap at this width (the TPU budget)
    cap_max = E.SLOT_ATTN_VMEM_LIMIT // (2 * 2 * LL.PAGE * cfg.kv_heads
                                         * cfg.hd * 2)
    n_l = cfg.num_layers
    kernel_names = list(INT8_KERNELS) + list(PAGED_KERNELS)

    def want_s4(eng):
        return {"decoder_layer_int8": n_l * eng.decode_steps,
                "int8_matmul": eng.decode_steps}

    def want_s16(eng):
        slot = sum(1 for c in eng.routes if 0 < c <= cap_max)
        return {"int8_matmul": (n_l + 1) * eng.decode_steps,
                "fused_mlp_int8": n_l * eng.decode_steps,
                "paged_decode_attention_dma_slot": n_l * slot,
                "paged_decode_attention_dma_scatter":
                    n_l * (eng.decode_steps - slot)}

    def want_kv8(eng):
        return {"int8_matmul": (n_l + 1) * eng.decode_steps,
                "fused_mlp_int8": n_l * eng.decode_steps,
                "paged_decode_attention_dma_kv_int8": n_l * eng.decode_steps}

    def staggered(eng):
        """The chats first, the long request 8 steps later (with 16 slots
        it would otherwise join at once and every step would be paged)."""
        reqs = [eng.submit(p, max_new_tokens=LL.MAX_NEW_TOKENS)
                for p in prompts[:-1]]
        for _ in range(8):
            eng.step()
        reqs.append(eng.submit(prompts[-1], max_new_tokens=LL.MAX_NEW_TOKENS))
        eng.run_until_done(reqs)
        return reqs

    runs = [("s4", dict(), want_s4), ("s16", dict(max_slots=16), want_s16),
            ("kv8", dict(kv_dtype="int8"), want_kv8)]
    result = {"runs": {}}
    for label, kw, want_fn in runs:
        traces = {}
        for route in ("golden", "kernel"):
            t1 = time.time()
            eng = LL.build_engine(params, cfg, engine_cls=Rec, weights="int8",
                                  use_kernel=route == "kernel", **kw)
            n0 = read_counts()
            reqs = staggered(eng)
            torch.cuda.synchronize()
            wall = time.time() - t1
            n1 = read_counts()
            bad = [(r.rid, r.finish_reason) for r in reqs
                   if not r.done or r.finish_reason not in ("length", "stop")]
            if bad:
                raise AssertionError(f"int8 {label} {route}: unfinished {bad}")
            launches = {k: n1[k] - n0[k] for k in kernel_names}
            want = {k: 0 for k in kernel_names}
            if route == "kernel":
                want.update(want_fn(eng))
            if launches != want:
                raise AssertionError(f"int8 {label} {route}: launches "
                                     f"{launches}, want {want} "
                                     f"({eng.decode_steps} decode steps)")
            slot_steps = sum(1 for c in eng.routes if 0 < c <= cap_max)
            run = {"decode_steps": eng.decode_steps,
                   "slot_route_steps": slot_steps,
                   "tokens": sum(len(r.out) for r in reqs), "wall_s": wall,
                   "ms_per_step": 1e3 * wall / eng.decode_steps,
                   "layer_fused": eng.layer_fused, "attn_slot": eng.attn_slot,
                   "kernel_launches": sum(launches.values())}
            traces[route] = types.SimpleNamespace(trace=eng.trace)
            if route == "kernel":
                if label != "kv8" and not 0 < slot_steps < eng.decode_steps:
                    raise AssertionError(f"int8 {label}: {slot_steps} of "
                                         f"{eng.decode_steps} steps slot-"
                                         f"major; both routes must run")
                run.update(compare_runs(traces["golden"], traces["kernel"],
                                        f"int8 {label}"))
            log(f"int8-llm-{label}-{route}", wall, card_line, **fmt(
                {k: v for k, v in run.items() if k != "drift_by_step"}),
                drift_by_step=json.dumps(run.get("drift_by_step", [])))
            result["runs"][f"{label}-{route}"] = run
            del eng
            torch.cuda.empty_cache()
    # first-step logits of int8 against native weights (golden routes)
    t1 = time.time()
    firsts = {}
    for weights in ("native", "int8"):
        eng = LL.build_engine(params, cfg, engine_cls=Rec, weights=weights,
                              use_kernel=False)
        LL.run_requests(eng, prompts[:6], max_new_tokens=2)
        firsts[weights] = [eng.trace[rid][0] for rid in sorted(eng.trace)]
        del eng
    cos = [float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
           for a, b in zip(firsts["native"], firsts["int8"])]
    same = sum(int(a.argmax() == b.argmax())
               for a, b in zip(firsts["native"], firsts["int8"]))
    result["first_step_vs_native"] = {"cosine": cos, "min_cosine": min(cos),
                                      "same_greedy_id": same}
    log("int8-llm-vs-native", time.time() - t1, card_line,
        min_cosine=f"{min(cos):.6f}", same_greedy_id=f"{same}/{len(cos)}")
    # where an int8 decode step spends its time: 4 active slots
    t1 = time.time()
    eng = LL.build_engine(params, cfg, weights="int8")
    for p in prompts[:4]:
        eng.submit(p, max_new_tokens=64)
    for _ in range(16):
        eng.step()
    profile = LL.profile_decode(eng, names=LL.LAYER_KERNEL_NAMES)
    log("int8-llm-decode-profile", time.time() - t1, card_line,
        **fmt({k: v for k, v in profile.items()
               if not isinstance(v, (list, dict))}))
    result["decode_profile"] = profile
    del eng, params
    torch.cuda.empty_cache()
    return result


def int8_llm_phase(card_line: str) -> dict:
    """Phase 9: the int8-path kernels against their twins, then the main
    path (the engine runs and the transport) with every count set to 0
    before it."""
    kernels = int8_kernel_phase(card_line)
    reset_counts()
    engine = int8_engine_phase(card_line)
    transport = transport_phase(card_line, weights="int8")
    launches = read_counts()
    for name in INT8_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was launched no time on the int8 "
                                 f"LLM path")
    return {"kernels": kernels, "engine": engine, "transport": transport,
            "launches": launches}


# ------------------------------------------- w8a8 and int8-KV LLM routes


def library_w8a8(x, w_q, scale):
    """Yardstick only: the activations quantized as the wrapper does, then
    ``torch._int_mm`` (which takes at least 17 rows: M padded to 32) and
    the two scales."""
    import torch
    from cmw_rag_tpu_torch.ops.int8_matmul import quantize_activations

    xq, sx = quantize_activations(x)
    m = xq.shape[0]
    if m < 32:
        xq = torch.cat([xq, xq.new_zeros((32 - m, xq.shape[1]))])
    acc = torch._int_mm(xq, w_q)[:m]
    return ((acc.float() * scale[None, :]) * sx[:, None]).to(x.dtype)


def library_layer_kv8(x, c2, s2, lay, pi, off, kq, ks, vq, vs, tables, lens,
                      eps=1e-6):
    """Yardstick only, phase 9's composite over int8 pages: the new rows
    quantized against their pages' scales by index, then the dequantizing
    gather and ``scaled_dot_product_attention``."""
    import torch
    from cmw_rag_tpu_torch.ops.paged_attention import (KV_HEADROOM,
                                                       quantize_kv_token)

    q, k, v = library_qkv(x, c2, s2, lay, kq.shape[2], eps)
    p, o = pi.long(), off.long()
    fresh = (o == 0)[:, None]
    for pool, plane, t in ((kq, ks, k), (vq, vs, v)):
        t = t.to(torch.bfloat16).float()
        new = torch.where(fresh, t.abs().amax(-1).clamp(min=1e-8)
                          * (KV_HEADROOM / 127.0), plane[p])
        pool[p, o] = quantize_kv_token(t, new)
        plane[p] = new
    attn = library_paged(q.to(torch.bfloat16), kq, vq, tables, lens, ks, vs)
    return library_mlp(x, attn.reshape(x.shape[0], -1), lay, eps)


def w8a8_matmul_records(card_line: str) -> dict:
    """``int8_matmul_w8a8`` against its twin, bit for bit, at every product
    of a layer (28 layers' weights read in turn) and the head, at 4 and 16
    slots, and bit for bit itself at other splits of the contraction; each
    call one kernel launch (a complete profiler window of 56 calls holds
    56 W8A8 kernels and nothing else), the whole call's device time read
    off that window, its twin, the yardstick and the bound. → {case:
    record}."""
    import torch
    from cmw_rag_tpu_torch.device import sm_count
    from cmw_rag_tpu_torch.ops import int8_matmul as IM

    n_layers, d, a, a3, f = 28, 1024, 2048, 4096, 3072
    gen = torch.Generator(device="cuda").manual_seed(10)
    t0 = time.time()
    layers = int8_layers(n_layers, gen)
    head_q, head_s = IM.quantize_weight(
        torch.randn((d, 151680), generator=gen, device="cuda") * 0.02)
    log("w8a8-matmul-setup", time.time() - t0, card_line, layers=n_layers)
    products = {"qkv": ("wqkv_q", "wqkv_s", d, a3),
                "wo": ("wo_q", "wo_s", a, d),
                "gateup": ("w_gateup_q", "w_gateup_s", d, 2 * f),
                "down": ("w_down_q", "w_down_s", f, d)}
    report = {}
    for case in W8A8_CASES:
        t1 = time.time()
        prod, slots = case.split("-")
        m = int(slots[1:])
        if prod == "head":
            ws, k, n, xdt = [(head_q, head_s)], d, 151680, torch.float32
        else:
            wq_name, ws_name, k, n = products[prod]
            ws = [(lay[wq_name], lay[ws_name]) for lay in layers]
            xdt = torch.bfloat16
        x = torch.randn((m, k), generator=gen, device="cuda").to(xdt)
        got = IM.int8_matmul_w8a8(x, *ws[0])
        want = IM.int8_matmul_w8a8_plain(x, *ws[0])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_matmul_w8a8 {case}: differs from its "
                                 f"twin by {(got - want).abs().max().item()}")
        ks, grid = IM.w8a8_plan(
            m, k, n, sm_count(x.device),
            IM._w8a8_resident(IM.w8a8_frags(m), xdt == torch.float32,
                              x.device))
        steps = k // IM.W8A8_STAGE_ROWS
        splits = sorted({sp for sp in (1, ks // 2, ks, 2 * ks, steps)
                         if 1 <= sp <= steps})
        for sp in splits:
            if not torch.equal(IM._w8a8_launch(x, *ws[0], split=sp), got):
                raise AssertionError(f"int8_matmul_w8a8 {case}: split {sp} "
                                     f"differs from split {ks}")
        kern = cycling(lambda i: IM.int8_matmul_w8a8(x, *ws[i]), len(ws))
        ms, seen, dropped = device_profile(kern, 56, "w8a8_mma_kernel")
        others = sorted({e for e in seen if "w8a8_mma_kernel" not in e})
        if len(seen) != 56 or others:
            raise AssertionError(f"int8_matmul_w8a8 {case}: {len(seen) / 56} "
                                 f"kernels a call, others {others}")
        xb = x.element_size()
        entry = {"max_abs_err": 0.0, "bit_equal": True, "split": ks,
                 "grid_blocks": grid, "bit_equal_splits": splits,
                 "kernels_per_call": len(seen) / 56,
                 "dropped_windows": dropped, "ms": ms,
                 "plain_ms": device_ms(cycling(
                     lambda i: IM.int8_matmul_w8a8_plain(x, *ws[i]),
                     len(ws)), 5),
                 "library_ms": device_ms(cycling(
                     lambda i: library_w8a8(x, *ws[i]), len(ws)), 5),
                 "call_ms": cuda_ms(kern, 56),
                 **bound(k * n + 4 * n + m * k * xb + m * n * xb,
                         2.0 * m * k * n, INT8_OPS_PER_S)}
        entry["bound_share"] = entry["bound_ms"] / ms
        log(f"kernel-int8_matmul_w8a8-{case}", time.time() - t1, card_line,
            **fmt(entry))
        report[case] = dict(entry, shape={"M": m, "K": k, "N": n,
                                          "x": str(xdt)})
    return report


def w8a8_kv8_kernel_phase(card_line: str) -> dict:
    """Hold the W8A8 matmul (``w8a8_matmul_records``, in a process of its
    own), the int8-KV megakernel
    and the batched attention alias against their twins at the main path's
    shapes (28 layers' weights read in turn); time each, its twin and a
    yardstick."""
    import torch
    from cmw_rag_tpu_torch.ops import decoder_layer as DL
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    n_layers, d, hq, hkv, dh, f, page, maxp = 28, 1024, 16, 8, 128, 3072, 64, 32
    a, a3 = hq * dh, (hq + 2 * hkv) * dh
    gen = torch.Generator(device="cuda").manual_seed(10)
    t0 = time.time()
    layers = int8_layers(n_layers, gen)
    log("w8a8-kv8-setup", time.time() - t0, card_line, layers=n_layers)
    report = {}

    def timed(name, case, kern, plain, lib, nbytes, ops, rate, shape, extra,
              iters=56):
        t1 = time.time()
        entry = {**extra, "plain_ms": device_ms(plain, 5),
                 "library_ms": device_ms(lib, 5),
                 "call_ms": cuda_ms(kern, iters), **bound(nbytes, ops, rate)}
        entry.setdefault("ms", device_ms(kern, iters))
        log(f"kernel-{name}-{case}", time.time() - t1, card_line,
            **fmt(entry))
        report[(name, case)] = dict(entry, shape=shape)

    # W8A8: in a process of its own (``w8a8_matmul_records``)
    for case, entry in timings_child(card_line, "w8a8_matmul_records",
                                     card_line).items():
        report[("int8_matmul_w8a8", case)] = entry

    # the int8-KV megakernel at 4 slots, one idle slot; its device times
    # from a process of its own (``timings_child``)
    mega = timings_child(card_line, "megakernel_timings", True)
    for case, lens, idle, route in MEGA_CASES[True]:
        c = mega_inputs(gen, lens, idle, route, True, n_layers, d, hkv, dh,
                        page, maxp)
        s = c["s"]
        kq, ks, vq, vs = c["pools"]
        x, c2, s2, page_idx, off, lens_t, tables = (
            c[k] for k in ("x", "c2", "s2", "page_idx", "off", "lens_t",
                           "tables"))

        def kern(li, c=c):
            return mega_call(c, layers[li], li)

        def plain(li, c=c):
            return mega_call(c, layers[li], li, plain=True)

        def lib(li, kq=kq, ks=ks, vq=vq, vs=vs, tables=tables):
            return library_layer_kv8(x, c2, s2, layers[li], page_idx, off,
                                     kq[li], ks[li], vq[li], vs[li], tables,
                                     lens_t)
        li = 5
        before = [t[li].clone() for t in (kq, ks, vq, vs)]
        got = kern(li)
        torch.cuda.synchronize()
        after = [t[li].clone() for t in (kq, ks, vq, vs)]
        for t, b0 in zip((kq, ks, vq, vs), before):
            t[li].copy_(b0)
        want = plain(li)
        act = slice(0, c["act"])
        rows = (page_idx[act].long(), off[act].long())
        pages = page_idx[act].long()
        checks = held(got[act], want[act], INT8_LAYER_TOL,
                      f"decoder_layer_int8_kv8 {case}")
        for label, g_pool, w_pool, b_pool in (("k", after[0], kq[li],
                                               before[0]),
                                              ("v", after[2], vq[li],
                                               before[2])):
            keep = torch.ones(g_pool.shape[:2], dtype=torch.bool,
                              device="cuda")
            keep[rows] = False
            keep[0] = False                               # the null page
            if not (torch.equal(g_pool[keep], b_pool[keep])
                    and torch.equal(w_pool[keep], b_pool[keep])):
                raise AssertionError(f"decoder_layer_int8_kv8 {case}: {label}"
                                     f" rows other than the new ones changed")
            diff = (g_pool[rows].int() - w_pool[rows].int()).abs().max()
            if diff.item() > 1:
                raise AssertionError(f"decoder_layer_int8_kv8 {case}: a "
                                     f"written {label} value {diff.item()} "
                                     f"from the twin's")
            checks[f"{label}_rows_max_diff"] = diff.item()
        for label, g_pl, w_pl, b_pl in (("k", after[1], ks[li], before[1]),
                                        ("v", after[3], vs[li], before[3])):
            keep = torch.ones(g_pl.shape[0], dtype=torch.bool, device="cuda")
            keep[pages] = False
            keep[0] = False
            if not torch.equal(g_pl[keep], b_pl[keep]):
                raise AssertionError(f"decoder_layer_int8_kv8 {case}: {label}"
                                     f" scales of other pages changed")
            steps = ((g_pl[pages] - w_pl[pages]).abs()
                     / bf16_step(w_pl[pages]).clamp(min=1e-30)).max().item()
            if steps > 1:
                raise AssertionError(f"decoder_layer_int8_kv8 {case}: a "
                                     f"{label} scale {steps} bf16 steps from "
                                     f"the twin's")
            checks[f"{label}_scale_max_bf16_steps"] = steps
        checks.update(megakernel_plan(DL, s, d, hq, hkv, dh, f, x.device,
                                      kv8=True), **mega[case])
        positions = sum(lens) + idle
        used = sum(-(-n // page) for n in lens) + idle
        w_bytes = d * a3 + a * d + d * 2 * f + f * d
        timed("decoder_layer_int8_kv8", case, cycling(kern, n_layers),
              cycling(plain, n_layers), cycling(lib, n_layers),
              w_bytes + 4 * (a3 + 4 * d + 2 * f + 2 * dh) + 2 * 2 * s * d
              + 2 * 4 * s * dh + 2 * positions * hkv * dh
              + 2 * 4 * used * hkv + 12 * s,
              2.0 * s * w_bytes + 4.0 * hq * dh * positions, BF16_OPS_PER_S,
              {"S": s, "D": d, "Hq": hq, "Hkv": hkv, "Dh": dh, "F": f,
               "page": page, "lens": lens + [1] * idle}, checks)
        del c, kq, vq, ks, vs, before, after
        torch.cuda.empty_cache()

    # the batched attention alias at 4 x 2048, bit for bit the paged kernel
    xin = paged_inputs(4, 32, [1, 63, 2047], n_layers, seed=40)
    q, kp, vp, tables, lens_t = (xin[k] for k in ("q", "kp", "vp", "tables",
                                                  "lens"))
    got = PA.paged_decode_attention_dma_batched(q, kp, vp, tables, lens_t,
                                                layer=3)
    want = PA.paged_decode_attention_dma(q, kp, vp, tables, lens_t, layer=3)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("paged_decode_attention_dma_batched differs "
                             "from paged_decode_attention_dma")
    pos = int(lens_t.sum().item())
    twin = PA.paged_decode_attention_xla(q, kp[3], vp[3], tables, lens_t)
    timed("paged_decode_attention_dma_batched", "serving",
          cycling(lambda li: PA.paged_decode_attention_dma_batched(
              q, kp, vp, tables, lens_t, layer=li), n_layers),
          cycling(lambda li: PA.paged_decode_attention_xla(
              q, kp[li], vp[li], tables, lens_t), n_layers),
          cycling(lambda li: library_paged(q, kp[li], vp[li], tables, lens_t),
                  n_layers),
          2 * pos * hkv * dh * 2 + 2 * 2 * q.numel() + tables.numel() * 4
          + 4 * 4, 4.0 * hq * dh * pos, BF16_OPS_PER_S,
          {"S": 4, "Hq": hq, "Hkv": hkv, "Dh": dh, "page": page, "maxp": 32,
           "lens": [1, 63, 2047, 1], "layers": n_layers},
          {"max_abs_err": (got[:3].float() - twin[:3].float()).abs().max()
           .item(), "bit_equal_to": "paged_decode_attention_dma"})
    del layers, xin, q, kp, vp
    torch.cuda.empty_cache()
    return report


def w8a8_kv8_engine_phase(card_line: str) -> dict:
    """The full-width engine on the routes a caller selects: w8a8 at 4 and
    16 slots, the int8-KV megakernel at 4 slots, attn_batched at 4 slots,
    each against its golden route; the first-step logits of w8a8 against
    int8 weights; profiled steps of w8a8, the int8-KV megakernel and the
    two ablations."""
    import types

    import numpy as np
    import torch
    from cmw_rag_tpu_torch.scripts import local_llm as LL

    t0 = time.time()
    cfg = LL.config()
    params = LL.build_params(cfg, seed=0, device="cuda")
    prompts = LL.chat_prompts() + [LL.long_chat_prompt()]
    torch.cuda.synchronize()
    log("w8a8-kv8-llm-setup", time.time() - t0, card_line, spec=LL.SPEC,
        requests=len(prompts))
    Rec = route_recording_engine()
    n_l = cfg.num_layers
    names = (list(W8A8_KV8_KERNELS) + list(INT8_KERNELS)
             + list(PAGED_KERNELS))

    def want_w8a8(eng):
        return {"int8_matmul_w8a8": (4 * n_l + 1) * eng.decode_steps,
                "paged_decode_attention_dma_scatter": n_l * eng.decode_steps}

    def want_kv8(eng):
        return {"decoder_layer_int8_kv8": n_l * eng.decode_steps,
                "int8_matmul": eng.decode_steps}

    def want_batched(eng):
        return {"paged_decode_attention_dma_batched": n_l * eng.decode_steps}

    def staggered(eng):
        """The chats first, the long request 8 steps later."""
        reqs = [eng.submit(p, max_new_tokens=LL.MAX_NEW_TOKENS)
                for p in prompts[:-1]]
        for _ in range(8):
            eng.step()
        reqs.append(eng.submit(prompts[-1], max_new_tokens=LL.MAX_NEW_TOKENS))
        eng.run_until_done(reqs)
        return reqs

    # W8A8's own noise floor, no kernel: the golden route with bucketed and
    # with chunked prefill; the W8A8 routes are held to twice it
    t1 = time.time()
    floor = {}
    for label, kw in (("bucketed", {}), ("chunked", dict(prefill_chunk=256))):
        eng = LL.build_engine(params, cfg, engine_cls=Rec, weights="w8a8",
                              use_kernel=False, **kw)
        LL.run_requests(eng, prompts[:-1])
        floor[label] = types.SimpleNamespace(trace=eng.trace)
        del eng
    w8a8_floor = compare_runs(floor["bucketed"], floor["chunked"],
                              "w8a8 floor", W8A8_FLOOR_MAX)
    w8a8_gate = 2 * w8a8_floor["max_logit_drift"]
    result = {"runs": {}, "w8a8_floor": w8a8_floor, "w8a8_gate": w8a8_gate}
    log("w8a8-floor", time.time() - t1, card_line,
        max_logit_drift=w8a8_floor["max_logit_drift"],
        floor_max=W8A8_FLOOR_MAX, gate=w8a8_gate)
    runs = [("w8a8-s4", dict(weights="w8a8"), want_w8a8, w8a8_gate),
            ("w8a8-s16", dict(weights="w8a8", max_slots=16), want_w8a8,
             w8a8_gate),
            ("kv8-megakernel", dict(weights="int8", kv_dtype="int8",
                                    layer_fused=True), want_kv8, LLM_DRIFT),
            ("batched", dict(attn_batched=True, scatter_fused=False),
             want_batched, LLM_DRIFT)]
    for label, kw, want_fn, gate in runs:
        traces = {}
        for route in ("golden", "kernel"):
            t1 = time.time()
            rkw = dict(kw, use_kernel=route == "kernel")
            if route == "golden":   # knobs of the kernel route only
                for knob in ("layer_fused", "attn_batched", "scatter_fused"):
                    rkw.pop(knob, None)
            eng = LL.build_engine(params, cfg, engine_cls=Rec, **rkw)
            n0 = read_counts()
            reqs = staggered(eng)
            torch.cuda.synchronize()
            wall = time.time() - t1
            n1 = read_counts()
            bad = [(r.rid, r.finish_reason) for r in reqs
                   if not r.done or r.finish_reason not in ("length", "stop")]
            if bad:
                raise AssertionError(f"{label} {route}: unfinished {bad}")
            launches = {k: n1[k] - n0[k] for k in names}
            want = {k: 0 for k in names}
            if route == "kernel":
                want.update(want_fn(eng))
            if launches != want:
                raise AssertionError(f"{label} {route}: launches {launches}, "
                                     f"want {want} ({eng.decode_steps} "
                                     f"decode steps)")
            run = {"decode_steps": eng.decode_steps,
                   "tokens": sum(len(r.out) for r in reqs), "wall_s": wall,
                   "ms_per_step": 1e3 * wall / eng.decode_steps,
                   "layer_fused": eng.layer_fused, "w8a8": eng.w8a8,
                   "kv_int8": eng.kv_int8, "attn_batched": eng.attn_batched,
                   "kernel_launches": sum(launches.values())}
            traces[route] = types.SimpleNamespace(trace=eng.trace)
            if route == "kernel":
                run.update(compare_runs(traces["golden"], traces["kernel"],
                                        label, gate))
            log(f"w8a8-kv8-llm-{label}-{route}", wall, card_line, **fmt(
                {k: v for k, v in run.items() if k != "drift_by_step"}),
                drift_by_step=json.dumps(run.get("drift_by_step", [])))
            result["runs"][f"{label}-{route}"] = run
            del eng
            torch.cuda.empty_cache()
    # first-step logits of w8a8 against int8 weights (golden routes)
    t1 = time.time()
    firsts = {}
    for weights in ("int8", "w8a8"):
        eng = LL.build_engine(params, cfg, engine_cls=Rec, weights=weights,
                              use_kernel=False)
        LL.run_requests(eng, prompts[:6], max_new_tokens=2)
        # the second sample is the first decode step's (the first, prefill,
        # dequantizes the same weights for both)
        firsts[weights] = [eng.trace[rid][1] for rid in sorted(eng.trace)]
        del eng
    cos = [float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
           for a, b in zip(firsts["int8"], firsts["w8a8"])]
    same = sum(int(a.argmax() == b.argmax())
               for a, b in zip(firsts["int8"], firsts["w8a8"]))
    result["first_decode_step_w8a8_vs_int8"] = {
        "cosine": cos, "min_cosine": min(cos), "same_greedy_id": same}
    log("w8a8-vs-int8", time.time() - t1, card_line,
        min_cosine=f"{min(cos):.6f}", same_greedy_id=f"{same}/{len(cos)}")
    # profiled decode steps: 4 active slots each
    profiles = {}
    for label, kw in (("w8a8", dict(weights="w8a8")),
                      ("kv8-megakernel", dict(weights="int8",
                                              kv_dtype="int8",
                                              layer_fused=True)),
                      ("ablate-noattn", dict(ablate="noattn")),
                      ("ablate-noscatter", dict(ablate="noscatter"))):
        t1 = time.time()
        eng = LL.build_engine(params, cfg, **kw)
        for p in prompts[:4]:
            eng.submit(p, max_new_tokens=64)
        for _ in range(16):
            eng.step()
        prof = LL.profile_decode(eng, names=LL.profile_names(eng))
        log(f"w8a8-kv8-profile-{label}", time.time() - t1, card_line,
            **fmt({k: v for k, v in prof.items()
                   if not isinstance(v, (list, dict))}))
        profiles[label] = prof
        del eng
        torch.cuda.empty_cache()
    result["decode_profiles"] = profiles
    del params
    torch.cuda.empty_cache()
    return result


def w8a8_kv8_phase(card_line: str) -> dict:
    """Phase 10: the new kernels against their twins, then the main path
    (the engine runs, the profiled steps and the w8a8 transport) with every
    count set to 0 before it."""
    kernels = w8a8_kv8_kernel_phase(card_line)
    reset_counts()
    engine = w8a8_kv8_engine_phase(card_line)
    transport = transport_phase(card_line, weights="w8a8")
    launches = read_counts()
    for name in W8A8_KV8_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} was launched no time on the w8a8 "
                                 f"and int8-KV LLM path")
    return {"kernels": kernels, "engine": engine, "transport": transport,
            "launches": launches}

# ------------------------------------------------- contrastive training path


def bwd_case(b: int, h: int, L: int, d: int, causal: bool, gen) -> dict:
    """Random bf16 q, k, v, dO [B*H, L, D] with ragged key masks, and the
    forward kernel's o and lse and delta over them."""
    import torch
    from cmw_rag_tpu_torch.ops import flash_attention as F

    q, k, v, do = (torch.randn((b * h, L, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.randint(L // 2, L + 1, (b,), generator=gen, device="cuda")
    pos = torch.arange(L, device="cuda")
    mask = (pos[None, :] < lens[:, None]).to(torch.int32)
    o, lse = F.flash_attention_fwd(q, k, v, mask, h, causal)
    return {"q": q, "k": k, "v": v, "do": do, "mask": mask, "lens": lens,
            "o": o, "lse": lse, "delta": F.bwd_delta(o, do), "pos": pos}


def bwd_bounds(c: dict, b: int, h: int, L: int, d: int, causal: bool) -> dict:
    """The least time of each backward kernel's work on these inputs: bytes
    (q, dO, lse, delta and the outputs whole; k and v over the real keys
    only, which are all that the outputs depend on; the mask) and operations
    (2 D per visible (query, real key) pair for each product: S, dP and dS K
    for dQ; S, dP, P^T dO and dS^T Q for dK/dV; S, dP, dQ, dK and dV for the
    whole backward, its five products)."""
    pos, lens = c["pos"], c["lens"]
    if causal:
        pairs = int((pos[None, :] + 1).minimum(lens[:, None]).sum().item())
    else:
        pairs = L * int(lens.sum().item())
    pairs *= h
    bf = 2.0 * h * d
    real_kv = 2 * bf * float(lens.sum().item())       # k and v, real keys
    rows = bf * b * L                                 # one [B*H, L, D] tensor
    stats = 4.0 * b * h * L * 2 + 4 * b * L            # lse, delta; the mask
    per_pair = 2.0 * d
    return {"dq": bound(rows * 2 + real_kv + stats + rows,
                        3 * per_pair * pairs),
            "dkv": bound(rows * 2 + real_kv + stats + 2 * rows,
                         4 * per_pair * pairs),
            "backward": bound(rows * 3 + real_kv + stats + 3 * rows,
                              5 * per_pair * pairs)}


def held_bwd(got, want, label: str) -> dict:
    """``got`` within one bf16 step of ``want`` plus ``BWD_TOL`` of its
    largest |value|; → (max abs err, max err past one step)."""
    import torch

    err = (got.float() - want.float()).abs()
    past = (err - bf16_step(want)).max().item()
    allowed = BWD_TOL * want.float().abs().max().item()
    if not bool(torch.isfinite(got.float()).all()) or past > allowed:
        raise AssertionError(f"{label}: {err.max().item()} from the twin, "
                             f"{past} past one bf16 step (allowed {allowed})")
    return {"max_abs_err": err.max().item(), "max_err_past_one_step": past,
            "allowed_past_one_step": allowed}


def library_bwd(c: dict, b: int, h: int, L: int, d: int, causal: bool):
    """Yardstick only: the backward of ``scaled_dot_product_attention`` with
    the same key mask and causality, as a closure to time alone."""
    import torch
    import torch.nn.functional as Fn

    pos, mask = c["pos"], c["mask"]
    keep = (mask[:, None, :] > 0)[:, None]                     # [B, 1, 1, L]
    if causal:
        keep = keep & (pos[:, None] >= pos[None, :])[None, None]
    qs, ks, vs = (c[n].view(b, h, L, d).detach().requires_grad_()
                  for n in ("q", "k", "v"))
    out = Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
    do = c["do"].view(b, h, L, d)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                       retain_graph=True)


def bwd_degenerate_case(card_line: str) -> dict:
    """The dQ and dK/dV kernels against the twins over key masks that reach
    every branch of their skipping (B 5, H 4, L 384, D 128, causal and
    not): every key real; an end inside the second tile; leading zeros past
    the first tile then an end inside the third; no real key (p = 1 over
    the processed keys); holes in the first tile and an end inside it.
    dK and dV of the keys past a batch row's last real key must be exactly
    0."""
    import torch
    from cmw_rag_tpu_torch.ops import flash_attention as F

    gen = torch.Generator(device="cuda").manual_seed(97)
    (dq_t, dkv_t), report = F.bwd_kernel_tiles(), {}
    b, h, L, d = 5, 4, 384, 128
    mask = torch.ones((b, L), dtype=torch.int32, device="cuda")
    mask[1, 200:] = 0
    mask[2, :150] = 0
    mask[2, 300:] = 0
    mask[3] = 0
    mask[4, 5:10] = 0
    mask[4, 100:] = 0
    last = {1: 199, 2: 299, 4: 99}
    for causal in (False, True):
        t0 = time.time()
        q, k, v, do = (torch.randn((b * h, L, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = F.flash_attention_fwd(q, k, v, mask, h, causal)
        args = (q, k, v, mask, do, lse, F.bwd_delta(o, do), h, causal)
        dq = F.flash_attention_bwd_dq(*args)
        dk, dv = F.flash_attention_bwd_dkv(*args)
        pdq = F.flash_attention_bwd_dq_plain(*args, *dq_t)
        pdk, pdv = F.flash_attention_bwd_dkv_plain(*args, *dkv_t)
        torch.cuda.synchronize()
        label = f"degenerate causal={causal}"
        held = {"dq": held_bwd(dq, pdq, f"dQ {label}"),
                "dk": held_bwd(dk, pdk, f"dK {label}"),
                "dv": held_bwd(dv, pdv, f"dV {label}")}
        for row, j in last.items():
            for name, g in (("dK", dk), ("dV", dv)):
                past = g.view(b, h, L, d)[row, :, j + 1:]
                if not torch.equal(past, torch.zeros_like(past)):
                    raise AssertionError(f"{label}: {name} of batch row {row} "
                                         f"past its last real key {j} is not "
                                         f"0")
        log(f"flash-backward-degenerate-causal{int(causal)}", time.time() - t0,
            card_line, B=b, H=h, L=L, D=d, causal=causal,
            **fmt({f"{k}_max_err_past_one_step": r["max_err_past_one_step"]
                   for k, r in held.items()}))
        report[f"causal={causal}"] = held
    return report


def flash_bwd_phase(card_line: str) -> dict:
    """Hold the dQ and dK/dV kernels against the twins (each over its
    kernel's tiles) at the trainer's, the window and a non-causal shape and
    over degenerate masks; time them, the twins and SDPA's backward."""
    import torch
    from cmw_rag_tpu_torch.ops import flash_attention as F

    gen = torch.Generator(device="cuda").manual_seed(8642)
    dq_t, dkv_t = F.bwd_kernel_tiles()
    if (dq_t, dkv_t) != F.BWD_TILES:
        raise AssertionError(f"backward tiles {(dq_t, dkv_t)}, the twins "
                             f"assume {F.BWD_TILES}")
    report = {"degenerate": bwd_degenerate_case(card_line)}
    for case, (b, h, L, d, causal) in (("train", (8, 16, 1024, 128, True)),
                                       ("window", (1, 16, 8192, 128, True)),
                                       ("noncausal", (8, 16, 1024, 128, False))):
        t0 = time.time()
        c = bwd_case(b, h, L, d, causal, gen)
        args = (c["q"], c["k"], c["v"], c["mask"], c["do"], c["lse"],
                c["delta"], h, causal)
        dq = F.flash_attention_bwd_dq(*args)
        dk, dv = F.flash_attention_bwd_dkv(*args)
        pdq = F.flash_attention_bwd_dq_plain(*args, *dq_t)
        pdk, pdv = F.flash_attention_bwd_dkv_plain(*args, *dkv_t)
        torch.cuda.synchronize()
        held = {"dq": held_bwd(dq, pdq, f"dQ {case}"),
                "dk": held_bwd(dk, pdk, f"dK {case}"),
                "dv": held_bwd(dv, pdv, f"dV {case}")}
        bounds = bwd_bounds(c, b, h, L, d, causal)
        lib_ms = cuda_ms(library_bwd(c, b, h, L, d, causal), 10)
        shape = {"B": b, "H": h, "L": L, "D": d, "causal": causal}
        entries = {
            "flash_attention_bwd_dq": dict(
                ms=cuda_ms(lambda: F.flash_attention_bwd_dq(*args), 20),
                plain_ms=cuda_ms(lambda: F.flash_attention_bwd_dq_plain(
                    *args, *dq_t), 2),
                max_abs_err=held["dq"]["max_abs_err"],
                max_err_past_one_step=held["dq"]["max_err_past_one_step"],
                **bounds["dq"]),
            "flash_attention_bwd_dkv": dict(
                ms=cuda_ms(lambda: F.flash_attention_bwd_dkv(*args), 20),
                plain_ms=cuda_ms(lambda: F.flash_attention_bwd_dkv_plain(
                    *args, *dkv_t), 2),
                max_abs_err=max(held["dk"]["max_abs_err"],
                                held["dv"]["max_abs_err"]),
                max_err_past_one_step=max(held["dk"]["max_err_past_one_step"],
                                          held["dv"]["max_err_past_one_step"]),
                **bounds["dkv"])}
        for name, entry in entries.items():
            # one library call computes dQ, dK and dV together
            entry.update(library_ms=lib_ms,
                         bound_share=entry["bound_ms"] / entry["ms"],
                         shape=shape)
            log(f"kernel-{name}-{case}", time.time() - t0, card_line,
                B=b, H=h, L=L, D=d, causal=causal, **fmt(
                    {k: v for k, v in entry.items() if k != "shape"}))
            report[(name, case)] = entry
        both = entries["flash_attention_bwd_dq"]["ms"] \
            + entries["flash_attention_bwd_dkv"]["ms"]
        report[("backward", case)] = dict(kernels_ms=both, library_ms=lib_ms,
                                          **bounds["backward"],
                                          errors=held, shape=shape)
        log(f"flash-backward-{case}", time.time() - t0, card_line,
            kernels_ms=f"{both:.4f}", sdpa_backward_ms=f"{lib_ms:.4f}",
            bound_ms=f"{bounds['backward']['bound_ms']:.4f}",
            bound_by=bounds["backward"]["bound_by"])
        del c, args, dq, dk, dv, pdq, pdk, pdv
        torch.cuda.empty_cache()
    return report


TRAIN_MODEL = "qwen3-embedding-0.6b"
TRAIN_BATCH = 8
TRAIN_TOKENS = 1024
TRAIN_STEPS = 5
TRAIN_LR = 1e-4


def training_pairs(tokenizer, n: int) -> list[tuple[str, str]]:
    """``n`` (query, document) pairs of real text: documents are 768-token
    windows of the checkout's markdown (``scripts/long_context.py``), each
    query the first 300 characters of the window that follows its document.
    (A query that is its document's own prefix makes the pair trivial even
    for random weights: causal last-token states of a shared prefix agree,
    and the first loss was 0.0086.)"""
    from cmw_rag_tpu_torch.scripts import long_context as lc

    texts = lc.window_chunks(ROOT, tokenizer, n_chunks=2 * n)[0]
    return [(texts[2 * i + 1][:300], texts[2 * i]) for i in range(n)]


def build_trainer(seed: int = 0):
    """``ContrastiveTrainer`` on full-width, full-depth qwen3-embedding-0.6b
    (bf16, random weights from a seeded CPU generator) on the card, through
    the flash kernels, with the spec's own prefixes and pooling."""
    import torch
    from cmw_rag_tpu_torch.config import get_embedding_model
    from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
    from cmw_rag_tpu_torch.tokenizer import get_tokenizer
    from cmw_rag_tpu_torch.training import ContrastiveTrainer

    spec = get_embedding_model(TRAIN_MODEL)
    tok = get_tokenizer()
    cfg = Qwen3Config(
        vocab_size=-(-max(spec.vocab_size, tok.n_vocab) // 128) * 128,
        d_model=spec.d_model, d_ff=spec.d_ff, num_layers=spec.num_layers,
        num_heads=spec.num_heads, num_kv_heads=spec.num_kv_heads,
        head_dim=spec.head_dim, dtype=torch.bfloat16)
    return ContrastiveTrainer(
        cfg, tokenizer=tok, learning_rate=TRAIN_LR, max_tokens=TRAIN_TOKENS,
        seed=seed, query_prefix=spec.query_prefix,
        document_prefix=spec.document_prefix, pooling=spec.pooling,
        arch="qwen3", use_flash=True, device="cuda")


def plain_route_grads(trainer, batch: dict, chunk: int = 4):
    """The first step's loss and gradients on the plain attention route, on
    the trainer's weights: the loss depends on the towers only through the
    pooled unit vectors, so their gradients come first (no tower graph
    kept), then each tower is run again ``chunk`` rows at a time with the
    graph and back-propagated from its rows' vector gradients (the chain
    rule, summed over rows). Plain attention keeps [B, H, L, L] float32
    probabilities for its backward, which at B = 8 for both towers would
    not fit the card."""
    import torch
    from cmw_rag_tpu_torch.models.pooling import pool_hidden
    from cmw_rag_tpu_torch.models.qwen3 import qwen3_hidden_states
    from cmw_rag_tpu_torch.training.contrastive import info_nce_loss

    def embed(ids, mask):
        h = qwen3_hidden_states(trainer.params, trainer.cfg, ids, mask)
        return pool_hidden(h, mask, "last_token", normalize=True)

    b = {k: torch.as_tensor(v).to(trainer.device) for k, v in batch.items()}
    with torch.no_grad():
        q, d = embed(b["q_ids"], b["q_mask"]), embed(b["d_ids"], b["d_mask"])
    q.requires_grad_(True)
    d.requires_grad_(True)
    loss = info_nce_loss(q, d)
    gq, gd = torch.autograd.grad(loss, (q, d))
    trainer.optimizer.zero_grad(set_to_none=True)
    for ids, mask, g in ((b["q_ids"], b["q_mask"], gq),
                         (b["d_ids"], b["d_mask"], gd)):
        for r in range(0, ids.shape[0], chunk):
            rows = slice(r, r + chunk)
            (embed(ids[rows], mask[rows]) * g[rows]).sum().backward()
    from cmw_rag_tpu_torch.models.weights import tree_leaves

    grads = [p.grad.detach().clone() for p in tree_leaves(trainer.params)]
    trainer.optimizer.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def leaf_names(params) -> list[str]:
    """Leaf names in tree order (``layers.3.wq``)."""
    out = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            out.append(prefix[:-1])

    walk(params, "")
    return out


def train_phase(card_line: str) -> dict:
    """ContrastiveTrainer at full width through the flash kernels: the first
    step against plain attention, 5 AdamW steps, exact launch counts,
    save and restore."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmw_rag_tpu_torch.models.weights import tree_leaves
    from cmw_rag_tpu_torch.ops import flash_attention as F
    from cmw_rag_tpu_torch.scripts.profile_query import _busy_us, _is_kernel

    t0 = time.time()
    trainer = build_trainer(seed=0)
    pairs = training_pairs(trainer.tokenizer, TRAIN_BATCH)
    batch = trainer.tokenize_pairs([p[0] for p in pairs],
                                   [p[1] for p in pairs])
    real = int(batch["q_mask"].sum() + batch["d_mask"].sum())
    per_step = 2 * trainer.cfg.num_layers
    torch.cuda.synchronize()
    log("train-setup", time.time() - t0, card_line, model=TRAIN_MODEL,
        layers=trainer.cfg.num_layers, d_model=trainer.cfg.d_model,
        vocab=trainer.cfg.vocab_size, batch=TRAIN_BATCH, tokens=TRAIN_TOKENS,
        real_tokens=real)

    # (a) the first step's loss and gradients: flash against plain attention
    t0 = time.time()
    reset_counts()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss_flash = trainer.loss(batch)
    loss_flash.backward()
    flash_grads = [p.grad.detach().clone() for p in tree_leaves(trainer.params)]
    counts = read_counts()
    want = {"flash_attention_fwd": per_step,
            "flash_attention_bwd_dq": per_step,
            "flash_attention_bwd_dkv": per_step}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"first step launches {counts}, want {want}")
    loss_flash = float(loss_flash.detach())
    loss_plain, plain_grads = plain_route_grads(trainer, batch)
    if read_counts()["flash_attention_fwd"] != per_step:
        raise AssertionError("the plain route launched the flash kernel")
    names = leaf_names(trainer.params)
    cos = {}
    for name, a, b in zip(names, flash_grads, plain_grads):
        a, b = a.float().flatten(), b.float().flatten()
        cos[name] = float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-30))
    del flash_grads, plain_grads
    worst = min(cos, key=cos.get)
    loss_gap = abs(loss_flash - loss_plain)
    log("train-first-step", time.time() - t0, card_line,
        loss_flash=f"{loss_flash:.6f}", loss_plain=f"{loss_plain:.6f}",
        loss_gap=f"{loss_gap:.6f}", min_grad_cos=f"{cos[worst]:.6f}",
        min_grad_cos_leaf=worst,
        grad_cos_below_0999=sum(v < 0.999 for v in cos.values()))
    if not np.isfinite(loss_flash) or loss_gap > TRAIN_LOSS:
        raise AssertionError(f"first-step loss: flash {loss_flash}, plain "
                             f"{loss_plain}")
    if cos[worst] < TRAIN_COS:
        raise AssertionError(f"gradient of {worst}: cosine {cos[worst]} "
                             f"between the flash and plain routes")

    # (b, c) the main path: 5 AdamW steps on one batch through the trainer's
    # loop, every kernel launched exactly 56 times a step
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_steps = time.perf_counter()
    losses = trainer.train(pairs, batch_size=TRAIN_BATCH, epochs=TRAIN_STEPS)
    step_wall = time.perf_counter() - t_steps
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: TRAIN_STEPS * per_step for k in want}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"losses over {TRAIN_STEPS} steps: {losses}")
    host_ms = 1e3 * step_wall / TRAIN_STEPS
    # one more step under the profiler: device busy time, idle share and
    # where the device time goes, by kernel name
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t_prof)
    events = [e for e in prof.events() if _is_kernel(e)]
    busy_ms = _busy_us(events) / 1e3
    by_name: dict = {}
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e3)

    def share(*parts):
        return sum(v for k, v in by_name.items()
                   if any(p in k.lower() for p in parts)) / busy_ms

    stats = {"losses": losses, "host_ms_per_step": host_ms,
             "device_busy_ms_per_step": busy_ms,
             "idle_share": 1.0 - busy_ms / prof_ms,
             "kernel_launches_per_step": len(events),
             "flash_share_of_busy": share("flash_fwd_kernel",
                                          "flash_bwd_dq_kernel",
                                          "flash_bwd_dkv_kernel"),
             # cuBLAS's Hopper GEMMs are named nvjet_*, older ones *gemm*
             "gemm_share_of_busy": share("nvjet", "gemm", "xmma", "cutlass"),
             "elementwise_share_of_busy": share("elementwise_kernel",
                                                "reduce_kernel"),
             "top_kernels_ms": [[k[:90], round(v, 3)] for k, v in sorted(
                 by_name.items(), key=lambda kv: -kv[1])[:8]],
             "peak_memory_gib": peak / 2 ** 30,
             "tokens_per_s": 2 * TRAIN_BATCH * TRAIN_TOKENS / (host_ms / 1e3),
             "real_tokens_per_s": real / (host_ms / 1e3)}
    log("train-steps", time.time() - t0, card_line,
        losses=json.dumps([round(x, 6) for x in losses]),
        top_kernels_ms=json.dumps(stats["top_kernels_ms"]),
        **fmt({k: v for k, v in stats.items()
               if k not in ("losses", "top_kernels_ms")}))

    # (d) save, then restore into a fresh trainer: params bit for bit
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "embedder.npz"
        trainer.save(path)
        fresh = build_trainer(seed=1)
        fresh.restore(path)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(trainer.params),
                                                 tree_leaves(fresh.params)))
    if not same:
        raise AssertionError("restored params differ from the saved ones")
    log("train-save-restore", time.time() - t0, card_line, bit_equal=same)
    del trainer, fresh
    torch.cuda.empty_cache()
    return {"first_step": {"loss_flash": loss_flash, "loss_plain": loss_plain,
                           "loss_gap": loss_gap, "min_grad_cos": cos[worst],
                           "min_grad_cos_leaf": worst},
            "steps": stats, "launches": launches,
            "launches_per_step": {k: v // TRAIN_STEPS for k, v in want.items()}}


def training_phase(card_line: str) -> dict:
    t0 = time.time()
    kernels = flash_bwd_phase(card_line)
    trained = train_phase(card_line)
    return {"kernels": kernels, "train": trained,
            "launches": trained.pop("launches"),
            "seconds": time.time() - t0}


# ------------------------------------------------------------------ eval

#: phase 12: the judged eval at ``EVAL_latest.json``'s ``shipped_config``
EVAL_FINGERPRINT = "2b4c73b23aac7cf6"
EVAL_SIZES = {"queries": 312, "articles": 8320, "chunks": 31841}
EVAL_RECORD = "EVAL_latest.json"
EVAL_REFERENCE = "tests/eval_reference_jax.json"
#: the rows held to the record, and their metrics: (aggregate, per query)
EVAL_ROWS = ("shipped_stage1", "shipped")
EVAL_METRICS = (("ndcg@10", "ndcg"), ("recall@10", "recall"),
                ("mrr_grade3", "mrr_grade3"))
EVAL_RESAMPLES = 1000
EVAL_RECORD_SES = 2.0      # gate 1: |port - record| within 2 bootstrap SEs
EVAL_PAIRED_SES = 3.0      # gate 2: |mean(port - JAX)| within 3 paired SEs
EVAL_CHUNK, EVAL_OVERLAP, EVAL_WINDOW, EVAL_K = 128, 16, 20, 10
#: the two scans of phase 12: (case, k) = stage 1 (3 x 10), rerank (3 x 20)
EVAL_SCANS = (("eval_k30", 30), ("eval_k60", 60))


def eval_gates(rows: dict, record: dict, reference: dict | None) -> dict:
    """Gate 1 (each row's metrics against ``EVAL_latest.json`` within
    ``EVAL_RECORD_SES`` bootstrap SEs of the run's own per-query values)
    and gate 2 (the mean per-query difference from the JAX package's rows
    within ``EVAL_PAIRED_SES`` paired SEs); resamples drawn with
    ``numpy.random.default_rng(0)`` (``scripts/eval_retrieval.bootstrap_se``).
    Raises on a gate that fails."""
    import numpy as np
    from cmw_rag_tpu_torch.scripts.eval_retrieval import bootstrap_se

    se = functools.partial(bootstrap_se, resamples=EVAL_RESAMPLES, seed=0)
    out, failed = {}, []
    for row in EVAL_ROWS:
        got = rows[row]["per_query"]
        ref = reference[row]["per_query"] if reference else None
        if ref is not None and [q["query"] for q in got] != \
                [q["query"] for q in ref]:
            raise AssertionError(f"eval {row}: the reference's queries differ")
        entry = {}
        for agg, key in EVAL_METRICS:
            vals = [q[key] for q in got]
            e = {"port": rows[row][agg], "record": record[row][agg],
                 "se": se(vals)}
            e["record_ses"] = abs(e["port"] - e["record"]) / max(e["se"], 1e-12)
            if not abs(e["port"] - e["record"]) <= EVAL_RECORD_SES * e["se"]:
                failed.append(f"{row} {agg}: {e['port']:.4f} against the "
                              f"record's {e['record']:.4f}, SE {e['se']:.4f}")
            if ref is not None:
                diff = np.asarray(vals) - np.asarray([q[key] for q in ref])
                e["jax"] = reference[row][agg]
                e["paired_mean"] = float(diff.mean())
                e["paired_se"] = se(diff)
                e["equal_share"] = float(np.mean(np.abs(diff) <= 1e-12))
                if not abs(e["paired_mean"]) <= EVAL_PAIRED_SES * e["paired_se"]:
                    failed.append(f"{row} {key}: mean port - JAX "
                                  f"{e['paired_mean']:.4f}, paired SE "
                                  f"{e['paired_se']:.4f}")
            entry[agg] = e
        if ref is not None:
            same = [all(abs(g[k] - r[k]) <= 1e-12 for _, k in EVAL_METRICS)
                    for g, r in zip(got, ref)]
            entry["equal_share"] = float(np.mean(same))
        out[row] = entry
    if failed:
        raise AssertionError("eval gates: " + "; ".join(failed))
    return out


def eval_scan_records(index, q_vecs, card_line: str) -> dict:
    """#1 at phase 12's shape: the index's rows and all 312 queries in one
    call at k 30 and 60, against its twin; time, twin, library call
    (chunked ``torch.matmul`` + ``torch.topk``) and bound."""
    import numpy as np
    import torch
    from cmw_rag_tpu_torch.ops import topk as T

    q = np.asarray(q_vecs, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    qt = torch.from_numpy(q).to("cuda", torch.bfloat16).contiguous()
    corpus, ids = index.vecs, index.ids
    n, d = corpus.shape
    nq = qt.shape[0]
    out = {}
    for case, k in EVAL_SCANS:
        t0 = time.time()
        kern = functools.partial(T.topk_scan_bf16, corpus, ids, qt, k)
        plain = functools.partial(T.topk_plain, corpus, ids, qt, k)
        lib = functools.partial(library_scan, corpus, None, ids, qt, k)
        # the twin one row deeper: the chunks of the eval's versions and
        # languages of one article score within a hair of each other, so
        # the k-th row is held only where the next one is clear of it
        ws, wi = T.topk_plain(corpus, ids, qt, k + 1)
        got = kern()
        torch.cuda.synchronize()
        err = check_against_plain(f"topk_scan_bf16 {case}", got,
                                  (ws[:, :k], wi[:, :k]), ids, [],
                                  beyond=ws[:, k])
        nbytes = 2 * n * d + 4 * n + 2 * nq * d + 8 * nq * k
        entry = {"ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 3),
                 "library_ms": cuda_ms(lib, 3), "max_abs_err": err,
                 **bound(nbytes, 2.0 * nq * n * d),
                 "shape": {"Q": nq, "N": n, "live": index.n_live, "D": d,
                           "k": k}}
        log(f"kernel-topk_scan_bf16-{case}", time.time() - t0, card_line,
            Q=nq, N=n, D=d, k=k, **fmt(entry))
        out[case] = entry
    return out


def eval_phase(card_line: str) -> dict:
    """Phase 12: the judged eval through the port's entry points at the
    shipping configuration, its rows held to the record and to the JAX
    package's rows, #1 timed at the eval's shape."""
    import numpy as np
    import torch
    from cmw_rag_tpu_torch.config import Settings
    from cmw_rag_tpu_torch.eval.corpus_gen import (CURRENT_VERSION,
                                                   generate_corpus)
    from cmw_rag_tpu_torch.eval.dataset import dataset_fingerprint
    from cmw_rag_tpu_torch.eval.judged_queries import build_judged_dataset
    from cmw_rag_tpu_torch.eval.runner import evaluate_retrieval
    from cmw_rag_tpu_torch.index.flat import FlatIndex
    from cmw_rag_tpu_torch.ops import topk as T
    from cmw_rag_tpu_torch.retrieval.embedder import create_embedder
    from cmw_rag_tpu_torch.retrieval.reranker import (EnsembleReranker,
                                                      create_reranker)
    from cmw_rag_tpu_torch.retrieval.siblings import SiblingIndex
    from cmw_rag_tpu_torch.scripts.eval_retrieval import _CachedEmbedder

    record = json.loads((ROOT / EVAL_RECORD).read_text(encoding="utf-8"))
    ref_path = ROOT / EVAL_REFERENCE
    reference = (json.loads(ref_path.read_text(encoding="utf-8"))
                 if ref_path.is_file() else None)
    seconds = {}
    t0 = time.time()
    dataset = build_judged_dataset(generate_corpus())
    fp = dataset_fingerprint(dataset)
    sizes = (len(dataset["queries"]), len(dataset["corpus"]))
    if fp != EVAL_FINGERPRINT or sizes != (EVAL_SIZES["queries"],
                                           EVAL_SIZES["articles"]):
        raise AssertionError(f"eval: dataset {fp}, {sizes}")
    sib = SiblingIndex()
    for c in dataset["corpus"]:
        if c.get("tags"):
            sib.add(c["kb_id"], c["tags"])
    seconds["generate"] = time.time() - t0
    log("eval-generate", seconds["generate"], card_line, fingerprint=fp,
        queries=sizes[0], articles=sizes[1])

    t0 = time.time()
    settings = Settings()
    emb = _CachedEmbedder(create_embedder(settings.embedding_model))
    rr = create_reranker(settings)
    slugs = settings.reranker_model.split(",")
    if not (isinstance(rr, EnsembleReranker)
            and [m.spec.slug for m in rr.members] == slugs):
        raise AssertionError(f"eval: the shipped reranker is {rr!r}, not the "
                             f"ensemble of {slugs}")
    rr.current_version = CURRENT_VERSION  # the dataset's, as the script sets
    if rr.current_version != "v6":
        raise AssertionError(f"eval: current version {rr.current_version}")
    torch.cuda.synchronize()
    seconds["models"] = time.time() - t0
    log("eval-models", seconds["models"], card_line,
        embedder=settings.embedding_model, members=len(rr.members),
        dtype=str(emb.inner.cfg.dtype))

    shared = dict(k=EVAL_K, pre_rerank_k=EVAL_WINDOW, chunk_tokens=EVAL_CHUNK,
                  chunk_overlap=EVAL_OVERLAP, current_version=CURRENT_VERSION,
                  device="cuda")
    plain_calls = []
    twins = {name: getattr(T, name) for name in ("topk_plain",
                                                 "topk_plain_int8")}
    for name, fn in twins.items():
        setattr(T, name, lambda *a, _fn=fn, **kw: (plain_calls.append(1),
                                                   _fn(*a, **kw))[1])
    reset_counts()
    rows, stages = {}, {}
    try:
        for row in EVAL_ROWS:
            t0 = time.time()
            timings: dict = {}
            extra = (dict(reranker=rr, sibling_index=sib,
                          sibling_slots=settings.sibling_expand_slots,
                          sibling_anchors=settings.sibling_expand_anchors)
                     if row == "shipped" else {})
            rows[row] = evaluate_retrieval(emb, dataset, timings=timings,
                                           **shared, **extra)
            stages[row] = timings
            r = rows[row]
            if r["n_chunks"] != EVAL_SIZES["chunks"] or \
                    r["n_queries"] != EVAL_SIZES["queries"]:
                raise AssertionError(f"eval {row}: {r['n_chunks']} chunks, "
                                     f"{r['n_queries']} queries")
            vals = [r[a] for a, _ in EVAL_METRICS]
            if not all(np.isfinite(vals)) or not all(0 <= v <= 1
                                                     for v in vals):
                raise AssertionError(f"eval {row}: metrics {vals}")
            log(f"eval-{row}", time.time() - t0, card_line,
                **{a: f"{r[a]:.4f}" for a, _ in EVAL_METRICS},
                record=json.dumps({a: round(record[row][a], 4)
                                   for a, _ in EVAL_METRICS}),
                stages=json.dumps({s: round(v, 3)
                                   for s, v in timings.items()}))
    finally:
        for name, fn in twins.items():
            setattr(T, name, fn)
    launches = read_counts()
    if launches["topk_scan_bf16"] < len(EVAL_ROWS) or plain_calls:
        raise AssertionError(f"eval: #1 launched {launches['topk_scan_bf16']} "
                             f"times, the plain twin {len(plain_calls)}")
    for s in ("chunk", "embed", "index", "search", "rerank"):
        seconds[s] = sum(t.get(s, 0.0) for t in stages.values())
    log("eval-stages", 0.0, card_line,
        **{s: f"{v:.3f}" for s, v in seconds.items()},
        launches=json.dumps({k: v for k, v in launches.items() if v}))

    gates = eval_gates(rows, record, reference)
    for row, g in gates.items():
        log(f"eval-gates-{row}", 0.0, card_line,
            equal_share=g.get("equal_share", "no reference"),
            **{a: json.dumps({k: round(v, 4) for k, v in e.items()})
               for a, e in g.items() if isinstance(e, dict)})

    # #1 at the eval's shape: the same rows and queries, out of the cache
    vecs = next(v for key, v in emb._cache.items() if key[0] == "docs")
    q_vecs = next(v for key, v in emb._cache.items() if key[0] == "queries")
    index = FlatIndex(dim=vecs.shape[1], capacity=len(vecs))
    index.add(vecs, np.arange(len(vecs)))
    scans = eval_scan_records(index, q_vecs, card_line)
    result = {"launches": launches, "seconds": seconds,
              "fingerprint": fp, "chunks": rows["shipped"]["n_chunks"],
              "gates": gates, "paired_reference": reference is not None,
              "scans": scans,
              "rows": {row: {k: v for k, v in r.items()
                             if k not in ("per_query", "by_language",
                                          "by_source")}
                       for row, r in rows.items()}}
    del emb, rr, index
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
    t_ivf = time.time()
    ivf = ivf_phase(card_line)
    segmented = segmented_phase(card_line)
    ivf_seconds = time.time() - t_ivf
    t_llm = time.time()
    llm = local_llm_phase(card_line)
    llm_seconds = time.time() - t_llm
    t_int8 = time.time()
    int8 = int8_llm_phase(card_line)
    int8_seconds = time.time() - t_int8
    t_new = time.time()
    w8a8 = w8a8_kv8_phase(card_line)
    w8a8_seconds = time.time() - t_new
    train = training_phase(card_line)
    t_eval = time.time()
    ev = eval_phase(card_line)
    eval_seconds = time.time() - t_eval

    by_path = {"fused": fused["launches"], "long_context": long_ctx["launches"],
               "ivf": ivf["launches"], "segmented": segmented["launches"],
               "local_llm": llm["launches"],
               "local_llm_int8": int8["launches"],
               "local_llm_w8a8_kv8": w8a8["launches"],
               "train": train["launches"], "eval": ev["launches"]}
    rows = []
    for name in ("topk_scan_bf16", "topk_scan_int8"):
        main_shape = scans[(name, "main")]
        row = {"name": name, "route": "cuda",
               "source": "cmw_rag_tpu_torch/csrc/ivf_scan.cu",
               "replaces": main_shape["replaces"],
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "max_abs_err": max(scans[(name, c[0])]["max_abs_err"]
                                  for c in SCAN_CASES)}
        row.update({k: main_shape[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms",
            "select_ms", "workspace_mib", "shape")})
        for case, *_ in SCAN_CASES[1:]:
            row[case] = {k: scans[(name, case)][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "scan_ms", "select_ms", "workspace_mib",
                "shape")}
        if name == "topk_scan_bf16":
            row.update(ev["scans"])
            row["max_abs_err"] = max(row["max_abs_err"], *(
                e["max_abs_err"] for e in ev["scans"].values()))
        rows.append(row)
    fa = flash["rerank"]
    rows.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "cmw_rag_tpu_torch/csrc/flash_attention.cu",
        "replaces": "cmw_rag_tpu/ops/flash_attention.py:306",
        "also_replaces": "cmw_rag_tpu/ops/flash_attention.py:92",
        "launches": sum(p["flash_attention_fwd"] for p in by_path.values()),
        "launches_by_path": {p: c["flash_attention_fwd"]
                             for p, c in by_path.items()},
        "launches_by_stage": {"embed": long_ctx["embed_flash_launches"],
                              "rerank": long_ctx["rerank_flash_launches"]},
        "max_abs_err": max(flash[c]["max_abs_err"] for c in flash),
        **{k: fa[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "lse_max_abs_err",
                              "max_err_past_one_step", "shape")},
        **{case: {k: flash[case][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "lse_max_abs_err", "max_err_past_one_step",
            "shape") + (("library_unmasked_ms",) if case == "full" else ())}
           for case in ("window", "train", "full")},
    })
    ivf_cases = {"ivf_probed_scan": ("q1", "q8"),
                 "ivf_union_scan": ("q8", "q32", "q8k129", "q8k256",
                                    "q8k1000")}
    for name, replaces in IVF_KERNELS.items():
        cases = ivf_cases[name.removesuffix("_int8")]
        main_case = ivf["kernels"][(name, cases[0])]
        row = {"name": name, "route": "cuda",
               "source": "cmw_rag_tpu_torch/csrc/ivf_scan.cu",
               "replaces": replaces,
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "max_abs_err": max(ivf["kernels"][(name, c)]["max_abs_err"]
                                  for c in cases)}
        row.update({k: main_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms",
                                              "scan_ms", "select_ms", "shape")
                    if k in main_case})
        for case in cases[1:]:
            row[case] = {k: v for k, v in ivf["kernels"][(name, case)].items()
                         if k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "max_abs_err", "scan_ms",
                                  "select_ms", "shape")}
        rows.append(row)
    runs = llm["engine"]["runs"]
    for name, replaces in PAGED_KERNELS.items():
        main_case = llm["kernels"][(name, "serving")]
        row = {"name": name, "route": "cuda",
               "source": "cmw_rag_tpu_torch/csrc/paged_attention.cu",
               "replaces": replaces,
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "decode_steps_by_run": {r: v["decode_steps"]
                                       for r, v in runs.items()},
               "max_abs_err": max(
                   max(e["max_abs_err"], e["edges"]["max_abs_err"])
                   for e in (llm["kernels"][(name, c)]
                             for c in ("serving", "bench", "s32")))}
        paged_keys = ("call_ms", "bound_share", "kernels_per_call", "split",
                      "n_split", "ms_by_split", "bit_equal_launches", "edges")
        row.update({k: main_case[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_err_past_one_step", "tolerance", "shape") + paged_keys})
        for case in ("bench", "s32"):
            row[case] = {k: llm["kernels"][(name, case)][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "shape") + paged_keys}
        if name in PAGED_ALIASES:
            row["also_replaces"] = PAGED_ALIASES[name]
        rows.append(row)
    int8_cases = {"int8_matmul": tuple(c for c, _, _, _ in INT8_MM_CASES),
                  "paged_decode_attention_dma_slot": ("s4-cap6", "s4-cap2",
                                                      "s16-cap6"),
                  "fused_mlp_int8": ("s4", "s16", "s32"),
                  "decoder_layer_int8": ("s4-slot", "s4-paged")}
    int8_runs = int8["engine"]["runs"]
    for name, (replaces, source) in INT8_KERNELS.items():
        cases = int8_cases[name]
        main_case = int8["kernels"][(name, cases[0])]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "decode_steps_by_run": {r: v["decode_steps"]
                                       for r, v in int8_runs.items()},
               "max_abs_err": max(int8["kernels"][(name, c)]["max_abs_err"]
                                  for c in cases)}
        row.update({k: main_case[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_err_past_one_step", "tolerance", "shape")})
        split_keys = ("split", "n_split", "items", "live_items",
                      "grid_blocks", "ms_by_split", "bit_equal_launches",
                      "noattn_ms", "row_tile", "ring", "splits", "merges",
                      "block_stages", "grid_waits", "call_ms", "bound_share",
                      "kernels_per_call")
        row.update({k: main_case[k] for k in split_keys if k in main_case})
        for case in cases[1:]:
            entry = int8["kernels"][(name, case)]
            row[case] = {k: entry[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "shape") + split_keys if k in entry}
        rows.append(row)
    new_cases = {"int8_matmul_w8a8": W8A8_CASES,
                 "decoder_layer_int8_kv8": ("s4", "s4-long"),
                 "paged_decode_attention_dma_batched": ("serving",)}
    new_runs = w8a8["engine"]["runs"]
    for name, (replaces, source) in W8A8_KV8_KERNELS.items():
        cases = new_cases[name]
        main_case = w8a8["kernels"][(name, cases[0])]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "decode_steps_by_run": {r: v["decode_steps"]
                                       for r, v in new_runs.items()},
               "max_abs_err": max(w8a8["kernels"][(name, c)]["max_abs_err"]
                                  for c in cases)}
        w8a8_keys = ("call_ms", "bound_share", "kernels_per_call", "split",
                     "grid_blocks")
        row.update({k: main_case[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
            + w8a8_keys if k in main_case})
        for case in cases[1:]:
            row[case] = {k: w8a8["kernels"][(name, case)][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "shape") + w8a8_keys
                if k in w8a8["kernels"][(name, case)]}
        rows.append(row)
    for name, (replaces, source) in BWD_KERNELS.items():
        cases = ("train", "window", "noncausal")
        main_case = train["kernels"][(name, cases[0])]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "launches_per_step": train["train"]["launches_per_step"][name],
               "max_abs_err": max(train["kernels"][(name, c)]["max_abs_err"]
                                  for c in cases)}
        row.update({k: main_case[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
            "library_ms", "max_err_past_one_step", "shape")})
        for case in cases[1:]:
            row[case] = {k: train["kernels"][(name, case)][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_share", "max_abs_err", "max_err_past_one_step",
                "shape")}
        rows.append(row)
    off_path = {"topk_scan_int8mxu": scans[("topk_scan_int8mxu", "main")],
                "topk_scan_stream": scans[("topk_scan_stream", "main")],
                "ivf_probed_scan_dma":
                    ivf["kernels"][("ivf_probed_scan_dma", "q1")]}
    for name, (replaces, source) in OFF_PATH_KERNELS.items():
        entry = off_path[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(p[name] for p in by_path.values()),
                     "on_a_main_path": False,
                     **{k: entry[k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "shape")}})
    print(json.dumps({"kernels": rows, "pipeline_qps": fused["qps"],
                      "card_vs_cpu": card_cpu,
                      "long_context": {k: v for k, v in long_ctx.items()
                                       if k != "launches"},
                      "ivf": {"build_s": ivf["build_s"],
                              "recall_at_10": ivf["recall_at_10"]},
                      "segmented": {k: v for k, v in segmented.items()
                                    if k != "launches"},
                      "ivf_phases_seconds": round(ivf_seconds, 3),
                      "local_llm": {"engine": llm["engine"],
                                    "transport": llm["transport"]},
                      "local_llm_phase_seconds": round(llm_seconds, 3),
                      "local_llm_int8": {
                          "engine": int8["engine"],
                          "transport": int8["transport"],
                          "split_bounds": int8["kernels"]["split_bounds"]},
                      "local_llm_int8_phase_seconds": round(int8_seconds, 3),
                      "local_llm_w8a8_kv8": {"engine": w8a8["engine"],
                                             "transport": w8a8["transport"]},
                      "local_llm_w8a8_kv8_phase_seconds":
                          round(w8a8_seconds, 3),
                      "training": {
                          **train["train"],
                          "backward": {case: train["kernels"][("backward", case)]
                                       for case in ("train", "window",
                                                    "noncausal")},
                          "backward_degenerate":
                              train["kernels"]["degenerate"]},
                      "training_phase_seconds": round(train["seconds"], 3),
                      "eval": {k: v for k, v in ev.items()
                               if k not in ("launches", "scans")},
                      "eval_phase_seconds": round(eval_seconds, 3),
                      "seconds": round(time.time() - t_all, 3),
                      "card": card_line}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
