"""Exact scan top-k: hand-written CUDA kernels and their plain twins
(port of ``cmw_rag_tpu/ops/topk.py:35-253`` and ``:341-469``).

Semantics, shared by every function here and by the TPU kernels they
replace: scores are dot products accumulated in float32 (an int8 row is
multiplied by its f32 scale after the product); rows whose id is < 0
(tombstones, padding) never surface; each query keeps its ``k`` best rows
ordered by (score descending, id ascending); slots with no valid row hold
``(NEG_INF, -1)``. Any ``k >= 1`` is taken; past the number of live rows
the tail is empty slots.

- ``topk_scan_bf16`` / ``topk_scan_int8`` are the wrappers the pipeline
  calls. On CUDA tensors they launch the persistent scan and exact
  selection of ``csrc/ivf_scan.cu`` over the corpus as one block
  (``ops/ivf_scan.flat_scan``; replacing ``topk_pallas`` :164 and
  ``topk_pallas_int8`` :210) and add one to their ``launches`` count per
  call (each chunk of queries, 64 or past 32 queries 128, launches
  ``ivf_scan_kernel``, which writes every row's score to a per-stream
  workspace of chunk x N floats, then ``select_k::select_kernel``, whose
  serial work does not grow with k); on CPU tensors they run the plain
  twin. Wrong device, dtype, shape
  or contiguity raises (D a multiple of 8, of 16 for an int8 corpus, for
  the TMA boxes): there is no fallback.
- ``topk_plain`` / ``topk_plain_int8`` are the plain twins: float32 scores
  over chunks of rows (never a float32 copy of the whole corpus), then a
  stable sort that keeps ties in id order.
- ``topk_scan_int8mxu`` replaces ``topk_pallas_int8mxu`` (:290, body
  ``_fused_topk_int8mxu_kernel`` :255): the queries are quantized per row
  (``quantize_rows_int8``, torch ops in the wrapper as in the JAX
  package), the product is int8 x int8 with an exact int32 sum, and the
  score is ``(float(acc) · q_scale) · scale``. It launches
  ``csrc/topk_scan.cu`` (``scan_kernel`` with running lists folded per
  tile, then ``merge_kernel``, k rounds over the blocks' sorted lists);
  its twin ``topk_plain_int8mxu`` takes the sums in float64, which holds
  them exactly, so the two agree bit for bit. No caller outside the
  tests, as in the JAX package.
- ``topk_scan_stream`` is ``topk_pallas_stream`` (:418), the TPU's
  streaming schedule of ``topk_pallas``: an alias of ``topk_scan_bf16``
  with its own ``launches`` count (``tile_n`` is TPU schedule).
"""

from __future__ import annotations

import ctypes

import torch

from cmw_rag_tpu_torch.device import on_cpu
from cmw_rag_tpu_torch.ops import cuda_build

NEG_INF = -3.0e38
PLAIN_CHUNK_ROWS = 65536


def _select(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """[Q, M] scores and ids → top ``k`` by (score desc, id asc); invalid
    entries become (NEG_INF, -1) and sort last."""
    valid = (ids >= 0) & (scores > NEG_INF / 2)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    ids = torch.where(valid, ids, torch.full_like(ids, -1))
    by_id = torch.argsort(ids, dim=1, stable=True)
    scores, ids = scores.gather(1, by_id), ids.gather(1, by_id)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return scores.gather(1, order[:, :k]), ids.gather(1, order[:, :k])


def _plain_scan(score_chunk, n: int, ids: torch.Tensor, nq: int, k: int,
                device, chunk_rows: int):
    best_s = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=device)
    for start in range(0, n, chunk_rows):
        stop = min(start + chunk_rows, n)
        s = score_chunk(start, stop)
        i = ids[start:stop].to(torch.int32)[None, :].expand(nq, -1)
        best_s, best_i = _select(torch.cat([best_s, s], dim=1),
                                 torch.cat([best_i, i], dim=1), k)
    return best_s, best_i


def topk_plain(corpus: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
               k: int, chunk_rows: int = PLAIN_CHUNK_ROWS):
    """Plain twin of ``topk_scan_bf16``: → (scores [Q, k] f32, ids [Q, k] i32)."""
    q = queries.float()
    return _plain_scan(lambda a, b: q @ corpus[a:b].float().T,
                       corpus.shape[0], ids, q.shape[0], k, corpus.device,
                       chunk_rows)


def topk_plain_int8(corpus: torch.Tensor, scales: torch.Tensor,
                    ids: torch.Tensor, queries: torch.Tensor, k: int,
                    chunk_rows: int = PLAIN_CHUNK_ROWS):
    """Plain twin of ``topk_scan_int8``: int8 rows × f32 row scales."""
    q = queries.float()
    return _plain_scan(
        lambda a, b: (q @ corpus[a:b].float().T) * scales[a:b].float()[None, :],
        corpus.shape[0], ids, q.shape[0], k, corpus.device, chunk_rows)


def topk_plain_int8mxu(corpus: torch.Tensor, scales: torch.Tensor,
                       ids: torch.Tensor, queries: torch.Tensor, k: int,
                       chunk_rows: int = PLAIN_CHUNK_ROWS):
    """Plain twin of ``topk_scan_int8mxu``: queries quantized per row, exact
    int8 x int8 sums, ``(float(acc) · q_scale) · scale``."""
    q8, qs = quantize_rows_int8(queries)
    qd = q8.double()
    return _plain_scan(
        lambda a, b: ((qd @ corpus[a:b].double().T).float() * qs[:, None])
        * scales[a:b].float()[None, :],
        corpus.shape[0], ids, q8.shape[0], k, corpus.device, chunk_rows)


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge candidate pools [Q, M] → top ``k`` per row, ids < 0 masked
    (``lax.top_k`` order: ties keep the lower column first)."""
    s = torch.where(ids >= 0, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return s.gather(1, order), ids.gather(1, order)


def quantize_rows_int8(vectors: torch.Tensor):
    """Symmetric per-row int8: → (int8 [N, D], f32 scales [N]),
    ``row ≈ int8 * scale``."""
    vf = vectors.float()
    scale = vf.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    q = torch.round(vf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


# ------------------------------------------------------------------ kernels


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("topk_scan")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.topk_scan_int8q.argtypes = [p, p, p, p, p, i, ll, i, i, i, p, p,
                                        p, p, p, p, p]
        for fn in ("topk_scan_int8q", "topk_scan_tile_rows",
                   "topk_scan_max_blocks", "topk_scan_max_shared_k"):
            getattr(lib, fn).restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _flat_scan(corpus, scales, ids, queries, k: int):
    # imported here: ops/ivf_scan imports this module's twins
    from cmw_rag_tpu_torch.ops import ivf_scan

    return ivf_scan.flat_scan(corpus, scales, ids, queries, k)


def _launch_int8q(corpus, scales, ids, q8, q_scale, k: int):
    if corpus.dim() != 2 or q8.dim() != 2:
        raise ValueError("corpus and queries must be 2-D")
    n, d = corpus.shape
    nq = q8.shape[0]
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if d % 8:
        raise ValueError(f"D={d} must be a multiple of 8")
    if n < 1 or nq < 1:
        raise ValueError("empty corpus or query batch")
    _check("queries", q8, torch.int8, (nq, d))
    _check("query scales", q_scale, torch.float32, (nq,))
    _check("ids", ids, torch.int32, (n,))
    lib = _lib()
    dev = corpus.device
    tiles = -(-n // lib.topk_scan_tile_rows())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = max(1, min(tiles, 2 * sms, lib.topk_scan_max_blocks()))
    part_s = torch.empty((n_blocks, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_blocks, nq, k), dtype=torch.int32, device=dev)
    alt_s = alt_i = None
    if k > lib.topk_scan_max_shared_k():
        alt_s, alt_i = torch.empty_like(part_s), torch.empty_like(part_i)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.topk_scan_int8q(
            q8.data_ptr(), corpus.data_ptr(), q_scale.data_ptr(),
            scales.data_ptr(), ids.data_ptr(), nq, n, d, k, n_blocks,
            part_s.data_ptr(), part_i.data_ptr(),
            None if alt_s is None else alt_s.data_ptr(),
            None if alt_i is None else alt_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"topk_scan_int8q launch failed: CUDA error {err}")
    return out_s, out_i


def topk_scan_bf16(corpus: torch.Tensor, ids: torch.Tensor,
                   queries: torch.Tensor, k: int):
    """bf16 corpus [N, D], ids [N] int32, queries [Q, D] bf16 →
    (scores [Q, k] f32, ids [Q, k] int32)."""
    if on_cpu(corpus, ids, queries):
        return topk_plain(corpus, ids, queries, k)
    out = _flat_scan(corpus, None, ids, queries, k)
    topk_scan_bf16.launches += 1
    return out


def topk_scan_int8(corpus: torch.Tensor, scales: torch.Tensor,
                   ids: torch.Tensor, queries: torch.Tensor, k: int):
    """int8 corpus [N, D] with f32 row scales [N], ids [N] int32, queries
    [Q, D] bf16 → (scores [Q, k] f32, ids [Q, k] int32)."""
    if on_cpu(corpus, scales, ids, queries):
        return topk_plain_int8(corpus, scales, ids, queries, k)
    out = _flat_scan(corpus, scales, ids, queries, k)
    topk_scan_int8.launches += 1
    return out


def topk_scan_int8mxu(corpus: torch.Tensor, scales: torch.Tensor,
                      ids: torch.Tensor, queries: torch.Tensor, k: int,
                      tile_n: int = 1024):
    """int8 corpus [N, D] with f32 row scales [N], ids [N] int32, float
    queries [Q, D] (quantized per row here) → (scores [Q, k] f32, ids
    [Q, k] int32)."""
    if on_cpu(corpus, scales, ids, queries):
        return topk_plain_int8mxu(corpus, scales, ids, queries, k)
    _check("corpus", corpus, torch.int8, corpus.shape)
    _check("scales", scales, torch.float32, (corpus.shape[0],))
    q8, qs = quantize_rows_int8(queries)
    out = _launch_int8q(corpus, scales, ids, q8.contiguous(), qs.contiguous(),
                        k)
    topk_scan_int8mxu.launches += 1
    return out


def topk_scan_stream(corpus: torch.Tensor, ids: torch.Tensor,
                     queries: torch.Tensor, k: int, tile_n: int = 1024):
    """Alias of ``topk_scan_bf16`` (the TPU's streaming schedule)."""
    if on_cpu(corpus, ids, queries):
        return topk_plain(corpus, ids, queries, k)
    out = _flat_scan(corpus, None, ids, queries, k)
    topk_scan_stream.launches += 1
    return out


topk_scan_bf16.launches = 0
topk_scan_int8.launches = 0
topk_scan_int8mxu.launches = 0
topk_scan_stream.launches = 0
