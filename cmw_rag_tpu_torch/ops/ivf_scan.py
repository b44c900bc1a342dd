"""Exact top-k over IVF blocks: the hand-written CUDA kernel and its plain
twins (port of ``cmw_rag_tpu/ops/ivf_scan.py``).

Layout (built by ``index/ivf.IVFIndex``): the corpus is ``n_blocks`` blocks
of ``block_n`` cluster-sorted rows; ``ids`` holds -1 for padding and
tombstones. For each query the scores are dot products accumulated in
float32 over the rows of its blocks (an int8 row is multiplied by its f32
scale after the product); rows with id < 0 never surface; a block listed
twice gives its rows once; the query keeps its ``k`` best rows in (score
descending, id ascending) order; slots with no valid row hold
``(NEG_INF, -1)``. Any ``k >= 1``.

- ``ivf_probed_scan`` / ``ivf_probed_scan_int8``: query q scans its own
  blocks ``block_idx[q, :]`` (replacing ``ivf_probed_scan`` :95 and
  ``ivf_probed_scan_int8`` :567).
- ``ivf_probed_scan_dma`` (:231, ``_ivf_dma_kernel``) is the TPU's manual
  DMA schedule of ``ivf_probed_scan`` with the same results: an alias of
  it here, with its own ``launches`` count.
- ``ivf_union_scan`` / ``ivf_union_scan_int8``: every query scans every
  block of ``block_list[:n_unique]`` (replacing ``ivf_union_scan`` :340 and
  ``ivf_union_scan_int8`` :452). The order is exact over all rows scanned:
  the TPU kernel skips a block unless some score of the whole [Q, block_n]
  tile strictly beats that query's k-th score, so there a row that exactly
  ties the k-th score with a smaller id in a later block stays out.

On CUDA tensors each wrapper launches ``csrc/ivf_scan.cu`` (one scan
template over a block table, bf16 and int8 instantiations, that writes
every scanned row's score into a candidate workspace; then the exact
selection of ``csrc/select_k.cuh``) and adds one to its ``launches``
count; on CPU tensors it runs its plain twin. Wrong device, dtype, shape
or contiguity raises (an int8 corpus needs D a multiple of 16, for its
TMA boxes): there is no fallback. The kernel takes the batch in chunks of
``QUERY_CHUNK`` queries, one scan and one selection each, so the
candidate workspace (scores, ids, the selection's histograms, counters
and survivors) holds one chunk; it is kept per (device, stream) and sized
from the table's width (``launch_sizes``), never from the device's
``n_unique``, so a call does not wait for the card. ``n_unique`` counts
distinct blocks (``index/ivf.union_blocks`` gives them so), at most
``n_blocks``: with it the workspace holds ``min(U, n_blocks)`` entries a
query and entries past the ``n_blocks``-th are not scanned. The
twins (``*_plain``) gather the rows of the distinct listed blocks and
select with ``ops/topk``'s plain scan. ``ivf_probed_scan_golden`` copies
the JAX golden ``ivf_probed_scan_xla`` (:622-645).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cmw_rag_tpu_torch.device import on_cpu
from cmw_rag_tpu_torch.ops import cuda_build
from cmw_rag_tpu_torch.ops.paged_attention import split_workspace
from cmw_rag_tpu_torch.ops.topk import (NEG_INF, PLAIN_CHUNK_ROWS, _check,
                                        _plain_scan)


# ------------------------------------------------------------------- twins


def _block_rows(blocks: torch.Tensor, block_n: int) -> torch.Tensor:
    """Row indices of ``blocks`` (1-D), block by block."""
    off = torch.arange(block_n, device=blocks.device)
    return (blocks.long()[:, None] * block_n + off).reshape(-1)


def _plain_blocks(corpus, scales, ids, queries, blocks, k, block_n):
    """Exact top-k of ``queries`` over the rows of the distinct ``blocks``."""
    n_blocks = corpus.shape[0] // block_n
    blocks = torch.unique(blocks.long())
    blocks = blocks[(blocks >= 0) & (blocks < n_blocks)]
    rows = _block_rows(blocks, block_n)
    q = queries.float()

    def score(a, b):
        r = rows[a:b]
        s = q @ corpus[r].float().T
        return s if scales is None else s * scales[r].float()[None, :]

    return _plain_scan(score, rows.numel(), ids[rows], q.shape[0], k,
                       corpus.device, PLAIN_CHUNK_ROWS)


def ivf_probed_plain(corpus, ids, queries, block_idx, k, block_n=1024,
                     scales=None):
    """Plain twin of ``ivf_probed_scan`` (and, with ``scales``, of
    ``ivf_probed_scan_int8``): → (scores [Q, k] f32, ids [Q, k] i32)."""
    outs = [_plain_blocks(corpus, scales, ids, queries[q : q + 1],
                          block_idx[q], k, block_n)
            for q in range(queries.shape[0])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def ivf_union_plain(corpus, ids, queries, block_list, k, block_n=1024,
                    n_unique=None, scales=None):
    """Plain twin of ``ivf_union_scan`` (and, with ``scales``, of
    ``ivf_union_scan_int8``)."""
    u = block_list.shape[0] if n_unique is None else int(
        n_unique.reshape(-1)[0])
    return _plain_blocks(corpus, scales, ids, queries, block_list[:u], k,
                         block_n)


def ivf_probed_scan_golden(corpus, ids, queries, block_idx, k, block_n=1024,
                           scales=None):
    """The JAX golden: gather the probed blocks [Q, P, block_n, D], score,
    mask, order by id, then a stable top-k (a repeated block repeats its
    rows here, as there)."""
    qn, n_probe = block_idx.shape
    d = corpus.shape[1]
    bidx = block_idx.long()
    sel = corpus.reshape(-1, block_n, d)[bidx].float()   # [Q, P, block_n, D]
    sel_ids = ids.reshape(-1, block_n)[bidx]              # [Q, P, block_n]
    scores = torch.einsum("qd,qpbd->qpb", queries.float(), sel)
    if scales is not None:
        scores = scores * scales.reshape(-1, block_n)[bidx].float()
    scores = torch.where(sel_ids >= 0, scores,
                         torch.full_like(scores, NEG_INF))
    flat_s = scores.reshape(qn, n_probe * block_n)
    flat_i = sel_ids.reshape(qn, n_probe * block_n)
    order = torch.argsort(flat_i, dim=1, stable=True)
    flat_s, flat_i = flat_s.gather(1, order), flat_i.gather(1, order)
    idx = torch.sort(flat_s, dim=1, descending=True, stable=True).indices[:, :k]
    top_s, top_i = flat_s.gather(1, idx), flat_i.gather(1, idx)
    return top_s, torch.where(top_s > NEG_INF / 2, top_i,
                              torch.full_like(top_i, -1)).to(torch.int32)


# ------------------------------------------------------------------ kernel


#: rows of a scan tile (``csrc/ivf_scan.cu`` kRows)
TILE_ROWS = 256
#: candidates a selection CTA takes (the selection's CTAs a query are the
#: candidates over this, at least 2, at most ``SELECT_MAX_CTAS`` and at
#: most two a SM over the queries, so that one launch selects for all)
SELECT_ROWS = 4096
SELECT_MAX_CTAS = 32
#: words of the selection's histograms and counters a query
#: (``select_k.cuh``: 6 passes x 2048 bins, then 2 counters)
SELECT_CLEAR_WORDS = 6 * 2048 + 2
#: queries a scan + selection takes (``csrc/ivf_scan.cu`` kChunk): two
#: groups of 32, which share the rows they read through L2
QUERY_CHUNK = 64


def launch_sizes(nq: int, table_cols: int, block_n: int, k: int,
                 per_query: bool, sms: int,
                 n_blocks: Optional[int] = None) -> dict:
    """What a launch needs from the host, from the table's width alone
    (never from the device's ``n_unique``; ``n_blocks`` given when it
    bounds the entries scanned, as ``n_unique`` does): the entries a query
    the workspace holds (``ws_cols``), the scan's query group (``qg``: 8,
    16 or 32 queries; one a query on the probed route) and groups and CTAs
    a group (one a SM in all, at most one a (entry, tile) item) of a chunk
    of at most ``QUERY_CHUNK`` queries, the selection's CTAs a query, and
    one chunk's workspace: ``floats`` (the candidates' scores [chunk,
    width]) and ``words`` int32 (the candidates' ids [chunk or 1, width],
    the selection's histograms and counters, then its survivors [chunk,
    min(k, width)] u64 from the even word ``surv_at``)."""
    ws_cols = table_cols if n_blocks is None else min(table_cols, n_blocks)
    width = ws_cols * block_n
    chunk = min(nq, QUERY_CHUNK)
    qg = 8 if per_query or nq <= 8 else 16 if nq <= 16 else 32
    groups = chunk if per_query else -(-chunk // qg)
    items = ws_cols * -(-block_n // TILE_ROWS)
    n_ctas = max(1, min(items, -(-sms // groups)))
    sel_ctas = max(2, min(SELECT_MAX_CTAS, -(-width // SELECT_ROWS),
                          2 * sms // chunk))
    surv_stride = min(k, width)
    ids_words = (chunk if per_query else 1) * width
    clear_at = ids_words
    surv_at = clear_at + chunk * SELECT_CLEAR_WORDS
    surv_at += surv_at % 2
    return {"ws_cols": ws_cols, "width": width, "chunk": chunk, "qg": qg,
            "groups": groups, "n_ctas": n_ctas, "sel_ctas": sel_ctas,
            "surv_stride": surv_stride, "floats": chunk * width,
            "clear_at": clear_at,
            "hist_words": chunk * (SELECT_CLEAR_WORDS - 2),
            "surv_at": surv_at, "words": surv_at + 2 * chunk * surv_stride}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("ivf_scan")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        tail = ([p, i, i, i, p, i, i, i, i, i, i, i, i, p, p, p, p, p, i64,
                 p, p, p])
        lib.ivf_scan_bf16.argtypes = [p, p, p] + tail
        lib.ivf_scan_int8.argtypes = [p, p, p, p] + tail
        lib.ivf_scan_encode.argtypes = [p, i, i, i, p]
        lib.ivf_scan_encode_queries.argtypes = [p, i, i, i, p]
        for fn in ("ivf_scan_bf16", "ivf_scan_int8", "ivf_scan_encode",
                   "ivf_scan_encode_queries",
                   "ivf_scan_tile_rows", "ivf_scan_clear_words",
                   "ivf_scan_chunk"):
            getattr(lib, fn).restype = ctypes.c_int
        if (lib.ivf_scan_tile_rows(), lib.ivf_scan_clear_words(),
                lib.ivf_scan_chunk()) != (TILE_ROWS, SELECT_CLEAR_WORDS,
                                          QUERY_CHUNK):
            raise RuntimeError("csrc/ivf_scan.cu and ops/ivf_scan.py "
                               "disagree on the tile, the selection's "
                               "workspace or the query chunk")
        lib._typed = True
    return lib


_MAPS: dict = {}
#: maps kept before the cache starts over (each query batch adds one)
MAPS_KEPT = 1024
_WORKSPACES: dict = {}


def _tensor_map(t: torch.Tensor, qg: int = 0) -> int:
    """Host address of the tensor map of the corpus (``qg`` 0: TMA boxes of
    256 rows x 128 bytes) or of the queries (boxes of ``qg`` rows x 64
    columns): encoded once a tensor, then cached (a map holds the address,
    shape and strides only, so a tensor that takes a freed one's address
    and shape has the same map; the launch copies it, so the cache may
    start over between calls)."""
    key = (t.data_ptr(), tuple(t.shape), t.dtype, qg)
    buf = _MAPS.get(key)
    if buf is None:
        if len(_MAPS) >= MAPS_KEPT:
            _MAPS.clear()
        buf = ctypes.create_string_buffer(128)
        if qg:
            err = _lib().ivf_scan_encode_queries(t.data_ptr(), t.shape[0],
                                                 t.shape[1], qg, buf)
        else:
            err = _lib().ivf_scan_encode(t.data_ptr(),
                                         int(t.dtype == torch.int8),
                                         t.shape[0], t.shape[1], buf)
        if err != 0:
            raise RuntimeError(f"ivf_scan tensor map failed: CUDA error {err}")
        _MAPS[key] = buf
    return ctypes.addressof(buf)


def _launch(fn_name: str, corpus, scales, ids, queries, table, n_valid,
            per_query: bool, k: int, block_n: int):
    if corpus.dim() != 2 or queries.dim() != 2 or table.dim() != 2:
        raise ValueError("corpus, queries and the block table must be 2-D")
    n, d = corpus.shape
    nq = queries.shape[0]
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    step = 16 if scales is not None else 8
    if d % step:
        raise ValueError(f"D={d} must be a multiple of {step}")
    if block_n < 1 or n % block_n or n == 0:
        raise ValueError(f"N={n} must be a positive multiple of block_n={block_n}")
    if nq < 1 or table.shape[1] < 1:
        raise ValueError("empty query batch or block table")
    _check("corpus", corpus, torch.int8 if scales is not None
           else torch.bfloat16, (n, d))
    if scales is not None:
        _check("scales", scales, torch.float32, (n,))
    _check("ids", ids, torch.int32, (n,))
    _check("queries", queries, torch.bfloat16, (nq, d))
    _check("block table", table, torch.int32,
           (nq if per_query else 1, table.shape[1]))
    if n_valid is not None:
        _check("n_unique", n_valid, torch.int32, (1,))
    lib = _lib()
    dev = corpus.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    z = launch_sizes(nq, table.shape[1], block_n, k, per_query, sms,
                     None if n_valid is None else n // block_n)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    extra = () if scales is None else (scales.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        floats, words = split_workspace(
            _WORKSPACES, (dev.index, stream), z["floats"], z["words"],
            lambda m, dtype: torch.zeros((m,), dtype=dtype, device=dev))
        w = words.data_ptr()
        err = getattr(lib, fn_name)(
            _tensor_map(corpus), _tensor_map(queries, z["qg"]), *extra,
            ids.data_ptr(),
            table.data_ptr(), table.shape[1], z["ws_cols"], int(per_query),
            None if n_valid is None else n_valid.data_ptr(), nq, z["qg"],
            n // block_n, d, block_n, k, z["n_ctas"], z["sel_ctas"],
            floats.data_ptr(), w, w + 4 * z["clear_at"],
            w + 4 * (z["clear_at"] + z["hist_words"]), w + 4 * z["surv_at"],
            z["surv_stride"], out_s.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return out_s, out_i


# ---------------------------------------------------------------- wrappers


def ivf_probed_scan(corpus: torch.Tensor, ids: torch.Tensor,
                    queries: torch.Tensor, block_idx: torch.Tensor, k: int,
                    block_n: int = 1024):
    """bf16 corpus [n_blocks * block_n, D], ids [N] int32, queries [Q, D]
    bf16, block_idx [Q, P] int32 → (scores [Q, k] f32, ids [Q, k] int32)."""
    if on_cpu(corpus, ids, queries, block_idx):
        return ivf_probed_plain(corpus, ids, queries, block_idx, k, block_n)
    out = _launch("ivf_scan_bf16", corpus, None, ids, queries, block_idx,
                  None, True, k, block_n)
    ivf_probed_scan.launches += 1
    return out


def ivf_probed_scan_dma(corpus: torch.Tensor, ids: torch.Tensor,
                        queries: torch.Tensor, block_idx: torch.Tensor, k: int,
                        block_n: int = 1024):
    """Alias of ``ivf_probed_scan`` (the TPU's manual-DMA schedule)."""
    if on_cpu(corpus, ids, queries, block_idx):
        return ivf_probed_plain(corpus, ids, queries, block_idx, k, block_n)
    out = _launch("ivf_scan_bf16", corpus, None, ids, queries, block_idx,
                  None, True, k, block_n)
    ivf_probed_scan_dma.launches += 1
    return out


def ivf_probed_scan_int8(corpus: torch.Tensor, scales: torch.Tensor,
                         ids: torch.Tensor, queries: torch.Tensor,
                         block_idx: torch.Tensor, k: int, block_n: int = 1024):
    """int8 corpus [N, D] with f32 row scales [N]; otherwise as
    ``ivf_probed_scan``."""
    if on_cpu(corpus, scales, ids, queries, block_idx):
        return ivf_probed_plain(corpus, ids, queries, block_idx, k, block_n,
                                scales=scales)
    out = _launch("ivf_scan_int8", corpus, scales, ids, queries, block_idx,
                  None, True, k, block_n)
    ivf_probed_scan_int8.launches += 1
    return out


def ivf_union_scan(corpus: torch.Tensor, ids: torch.Tensor,
                   queries: torch.Tensor, block_list: torch.Tensor, k: int,
                   block_n: int = 1024,
                   n_unique: Optional[torch.Tensor] = None):
    """bf16 corpus [N, D], ids [N] int32, queries [Q, D] bf16, block_list
    [U] int32 (entries past ``n_unique``, a [1] int32 tensor that counts
    distinct blocks, at most n_blocks, are skipped)
    → (scores [Q, k] f32, ids [Q, k] int32)."""
    extra = () if n_unique is None else (n_unique,)
    if on_cpu(corpus, ids, queries, block_list, *extra):
        return ivf_union_plain(corpus, ids, queries, block_list, k, block_n,
                               n_unique)
    out = _launch("ivf_scan_bf16", corpus, None, ids, queries,
                  block_list.reshape(1, -1), n_unique, False, k, block_n)
    ivf_union_scan.launches += 1
    return out


def ivf_union_scan_int8(corpus: torch.Tensor, scales: torch.Tensor,
                        ids: torch.Tensor, queries: torch.Tensor,
                        block_list: torch.Tensor, k: int, block_n: int = 1024,
                        n_unique: Optional[torch.Tensor] = None):
    """int8 corpus [N, D] with f32 row scales [N]; otherwise as
    ``ivf_union_scan``."""
    extra = () if n_unique is None else (n_unique,)
    if on_cpu(corpus, scales, ids, queries, block_list, *extra):
        return ivf_union_plain(corpus, ids, queries, block_list, k, block_n,
                               n_unique, scales=scales)
    out = _launch("ivf_scan_int8", corpus, scales, ids, queries,
                  block_list.reshape(1, -1), n_unique, False, k, block_n)
    ivf_union_scan_int8.launches += 1
    return out


ivf_probed_scan.launches = 0
ivf_probed_scan_dma.launches = 0
ivf_probed_scan_int8.launches = 0
ivf_union_scan.launches = 0
ivf_union_scan_int8.launches = 0
