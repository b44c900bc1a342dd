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

On CUDA tensors each wrapper launches ``csrc/ivf_scan.cu`` (one kernel
template over a block table, bf16 and int8 instantiations; then a merge
launch) and adds one to its ``launches`` count; on CPU tensors it runs its
plain twin. Wrong device, dtype, shape or contiguity raises: there is no
fallback. The twins (``*_plain``) gather the rows of the distinct listed
blocks and select with ``ops/topk``'s plain scan. ``ivf_probed_scan_golden``
copies the JAX golden ``ivf_probed_scan_xla`` (:622-645).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cmw_rag_tpu_torch.device import on_cpu
from cmw_rag_tpu_torch.ops import cuda_build
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


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("ivf_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [p, i, i, p, i, i, i, i, i, i, p, p, p, p, p, p, p]
        lib.ivf_scan_bf16.argtypes = [p, p, p] + tail
        lib.ivf_scan_int8.argtypes = [p, p, p, p] + tail
        for fn in ("ivf_scan_bf16", "ivf_scan_int8", "ivf_scan_tile_rows",
                   "ivf_scan_max_ctas", "ivf_scan_max_shared_k"):
            getattr(lib, fn).restype = ctypes.c_int
        lib._typed = True
    return lib


def _launch(fn_name: str, corpus, scales, ids, queries, table, n_valid,
            per_query: bool, k: int, block_n: int):
    if corpus.dim() != 2 or queries.dim() != 2 or table.dim() != 2:
        raise ValueError("corpus, queries and the block table must be 2-D")
    n, d = corpus.shape
    nq = queries.shape[0]
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if d % 8:
        raise ValueError(f"D={d} must be a multiple of 8")
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
    groups = nq if per_query else -(-nq // 32)
    tiles = table.shape[1] * -(-block_n // lib.ivf_scan_tile_rows())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ctas = max(1, min(tiles, -(-2 * sms // groups), lib.ivf_scan_max_ctas()))
    part_s = torch.empty((n_ctas, nq, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_ctas, nq, k), dtype=torch.int32, device=dev)
    alt_s = alt_i = None
    if k > lib.ivf_scan_max_shared_k():
        alt_s, alt_i = torch.empty_like(part_s), torch.empty_like(part_i)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    extra = () if scales is None else (scales.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            queries.data_ptr(), corpus.data_ptr(), *extra, ids.data_ptr(),
            table.data_ptr(), table.shape[1], int(per_query),
            None if n_valid is None else n_valid.data_ptr(), nq,
            n // block_n, d, block_n, k, n_ctas, part_s.data_ptr(),
            part_i.data_ptr(), None if alt_s is None else alt_s.data_ptr(),
            None if alt_i is None else alt_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), stream)
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
    [U] int32 (entries past ``n_unique``, a [1] int32 tensor, are skipped)
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
