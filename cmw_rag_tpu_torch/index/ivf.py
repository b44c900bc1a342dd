"""IVF-partitioned index on one device (port of ``cmw_rag_tpu/index/ivf.py``).

Corpus rows are clustered by spherical k-means (``ops/kmeans.py``), sorted
cluster-contiguously and packed into blocks of ``block_n`` rows; each block's
centroid summarises its live rows. A query scores every block centroid in
float32, keeps its top ``nprobe`` blocks (ties to the lower block index, as
``lax.top_k``) and scans only their rows with the IVF kernel
(``ops/ivf_scan.py``): a batch of more than one query scans the sorted union
of all its queries' blocks once (``ivf_union_scan``), a single query its own
blocks (``ivf_probed_scan``), on the card and on the CPU alike. (The JAX
index runs the golden per query when it has no Pallas kernel to call; its
union route needs ``use_pallas`` or ``interpret``.)

Immutable once built: deletes are tombstones (id -1, masked in the scan);
new rows go to the fresh tail of ``index/shards.SegmentedIndex``. The
constructor takes a built index's arrays, so a JAX index's ``corpus``,
``ids``, ``block_centroids`` and ``scales`` carried over as numpy arrays
become this index unchanged. The mesh-sharded search (JAX ``ivf.py:415-484``)
is not ported: passing a mesh raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.ops.ivf_scan import (
    ivf_probed_scan,
    ivf_probed_scan_int8,
    ivf_union_scan,
    ivf_union_scan_int8,
)
from cmw_rag_tpu_torch.ops.kmeans import kmeans_fit
from cmw_rag_tpu_torch.ops.topk import quantize_rows_int8

ASSIGN_CHUNK = 65536


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def _assign_chunks(rows_f32, n: int, cent: torch.Tensor) -> torch.Tensor:
    """Most similar centroid of each row, ``ASSIGN_CHUNK`` rows at a time;
    ``rows_f32(a, b)`` gives float32 rows a..b."""
    assign = torch.empty((n,), dtype=torch.int64, device=cent.device)
    for a in range(0, n, ASSIGN_CHUNK):
        b = min(a + ASSIGN_CHUNK, n)
        assign[a:b] = torch.argmax(rows_f32(a, b) @ cent.T, dim=1)
    return assign


def _take(x: torch.Tensor, order: torch.Tensor, pad: int, fill):
    """``x[order]`` followed by ``pad`` rows of ``fill``."""
    n = order.numel()
    out = x.new_full((n + pad, *x.shape[1:]), fill)
    out[:n] = x[order]
    return out


def _block_centroids(rows_f32, si: torch.Tensor, n_blocks: int,
                     block_n: int) -> torch.Tensor:
    """Mean of each block's live rows, normalised; ``rows_f32(a, b)`` gives
    the float32 sorted rows of blocks a..b."""
    step = max(1, ASSIGN_CHUNK // block_n)
    out = []
    for a in range(0, n_blocks, step):
        b = min(a + step, n_blocks)
        rows = rows_f32(a, b).reshape(b - a, block_n, -1)
        live = (si[a * block_n : b * block_n] >= 0).float().reshape(
            b - a, block_n)
        sums = torch.einsum("nbd,nb->nd", rows, live)
        out.append(sums / live.sum(dim=1, keepdim=True).clamp(min=1.0))
    return _normalize(torch.cat(out))


def _ivf_prepare(vecs, ids_in, *, nlist, iters, seed, pad, block_n,
                 train_rows=0, init_idx=None):
    """Normalise, k-means (the whole corpus, or a strided sample of
    ``train_rows`` rows and one chunked assignment), stable sort by
    cluster, pad (id -1, zero rows), block centroids over live rows →
    (bf16 rows, ids, centroids). Rows that are already bf16 are normalised
    in float32 and rounded to bf16 again."""
    n, _ = vecs.shape
    n_blocks = (n + pad) // block_n
    vf = _normalize(vecs.float())
    if train_rows and train_rows < n:
        stride = max(1, n // train_rows)
        cent, _ = kmeans_fit(vf[::stride][:train_rows], nlist=nlist,
                             iters=iters, seed=seed, init_idx=init_idx)
        assign = _assign_chunks(lambda a, b: vf[a:b], n, cent)
    else:
        _, assign = kmeans_fit(vf, nlist=nlist, iters=iters, seed=seed,
                               init_idx=init_idx)
    order = torch.argsort(assign, stable=True)
    sv = _take(vf, order, pad, 0.0)
    si = _take(ids_in, order, pad, -1)
    cent = _block_centroids(lambda a, b: sv[a * block_n : b * block_n], si,
                            n_blocks, block_n)
    return sv.to(torch.bfloat16), si, cent


def _ivf_prepare_int8(vecs8, scales, ids_in, *, nlist, iters, seed, pad,
                      block_n, train_rows, init_idx=None):
    """``_ivf_prepare`` for rows already quantised (≈ unit before
    quantisation): the corpus stays int8, k-means fits a strided sample of
    dequantised rows, the assignment and the block centroids dequantise a
    chunk at a time; pad rows get id -1 and scale 0."""
    n, _ = vecs8.shape
    n_blocks = (n + pad) // block_n
    tr = min(train_rows if train_rows else 65536, n)
    stride = max(1, n // tr)
    sample = vecs8[::stride][:tr].float() * scales[::stride][:tr, None]
    cent, _ = kmeans_fit(sample, nlist=nlist, iters=iters, seed=seed,
                         init_idx=init_idx)
    assign = _assign_chunks(
        lambda a, b: vecs8[a:b].float() * scales[a:b, None], n, cent)
    order = torch.argsort(assign, stable=True)
    sv8 = _take(vecs8, order, pad, 0)
    ssc = _take(scales, order, pad, 0.0)          # dead pad rows: scale 0
    si = _take(ids_in, order, pad, -1)
    cent = _block_centroids(
        lambda a, b: (sv8[a * block_n : b * block_n].float()
                      * ssc[a * block_n : b * block_n, None]),
        si, n_blocks, block_n)
    return sv8, ssc, si, cent


def _as_tensor(x, dtype, device) -> torch.Tensor:
    """A tensor or a numpy array (any float dtype, bfloat16 included, goes
    through float32, which holds it exactly) as ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        x = torch.from_numpy(x.astype(np.float32) if x.dtype.kind not in "iub"
                             else np.array(x))
    return x.to(device, dtype)


class IVFIndex:
    def __init__(self, corpus, ids, block_centroids, block_n: int,
                 mesh=None, scales=None, device: str | torch.device = "cuda"):
        """A built index's arrays (tensors or numpy): ``corpus``
        [n_blocks * block_n, D] cluster-sorted, bf16 or (with ``scales``
        [N] f32) int8; ``ids`` [N] int32, -1 for padding and tombstones;
        ``block_centroids`` [n_blocks, D] f32."""
        if mesh is not None:
            raise NotImplementedError("the sharded IVFIndex is not ported")
        self.device = resolve_device(device)
        self.block_n = block_n
        self.scales = None
        if scales is not None:
            self.scales = _as_tensor(scales, torch.float32, self.device)
        self.corpus = _as_tensor(corpus, torch.int8 if scales is not None
                                 else torch.bfloat16, self.device)
        self.ids = _as_tensor(ids, torch.int32, self.device)
        self.block_centroids = _as_tensor(block_centroids, torch.float32,
                                          self.device)
        self.n_blocks = self.block_centroids.shape[0]
        self.dim = self.corpus.shape[1]
        host_ids = self.ids.cpu().numpy()
        live = np.nonzero(host_ids >= 0)[0]
        self._id_to_slot = dict(zip(host_ids[live].tolist(), live.tolist()))

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, vectors, ids: Optional[np.ndarray] = None,
              nlist: Optional[int] = None, block_n: int = 1024,
              kmeans_iters: int = 10, seed: int = 0, quantize: bool = False,
              kmeans_train_rows: Optional[int] = None, mesh=None,
              device: str | torch.device = "cuda",
              init_idx=None) -> "IVFIndex":
        """Build on the device: k-means, cluster sort, padding and block
        centroids. ``vectors`` is numpy or a tensor [n, D]; ``init_idx``
        optionally gives k-means' initial centroid rows (indices into the
        training rows)."""
        if mesh is not None:
            raise NotImplementedError("the sharded IVFIndex is not ported")
        dev = resolve_device(device)
        n, _ = vectors.shape
        vecs = (vectors.to(dev) if isinstance(vectors, torch.Tensor)
                else _as_tensor(vectors, torch.float32, dev))
        if ids is None:
            ids_dev = torch.arange(n, dtype=torch.int32, device=dev)
        else:
            ids_dev = _as_tensor(ids, torch.int32, dev)
        if nlist is None:
            nlist = max(1, n // block_n)
        pad = (-n) % block_n
        if kmeans_train_rows is None:
            kmeans_train_rows = 0 if n <= 65536 else max(65536, 64 * nlist)
        corpus, sorted_ids, cent = _ivf_prepare(
            vecs, ids_dev, nlist=nlist, iters=kmeans_iters, seed=seed,
            pad=pad, block_n=block_n, train_rows=kmeans_train_rows,
            init_idx=init_idx)
        scales = None
        if quantize:
            # block-aligned slabs: float32 temporaries of one slab at a time
            slab = max(block_n, (131072 // block_n) * block_n)
            q8 = torch.empty(corpus.shape, dtype=torch.int8, device=dev)
            scales = torch.empty((corpus.shape[0],), dtype=torch.float32,
                                 device=dev)
            for s0 in range(0, corpus.shape[0], slab):
                q8[s0 : s0 + slab], scales[s0 : s0 + slab] = \
                    quantize_rows_int8(corpus[s0 : s0 + slab])
            corpus = q8
        return cls(corpus=corpus, ids=sorted_ids, block_centroids=cent,
                   block_n=block_n, scales=scales, device=dev)

    @classmethod
    def build_quantized(cls, vecs8, scales, ids, nlist: Optional[int] = None,
                        block_n: int = 1024, kmeans_iters: int = 10,
                        seed: int = 0,
                        kmeans_train_rows: Optional[int] = None,
                        mesh=None, device: str | torch.device = "cuda",
                        init_idx=None) -> "IVFIndex":
        """Build from rows already quantised (int8 [n, D], f32 scales [n],
        ids [n]) without a float32 copy of the whole corpus."""
        if mesh is not None:
            raise NotImplementedError("the sharded IVFIndex is not ported")
        dev = resolve_device(device)
        vecs8 = _as_tensor(vecs8, torch.int8, dev)
        scales = _as_tensor(scales, torch.float32, dev)
        ids_dev = _as_tensor(ids, torch.int32, dev)
        n = vecs8.shape[0]
        if nlist is None:
            nlist = max(1, n // block_n)
        pad = (-n) % block_n
        if kmeans_train_rows is None:
            kmeans_train_rows = min(n, max(65536, 64 * nlist))
        sv8, ssc, si, cent = _ivf_prepare_int8(
            vecs8, scales, ids_dev, nlist=nlist, iters=kmeans_iters,
            seed=seed, pad=pad, block_n=block_n,
            train_rows=kmeans_train_rows, init_idx=init_idx)
        return cls(corpus=sv8, ids=si, block_centroids=cent, block_n=block_n,
                   scales=ssc, device=dev)

    # ------------------------------------------------------------- query
    def probe(self, qt: torch.Tensor, nprobe: int) -> torch.Tensor:
        """[Q, nprobe] int32 blocks of the highest float32 centroid scores
        per query, ties to the lower block index."""
        cscores = qt @ self.block_centroids.T
        order = torch.sort(cscores, dim=1, descending=True, stable=True)
        return order.indices[:, :nprobe].to(torch.int32).contiguous()

    def search(self, queries: np.ndarray, k: int, nprobe: int = 8,
               batch_probe: Optional[bool] = None):
        """(scores [Q, k] f32, ids [Q, k] i32), empty slots (-3e38, -1).
        ``batch_probe`` (default: on for more than one query) scans the
        sorted union of all queries' probed blocks once for the batch; off,
        each query scans its own ``nprobe`` blocks."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        qn = q.shape[0]
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        nprobe = min(nprobe, self.n_blocks)
        qt = torch.from_numpy(q).to(self.device)
        block_idx = self.probe(qt, nprobe)
        qc = qt.to(torch.bfloat16)
        if batch_probe is None:
            batch_probe = qn > 1
        int8 = self.scales is not None
        if batch_probe:
            union, n_uniq = union_blocks(block_idx)
            if int8:
                s, i = ivf_union_scan_int8(self.corpus, self.scales, self.ids,
                                           qc, union, k, self.block_n,
                                           n_unique=n_uniq)
            else:
                s, i = ivf_union_scan(self.corpus, self.ids, qc, union, k,
                                      self.block_n, n_unique=n_uniq)
        elif int8:
            s, i = ivf_probed_scan_int8(self.corpus, self.scales, self.ids,
                                        qc, block_idx, k, self.block_n)
        else:
            s, i = ivf_probed_scan(self.corpus, self.ids, qc, block_idx, k,
                                   self.block_n)
        return (s[:qn].cpu().numpy().astype(np.float32),
                i[:qn].cpu().numpy().astype(np.int32))

    # ----------------------------------------------------------- deletes
    def delete(self, external_ids) -> int:
        slots = [self._id_to_slot.pop(int(i)) for i in external_ids
                 if int(i) in self._id_to_slot]
        if not slots:
            return 0
        ids = self.ids.clone()   # readers of the old array keep theirs
        ids[torch.tensor(slots, dtype=torch.long, device=self.device)] = -1
        self.ids = ids
        return len(slots)

    @property
    def n_live(self) -> int:
        return len(self._id_to_slot)

    # ------------------------------------------------------------- eval
    def recall_at_k(self, queries: np.ndarray, k: int, nprobe: int,
                    exact_ids: np.ndarray) -> float:
        """recall@k against exact top-k ids."""
        _, got = self.search(queries, k, nprobe)
        hits = total = 0
        for row_got, row_exact in zip(got, exact_ids):
            truth = {int(x) for x in row_exact if x >= 0}
            total += len(truth)
            hits += sum(1 for x in row_got if int(x) in truth)
        return hits / max(total, 1)


def union_blocks(block_idx: torch.Tensor):
    """The sorted distinct blocks of ``block_idx`` [Q, P] at the front of a
    [Q * P] int32 list padded with its first entry, and their count as a
    [1] int32 tensor, without a device-to-host copy (``jnp.unique`` with
    ``size`` in JAX)."""
    flat = torch.sort(block_idx.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    m = flat.numel()
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    dest = torch.where(first, pos, torch.full_like(pos, m))
    out = torch.zeros((m + 1,), dtype=flat.dtype, device=flat.device)
    out.scatter_(0, dest, flat)
    n_uniq = first.sum().to(torch.int32).reshape(1)
    slot = torch.arange(m, device=flat.device)
    union = torch.where(slot < n_uniq, out[:m], out[:1].expand(m))
    return union.to(torch.int32).contiguous(), n_uniq
