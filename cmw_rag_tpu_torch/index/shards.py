"""Segmented index on one device: immutable sealed IVF segments and a
mutable fresh tail (port of ``cmw_rag_tpu/index/shards.py:55-514``).

- **fresh tail**: a ``FlatIndex`` taking upserts (exact scan);
- **sealed segments**: once the tail holds ``seal_threshold`` live rows,
  that many are clustered into an immutable ``IVFIndex`` segment, and the
  overflow carries into a new tail; queries probe segments;
- **pending view**: while a segment is built, its packed rows are served by
  an exact scan top-k over them (``topk_scan_bf16`` / ``topk_scan_int8``),
  so the old tail is released before the build; with
  ``background_seal=True`` the build runs on a worker thread, and a build
  that died is rebuilt by the next seal, ``save``, ``to_host`` or
  ``compact`` (``_drain_pending``);
- **deletes**: tombstones everywhere; deletes that land between the pack
  and the publish of a seal reach the segment when it publishes, and are
  counted exactly once;
- **compaction**: every segment and the tail rebuilt into one segment
  without tombstones, swapped in atomically;
- **durability**: ``save``/``load`` write and read the JAX index's form, a
  manifest plus one npz of float32 live rows and ids per segment and one
  for the tail, so either package loads what the other saved. ``load``
  rebuilds the segments, so it may cluster differently.

Search = exact scan of the tail + pending view + IVF search of each segment
(``nprobe`` blocks), merged on the host by (score descending, then pool
order). The mesh-sharded form is not ported: passing a mesh raises.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.index.flat import FlatIndex
from cmw_rag_tpu_torch.index.ivf import IVFIndex
from cmw_rag_tpu_torch.ops.topk import topk_scan_bf16, topk_scan_int8

log = logging.getLogger(__name__)


def _seal_pack(vecs, ids, scales, *, threshold: int, overflow_keep: int = 0):
    """Live rows to the front on the device (a stable live-first sort),
    split at ``threshold``: ((sealed rows, scales | None, ids), (the next
    ``overflow_keep`` rows, scales | None, ids))."""
    order = torch.argsort((ids < 0).to(torch.int32), stable=True)
    o_head = order[:threshold]
    o_rest = order[threshold : threshold + overflow_keep]

    def take(a, o):
        return None if a is None else a[o]

    return ((take(vecs, o_head), take(scales, o_head), take(ids, o_head)),
            (take(vecs, o_rest), take(scales, o_rest), take(ids, o_rest)))


def _live_rows(seg: IVFIndex):
    """(float32 rows, int32 ids) of a segment's live rows, on the host."""
    keep = seg.ids >= 0
    v = seg.corpus[keep].float()
    if seg.scales is not None:    # int8 rows → dequantised
        v = v * seg.scales[keep][:, None]
    return v.cpu().numpy(), seg.ids[keep].cpu().numpy().astype(np.int32)


class SegmentedIndex:
    def __init__(self, dim: int, block_n: int = 1024,
                 seal_threshold: int = 100_000, fresh_capacity: int = 8192,
                 nprobe: int = 64, mesh=None, quantize: bool = False,
                 background_seal: bool = False,
                 device: str | torch.device = "cuda"):
        """``background_seal=True`` runs each seal's IVF build on a worker
        thread: ``add`` returns once the tail is swapped and the pending
        view published. At most one build is in flight; a seal that comes
        while one runs joins it first."""
        if mesh is not None:
            raise NotImplementedError("the sharded SegmentedIndex is not ported")
        self.dim = dim
        self.block_n = block_n
        # rounded up to the scan tile, as the JAX index does, so that both
        # seal at the same row counts
        tile = min(block_n, 1024)
        self.seal_threshold = -(-seal_threshold // tile) * tile
        self.nprobe = nprobe
        self.quantize = quantize
        self.device = resolve_device(device)
        self._fresh_kwargs = dict(dim=dim, capacity=fresh_capacity,
                                  quantize=quantize, device=self.device)
        self.fresh = FlatIndex(**self._fresh_kwargs)
        self.sealed: list[IVFIndex] = []
        # In-flight seal: the packed (rows, scales | None, ids) being built,
        # served by an exact scan; deletes recorded from pack time on
        # (``_sealing`` is raised under the lock before the tail snapshot is
        # packed) reach the segment when it publishes.
        self._pending: Optional[tuple] = None
        self._pending_deletes: list[int] = []
        self._sealing = False
        # which ids the pending rows hold, and which of them were deleted:
        # exact delete() counts and n_live while a seal is in flight
        self._pending_id_set: set[int] = set()
        self._pending_tombstoned: set[int] = set()
        self._lock = threading.Lock()
        self.background_seal = background_seal
        self._seal_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ mutate
    def add(self, vectors, ids: Optional[np.ndarray] = None) -> np.ndarray:
        used = self.fresh.add(vectors, ids)
        if self.fresh.n_live >= self.seal_threshold:
            self.seal()
        return used

    def delete(self, ids) -> int:
        removed = self.fresh.delete(ids)
        with self._lock:
            if self._sealing or self._pending is not None:
                self._pending_deletes.extend(int(i) for i in ids)
            if self._pending is not None:
                # first-time hits on packed rows only: rows deleted in the
                # pack→publish window were counted by fresh.delete above
                hits = {int(i) for i in np.atleast_1d(np.asarray(ids))
                        if int(i) in self._pending_id_set} \
                    - self._pending_tombstoned
                self._pending_tombstoned |= hits
                removed += len(hits)
        for seg in self.sealed:
            removed += seg.delete(ids)
        return removed

    def seal(self) -> None:
        """Freeze the tail into an immutable IVF segment: ``seal_threshold``
        rows when the tail has that many live rows (the overflow carries
        into the new tail), else every live row."""
        self._drain_pending()
        with self._lock:
            self._sealing = True
            self._pending_deletes = []
            snap = self.fresh._snap
        n_live = snap.n_live
        if n_live == 0:
            with self._lock:
                self._sealing = False
            return
        try:
            self._seal_packed(snap, n_live)
        finally:
            with self._lock:
                self._sealing = False

    def _seal_packed(self, snap, n_live: int) -> None:
        if n_live >= self.seal_threshold:
            t = self.seal_threshold
            count = n_live - t
            okeep = 0 if count == 0 else min(
                int(snap.capacity) - t, -(-count // 2048) * 2048)
            (sv, ssc, si), (ov, osc, oi) = _seal_pack(
                snap.vecs, snap.ids, snap.scales, threshold=t,
                overflow_keep=okeep)
            sealed_rows = t
        else:
            (sv, ssc, si), _ = _seal_pack(
                snap.vecs, snap.ids, snap.scales, threshold=n_live)
            sealed_rows = n_live
            count = 0
            ov = osc = oi = None
        fresh_new = FlatIndex(**self._fresh_kwargs)
        if count > 0:
            hv = ov[:count].float()
            if osc is not None:       # re-quantised by FlatIndex.add
                hv = hv * osc[:count, None]
            fresh_new.add(hv, oi[:count].cpu().numpy().astype(np.int32))
        pend_ids = set(si.cpu().numpy().tolist())
        with self._lock:
            self.fresh = fresh_new
            self._pending = (sv, ssc, si)
            self._pending_id_set = pend_ids
            # window deletes stay recorded for the publish; the packed rows
            # they hit were live in the old tail when counted
            self._pending_tombstoned = {
                i for i in self._pending_deletes if i in pend_ids}
            self._sealing = False
            recorded = list(self._pending_deletes)
        if recorded:
            # window deletes of overflow rows, now in the new tail
            fresh_new.delete(recorded)
        del snap, ov, osc, oi

        if self.background_seal:
            def _worker(sv=sv, ssc=ssc, si=si, rows=sealed_rows):
                try:
                    self._build_and_publish(sv, ssc, si, sealed_rows=rows)
                except Exception:  # noqa: BLE001 — worker thread boundary
                    log.exception("background segment build failed; the "
                                  "pending view serves until the next seal")

            th = threading.Thread(target=_worker, name="segment-seal",
                                  daemon=True)
            self._seal_thread = th
            th.start()
        else:
            self._build_and_publish(sv, ssc, si, sealed_rows=sealed_rows)

    def _build_and_publish(self, sv, ssc, si, *, sealed_rows: int) -> None:
        """IVF-build the packed rows and publish the segment, with the
        deletes that arrived meanwhile. On failure the pending view stays."""
        common = dict(block_n=self.block_n, device=self.device)
        if self.quantize:
            seg = IVFIndex.build_quantized(sv, ssc, si, **common)
        else:
            seg = IVFIndex.build(sv, si, quantize=False, **common)
        with self._lock:
            if self._pending_deletes:
                seg.delete(self._pending_deletes)
            self.sealed = self.sealed + [seg]
            self._pending = None
            self._pending_deletes = []
            self._pending_id_set = set()
            self._pending_tombstoned = set()
        log.info("sealed segment with %d rows (%d segments total)",
                 sealed_rows, len(self.sealed))

    def wait_for_seal(self) -> None:
        """Join any in-flight background segment build."""
        th = self._seal_thread
        if th is not None and th.is_alive():
            th.join()

    def _drain_pending(self) -> None:
        """Join the background build, and rebuild a pending view that a
        dead build left, so that callers start from a published state."""
        self.wait_for_seal()
        with self._lock:
            leftover = self._pending
        if leftover is not None:
            log.warning("previous background seal failed; rebuilding the "
                        "leftover pending segment synchronously")
            self._build_and_publish(*leftover,
                                    sealed_rows=int(leftover[0].shape[0]))

    def compact(self) -> None:
        """Merge every segment and the tail into one segment without
        tombstones; queries use the old lists until the swap."""
        self._drain_pending()
        with self._lock:
            segments = list(self.sealed)
            fresh = self.fresh
        parts_v, parts_i = [], []
        for seg in segments:
            v, i = _live_rows(seg)
            parts_v.append(v)
            parts_i.append(i)
        v, i = fresh.to_host()
        parts_v.append(v[i >= 0])
        parts_i.append(i[i >= 0])
        all_v, all_i = np.concatenate(parts_v), np.concatenate(parts_i)
        if not len(all_i):
            with self._lock:
                self.sealed = []
                self.fresh = FlatIndex(**self._fresh_kwargs)
            return
        merged = IVFIndex.build(all_v, all_i, block_n=self.block_n,
                                quantize=self.quantize, device=self.device)
        with self._lock:
            self.sealed = [merged]
            self.fresh = FlatIndex(**self._fresh_kwargs)
        log.info("compacted %d segments + tail → 1 segment (%d rows)",
                 len(segments), len(all_i))

    # ------------------------------------------------------------- query
    def search(self, queries: np.ndarray, k: int):
        """(scores [Q, k] f32, ids [Q, k] i32); -inf and -1 where fewer
        than k rows are live."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        with self._lock:
            segments = list(self.sealed)
            fresh = self.fresh
            pending = self._pending
            pend_del = set(self._pending_deletes) if pending is not None else ()
        pools_s, pools_i = [], []
        if fresh.n_slots:
            s, i = fresh.search(q, k)
            pools_s.append(s)
            pools_i.append(i)
        if pending is not None:
            s, i = self._search_pending(pending, q, k)
            if pend_del:
                dead = np.isin(i, np.fromiter(pend_del, np.int32))
                s = np.where(dead, -np.inf, s)
                i = np.where(dead, -1, i)
            pools_s.append(s)
            pools_i.append(i)
        for seg in segments:
            s, i = seg.search(q, k, nprobe=self.nprobe)
            pools_s.append(s)
            pools_i.append(i)
        if not pools_s:
            return (np.full((q.shape[0], k), -np.inf, np.float32),
                    np.full((q.shape[0], k), -1, np.int32))
        all_s = np.concatenate(pools_s, axis=1)
        all_i = np.concatenate(pools_i, axis=1)
        all_s = np.where(all_i >= 0, all_s, -np.inf)
        order = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(all_s, order, axis=1),
                np.take_along_axis(all_i, order, axis=1))

    def _search_pending(self, pending, q: np.ndarray, k: int):
        """Exact scan top-k over the packed rows of an in-flight seal."""
        sv, ssc, si = pending
        qq = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        qt = torch.from_numpy(qq).to(self.device, torch.bfloat16)
        k_eff = min(k, sv.shape[0])
        if ssc is not None:
            s, i = topk_scan_int8(sv, ssc, si, qt, k_eff)
        else:
            s, i = topk_scan_bf16(sv, si, qt, k_eff)
        s = s.cpu().numpy().astype(np.float32)
        i = i.cpu().numpy().astype(np.int32)
        if k_eff < k:
            s = np.pad(s, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return s, i

    # ------------------------------------------------------------- state
    @property
    def n_live(self) -> int:
        with self._lock:
            pend = (self._pending[0].shape[0] - len(self._pending_tombstoned)
                    if self._pending is not None else 0)
        return self.fresh.n_live + pend + sum(s.n_live for s in self.sealed)

    def to_host(self):
        """(float32 rows, int32 ids): every segment's live rows, then every
        slot of the tail (tombstones there as id -1)."""
        self._drain_pending()
        parts = [_live_rows(seg) for seg in self.sealed]
        parts.append(self.fresh.to_host())
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    # -------------------------------------------------------- durability
    def save(self, directory: str | Path) -> None:
        self._drain_pending()
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        names = []
        for n, seg in enumerate(self.sealed):
            name = f"segment_{n:04d}.npz"
            v, i = _live_rows(seg)
            np.savez(d / name, vectors=v, ids=i)
            names.append(name)
        fv, fi = self.fresh.to_host()
        np.savez(d / "fresh.npz", vectors=fv[fi >= 0], ids=fi[fi >= 0])
        (d / "manifest.json").write_text(json.dumps({
            "version": 1, "dim": self.dim, "block_n": self.block_n,
            "seal_threshold": self.seal_threshold, "nprobe": self.nprobe,
            "segments": names,
        }), encoding="utf-8")

    @classmethod
    def load(cls, directory: str | Path, **kw) -> "SegmentedIndex":
        d = Path(directory)
        m = json.loads((d / "manifest.json").read_text(encoding="utf-8"))
        idx = cls(dim=m["dim"], block_n=m["block_n"],
                  seal_threshold=m["seal_threshold"], nprobe=m["nprobe"], **kw)
        for name in m["segments"]:
            with np.load(d / name) as npz:
                v, i = npz["vectors"], npz["ids"]
            if len(i):
                idx.sealed.append(IVFIndex.build(
                    v, i, block_n=idx.block_n, quantize=idx.quantize,
                    device=idx.device))
        with np.load(d / "fresh.npz") as npz:
            v, i = npz["vectors"], npz["ids"]
        if len(i):
            idx.fresh.add(v, i)
        return idx
