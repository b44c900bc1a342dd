"""Device-resident flat vector index on one device (port of
``cmw_rag_tpu/index/flat.py:117-386``).

The corpus is a ``[capacity, D]`` matrix on the device, bf16 or, with
``quantize=True``, int8 rows with float32 per-row scales; search is the
exact scan top-k (``ops/topk.topk_scan_bf16`` / ``topk_scan_int8``: the
hand-written kernels on a card, their plain twins on the CPU). Rows are
unit-normalised on add. Slots are append-only; deletes are tombstones
(``id = -1``, masked in the scan); capacity grows by doubling, in units of
the JAX index's tile so that both round a capacity alike. Any ``k`` is
taken; slots past ``capacity`` come back as score ``-inf`` and id -1.
External ids must be unique and non-negative.

Readers take the published snapshot (``_Snap``) once and never the lock.
Writers serialise on the lock and publish a new snapshot in one reference
assignment. Unlike the JAX index, which copies every array it changes, an
add writes its rows in place into slots that no published snapshot holds
live (their ids there are -1), and only the ids array is copied before it
changes, so a reader never sees a torn add or delete.

The mesh-sharded search of the JAX index (``flat.py:390-447``) is not
ported: passing a mesh raises.
"""

from __future__ import annotations

import logging
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.ops.topk import (
    quantize_rows_int8,
    topk_scan_bf16,
    topk_scan_int8,
)

log = logging.getLogger(__name__)


class _Snap(NamedTuple):
    """Index state published atomically to readers."""

    vecs: torch.Tensor
    ids: torch.Tensor
    scales: Optional[torch.Tensor]
    n_slots: int
    n_live: int
    capacity: int
    epoch: int


def _tile_rows(dim: int, quantize: bool) -> int:
    """The JAX index's default tile (``flat.py:159-167``): the capacity
    unit, so that both packages round a capacity alike."""
    budget = (4 if dim <= 1536 else 1) * 1024 * 1024
    budget_rows = budget // (dim * (1 if quantize else 2))
    max_tile = 4096 if quantize else 2048
    tile_n = 128
    while tile_n * 2 <= budget_rows and tile_n < max_tile:
        tile_n *= 2
    return tile_n


class FlatIndex:
    """Exact cosine top-k over device-resident vectors."""

    def __init__(self, dim: int, mesh=None, capacity: int = 8192,
                 quantize: bool = False, device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError("the sharded FlatIndex is not ported")
        self.quantize = quantize
        self.dim = dim
        self.dtype = torch.int8 if quantize else torch.bfloat16
        self.device = resolve_device(device)
        unit = _tile_rows(dim, quantize)
        capacity = max(unit, -(-capacity // unit) * unit)
        self._id_to_slot: dict[int, int] = {}   # writer-owned (under _lock)
        self._snap = _Snap(
            vecs=self._alloc_vecs(capacity), ids=self._alloc_ids(capacity),
            scales=self._alloc_scales(capacity) if quantize else None,
            n_slots=0, n_live=0, capacity=capacity, epoch=0)
        self._lock = threading.RLock()

    # snapshot delegation: always the latest published state
    @property
    def n_slots(self) -> int:
        return self._snap.n_slots

    @property
    def n_live(self) -> int:
        return self._snap.n_live

    @property
    def capacity(self) -> int:
        return self._snap.capacity

    @property
    def epoch(self) -> int:
        return self._snap.epoch

    @property
    def vecs(self) -> torch.Tensor:
        """The corpus matrix [capacity, D] (bf16, or int8 rows)."""
        return self._snap.vecs

    @property
    def ids(self) -> torch.Tensor:
        """External ids [capacity] int32; -1 marks free and deleted slots."""
        return self._snap.ids

    @property
    def scales(self) -> Optional[torch.Tensor]:
        """Per-row float32 scales [capacity] of int8 rows; None for bf16."""
        return self._snap.scales

    # ------------------------------------------------------------ storage
    def _alloc_vecs(self, cap: int) -> torch.Tensor:
        return torch.zeros((cap, self.dim), dtype=self.dtype, device=self.device)

    def _alloc_ids(self, cap: int) -> torch.Tensor:
        return torch.full((cap,), -1, dtype=torch.int32, device=self.device)

    def _alloc_scales(self, cap: int) -> torch.Tensor:
        return torch.zeros((cap,), dtype=torch.float32, device=self.device)

    def _grown(self, snap: _Snap, need: int) -> _Snap:
        """A snapshot with capacity ≥ need (doubling), rows copied over."""
        new_cap = snap.capacity
        while new_cap < need:
            new_cap *= 2
        log.info("flat index grow %d → %d slots", snap.capacity, new_cap)
        n = snap.n_slots
        vecs, ids = self._alloc_vecs(new_cap), self._alloc_ids(new_cap)
        vecs[:n] = snap.vecs[:n]
        ids[:n] = snap.ids[:n]
        scales = None
        if self.quantize:
            scales = self._alloc_scales(new_cap)
            scales[:n] = snap.scales[:n]
        return snap._replace(vecs=vecs, ids=ids, scales=scales,
                             capacity=new_cap)

    # ------------------------------------------------------------- public
    def add(self, vectors, ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Append unit-normalised vectors [n, D] (numpy or tensor) under
        external int32 ``ids`` (default: sequential slot numbers). Returns
        the ids used."""
        with self._lock:
            return self._add_locked(vectors, ids)

    def _add_locked(self, vectors, ids):
        snap = self._snap
        if not isinstance(vectors, torch.Tensor):
            vectors = torch.from_numpy(np.asarray(vectors, np.float32))
        vf = vectors.to(self.device, torch.float32)
        if vf.dim() != 2 or vf.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}], got {tuple(vf.shape)}")
        n = int(vf.shape[0])
        if n == 0:
            return np.zeros((0,), np.int32)
        if ids is None:
            ids = np.arange(snap.n_slots, snap.n_slots + n, dtype=np.int32)
        ids = np.asarray(ids, np.int32)
        if ids.shape != (n,):
            raise ValueError("ids must match vectors length")
        if np.any(ids < 0):
            raise ValueError("ids must be non-negative")
        dup = [int(i) for i in ids if int(i) in self._id_to_slot]
        if dup:
            raise ValueError(f"duplicate ids (delete first): {dup[:5]}")
        if len(set(ids.tolist())) != n:
            raise ValueError("duplicate ids within one add")
        if snap.n_slots + n > snap.capacity:
            snap = self._grown(snap, snap.n_slots + n)
        vf = vf / vf.norm(dim=1, keepdim=True).clamp(min=1e-12)
        a, b = snap.n_slots, snap.n_slots + n
        if self.quantize:
            snap.vecs[a:b], snap.scales[a:b] = quantize_rows_int8(vf)
        else:
            snap.vecs[a:b] = vf.to(self.dtype)
        new_ids = snap.ids.clone()  # readers of the old snapshot keep theirs
        new_ids[a:b] = torch.from_numpy(ids).to(self.device)
        for off, ext in enumerate(ids):
            self._id_to_slot[int(ext)] = a + off
        self._snap = snap._replace(ids=new_ids, n_slots=b,
                                   n_live=snap.n_live + n,
                                   epoch=snap.epoch + 1)
        return ids

    def delete(self, ids) -> int:
        """Tombstone rows by external id. Returns the number removed."""
        with self._lock:
            snap = self._snap
            slots = [self._id_to_slot.pop(int(i)) for i in ids
                     if int(i) in self._id_to_slot]
            if not slots:
                return 0
            new_ids = snap.ids.clone()
            new_ids[torch.tensor(slots, dtype=torch.long,
                                 device=self.device)] = -1
            self._snap = snap._replace(ids=new_ids,
                                       n_live=snap.n_live - len(slots),
                                       epoch=snap.epoch + 1)
            return len(slots)

    def search(self, queries: np.ndarray, k: int):
        """Exact cosine top-k: queries [Q, D] → (scores [Q, k] float32,
        ids [Q, k] int32), ordered by (score desc, id asc); -1 (and the
        scan's empty score) where fewer than k rows are live, score -inf
        past ``capacity``. Reads one snapshot; never takes the lock. On
        the card, searches from several threads on one stream launch their
        scans in turn, since they share the stream's scan workspace
        (``ops/ivf_scan.flat_scan``)."""
        snap = self._snap
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qn = queries.shape[0]
        norms = np.linalg.norm(queries, axis=1, keepdims=True)
        queries = queries / np.maximum(norms, 1e-12)
        qt = torch.from_numpy(queries).to(self.device, torch.bfloat16)
        k_eff = min(k, snap.capacity)
        if self.quantize:
            scores, ids = topk_scan_int8(snap.vecs, snap.scales, snap.ids, qt,
                                         k_eff)
        else:
            scores, ids = topk_scan_bf16(snap.vecs, snap.ids, qt, k_eff)
        scores = scores[:qn].float().cpu().numpy()
        ids = ids[:qn].cpu().numpy().astype(np.int32)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)),
                            constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, ids

    # -------------------------------------------------------- persistence
    @classmethod
    def from_host(cls, vectors: np.ndarray, ids: np.ndarray,
                  **kw) -> "FlatIndex":
        """An index of the live rows (``ids >= 0``) of a ``to_host`` dump;
        ``kw`` goes to the constructor (capacity defaults to the dump's
        length)."""
        kw.setdefault("capacity", max(len(ids), 1))
        idx = cls(dim=vectors.shape[1], **kw)
        live = ids >= 0
        if live.any():
            idx.add(vectors[live], ids[live])
        return idx

    def to_host(self) -> tuple[np.ndarray, np.ndarray]:
        """(vectors f32 [n_slots, D], ids i32 [n_slots]), live and
        tombstoned; quantized rows come back dequantized."""
        snap = self._snap
        vecs = snap.vecs[: snap.n_slots].float()
        if self.quantize:
            vecs = vecs * snap.scales[: snap.n_slots][:, None]
        return (vecs.cpu().numpy(),
                snap.ids[: snap.n_slots].cpu().numpy().astype(np.int32))
