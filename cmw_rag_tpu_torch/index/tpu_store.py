"""Device-backed vector store: ``FlatIndex`` on the device, metadata on the
host (port of ``cmw_rag_tpu/index/tpu_store.py``).

Add / cosine top-k search / metadata-filter get / delete-where / count,
keyed by string chunk ids; strings, texts and metadata stay on the host and
the device sees int32 row ids. ``save(dir)``/``load(dir)`` keep the JAX
store's on-disk form, ``vectors.npz`` (float32 vectors and int32 ids, live
and tombstoned) plus ``meta.json`` (dim, next id, live rows), so an index
saved by either package loads in the other; ``load`` builds a flat store,
as the JAX store's does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from cmw_rag_tpu_torch.index.flat import FlatIndex
from cmw_rag_tpu_torch.index.shards import SegmentedIndex
from cmw_rag_tpu_torch.index.store import RetrievedDoc, _matches


class TorchVectorStore:
    """``kind``: "flat" (an exact ``FlatIndex``) or "segmented" (sealed IVF
    segments and a fresh tail, ``SegmentedIndex``), on one device;
    ``index_kwargs`` go to the index."""

    def __init__(self, dim: int, mesh=None, kind: str = "flat",
                 **index_kwargs):
        self.dim = dim
        self.kind = kind
        if kind == "flat":
            self.index = FlatIndex(dim=dim, mesh=mesh, **index_kwargs)
        elif kind == "segmented":
            self.index = SegmentedIndex(dim=dim, mesh=mesh, **index_kwargs)
        else:
            raise ValueError(f"unknown index kind: {kind!r}")
        self._next_int = 0
        self._by_int: dict[int, tuple[str, str, dict[str, Any]]] = {}
        self._int_by_sid: dict[str, int] = {}

    # ----------------------------------------------------------- mutation
    def add(self, texts: Sequence[str], metadatas: Sequence[dict[str, Any]],
            ids: Sequence[str], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, np.float32)
        if not (len(texts) == len(metadatas) == len(ids) == embeddings.shape[0]):
            raise ValueError("texts/metadatas/ids/embeddings length mismatch")
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(f"embeddings must be [n, {self.dim}]")
        stale = [sid for sid in ids if sid in self._int_by_sid]  # upsert
        if stale:
            self._delete_sids(stale)
        int_ids = np.arange(self._next_int, self._next_int + len(ids),
                            dtype=np.int32)
        self._next_int += len(ids)
        self.index.add(embeddings, int_ids)
        for i, sid in enumerate(ids):
            self._by_int[int(int_ids[i])] = (sid, texts[i], dict(metadatas[i]))
            self._int_by_sid[sid] = int(int_ids[i])

    def _delete_sids(self, sids: Sequence[str]) -> int:
        ints = [self._int_by_sid[s] for s in sids if s in self._int_by_sid]
        removed = self.index.delete(ints)
        for i in ints:
            sid, _, _ = self._by_int.pop(i)
            self._int_by_sid.pop(sid, None)
        return removed

    def delete_where(self, where: dict[str, Any]) -> int:
        sids = [sid for _, (sid, _, m) in self._by_int.items()
                if _matches(m, where)]
        return self._delete_sids(sids)

    # -------------------------------------------------------------- reads
    def search(self, query_embeddings: np.ndarray,
               k: int) -> list[list[RetrievedDoc]]:
        q = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        scores, int_ids = self.index.search(q, k)
        out: list[list[RetrievedDoc]] = []
        for row_s, row_i in zip(scores, int_ids):
            docs = []
            for s, i in zip(row_s, row_i):
                if i < 0:
                    continue
                sid, text, meta = self._by_int[int(i)]
                docs.append(RetrievedDoc(id=sid, text=text,
                                         metadata=dict(meta), score=float(s)))
            out.append(docs)
        return out

    def get_any_doc_meta(self, where: dict[str, Any]) -> Optional[dict[str, Any]]:
        for _, (_, _, meta) in self._by_int.items():
            if _matches(meta, where):
                return dict(meta)
        return None

    def get_where(self, where: dict[str, Any], limit: int = 1000,
                  offset: int = 0):
        hits = [(sid, dict(meta)) for _, (sid, _, meta) in self._by_int.items()
                if _matches(meta, where)]
        return hits[offset : offset + limit]

    def get_by_id(self, sid: str) -> Optional[RetrievedDoc]:
        i = self._int_by_sid.get(sid)
        if i is None:
            return None
        _, text, meta = self._by_int[i]
        return RetrievedDoc(id=sid, text=text, metadata=dict(meta), score=0.0)

    def count(self) -> int:
        return len(self._by_int)

    # -------------------------------------------------------- persistence
    def save(self, directory: str | Path) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        vecs, int_ids = self.index.to_host()
        np.savez(d / "vectors.npz", vectors=vecs, ids=int_ids)
        rows = {str(i): {"sid": sid, "text": text, "meta": meta}
                for i, (sid, text, meta) in self._by_int.items()}
        (d / "meta.json").write_text(
            json.dumps({"dim": self.dim, "next_int": self._next_int,
                        "rows": rows}), encoding="utf-8")

    @classmethod
    def load(cls, directory: str | Path, mesh=None,
             **flat_kwargs) -> "TorchVectorStore":
        d = Path(directory)
        payload = json.loads((d / "meta.json").read_text(encoding="utf-8"))
        with np.load(d / "vectors.npz") as npz:
            vecs, int_ids = npz["vectors"], npz["ids"]
        store = cls(dim=payload["dim"], mesh=mesh, **flat_kwargs)
        store._next_int = payload["next_int"]
        live_ints = {int(i) for i in payload["rows"]}
        keep = np.array([i >= 0 and int(i) in live_ints for i in int_ids], bool)
        if keep.any():
            store.index.add(vecs[keep], int_ids[keep])
        for i_str, row in payload["rows"].items():
            i = int(i_str)
            store._by_int[i] = (row["sid"], row["text"], row["meta"])
            store._int_by_sid[row["sid"]] = i
        return store
