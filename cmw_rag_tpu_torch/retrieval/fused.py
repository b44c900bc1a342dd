"""Fused retrieval pipeline on one device (port of
``cmw_rag_tpu/retrieval/fused.py:85-533, 672-772``).

The whole query path with no host round trip between stages:

    [B, S, Lq] segment tokens
      → dense tower + pooling, lexical blocks appended   (finish_qvecs)
      → exact scan top-k_retrieve over the corpus         (scan_topk: the
        hand-written CUDA kernels on a card, their plain twins on the CPU)
      → per-query segment merge, dedup by slot, cap C     (merge_segments)
      → gather chunk tokens, assemble (template ⊕ query ⊕ chunk) pairs,
        padding holes moved right by a stable argsort     (assemble_pairs)
      → microbatched rerank forward of every member       (rerank_scores)
      → z-logit blend, final top-k                        (blend_scores)

The corpus stays resident: bf16 rows, or int8 rows with f32 scales when
``quantize=True``. The in-program z-blend divides by the SAMPLE std (n−1),
as the JAX program does; the host ensemble uses the population std.
Tokenization concatenates independently tokenized template, query and chunk
parts, as the JAX program does.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from cmw_rag_tpu_torch.models.pooling import pool_hidden
from cmw_rag_tpu_torch.ops.topk import topk_scan_bf16, topk_scan_int8
from cmw_rag_tpu_torch.retrieval.embedder import bigram_block, lexical_block
from cmw_rag_tpu_torch.retrieval.reranker import score_batch
from cmw_rag_tpu_torch.retrieval.segments import split_query_segments
from cmw_rag_tpu_torch.retrieval.wordhash import WordHasher

_NEG = -1e30
_B_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
_S_BUCKETS = (1, 2, 4)
_LQ_BUCKETS = (32, 64, 128, 256, 512)
_LQR_BUCKETS = (32, 64, 128, 256, 448)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _split_pair_template(spec, instruction: str | None) -> tuple[str, str, str]:
    """(prefix, mid, suffix) text of the pair template around the query and
    document slots."""
    sq, sd = "\x00Q\x00", "\x00D\x00"
    full = spec.format_pair(sq, sd, instruction)
    if full.index(sq) > full.index(sd):
        raise ValueError("pair template must place query before document")
    pre, rest = full.split(sq, 1)
    mid, suf = rest.split(sd, 1)
    return pre, mid, suf


def _top_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` along dim 1: descending, ties keep the lower index."""
    order = torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]
    return x.gather(1, order), order


class FusedPipeline:
    """Embed → scan → merge → rerank on one device. Parameters mirror the
    production retrieval shape (top_k_retrieve=20 per segment, pre-rerank
    cap 60, rerank → top_k=10); ``rerank_keep`` reranks only the first
    columns of the vector-sorted candidates (a cascade)."""

    def __init__(self, embedder, reranker=None, *, top_k_retrieve: int = 20,
                 pre_rerank_limit: int = 60, rerank_keep: Optional[int] = None,
                 top_k: int = 10, max_chunk_tokens: int = 192,
                 rerank_microbatch: int = 32, max_segments: int = 4,
                 segment_tokens: int = 448, segment_overlap: int = 64,
                 quantize: bool = False):
        self.embedder = embedder
        self.device = embedder.device
        self.vector_weight = float(getattr(reranker, "vector_weight", 0.0) or 0.0)
        if reranker is None:
            self._rr_members, self._rr_weights = [], []
        elif getattr(reranker, "members", None) is not None:
            self._rr_members = list(reranker.members)
            self._rr_weights = [float(w) for w in reranker.weights]
        else:
            self._rr_members = [reranker]
            self._rr_weights = [float(getattr(reranker, "ce_weight", 0.55)
                                      or 0.55)]
        for m in self._rr_members:
            if m.device != self.device:
                raise ValueError(f"reranker on {m.device}, embedder on "
                                 f"{self.device}")
        self.rr_blend = (getattr(reranker, "blend", "raw")
                         if reranker is not None else "raw")
        self.top_k_retrieve = int(top_k_retrieve)
        self.pre_rerank_limit = int(pre_rerank_limit)
        self.rerank_keep = int(rerank_keep) if rerank_keep else None
        if self.rerank_keep is not None:
            self.rerank_keep = min(self.rerank_keep, self.pre_rerank_limit)
            if self.rerank_keep < int(top_k):
                raise ValueError("rerank_keep must be >= top_k")
        self.top_k = int(top_k)
        self.max_chunk_tokens = int(max_chunk_tokens)
        self.rerank_microbatch = int(rerank_microbatch)
        self.max_segments = max_segments
        self.segment_tokens = segment_tokens
        self.segment_overlap = segment_overlap
        self.quantize = bool(quantize)

        spec = embedder.spec
        self._lex_dim = int(spec.lexical_dim or 0)
        self._lex_w = float(spec.lexical_weight or 0.0)
        self._lex_vocab = (embedder._lex.vocab_size
                           if embedder._lex is not None else 16512)
        self._bi_dim = int(spec.lexical_bigram_dim or 0)
        self._bi_w = float(spec.lexical_bigram_weight or 0.0)
        self._word_dim = int(spec.lexical_word_dim or 0)
        self._word_w = float(spec.lexical_word_weight or 0.0)

        self._vecs = None          # [N, D] bf16, or (int8 [N, D], f32 [N])
        self._slots = None         # [N] int32 row slots (scan ids)
        self._ext_ids = None       # [N] int32 external ids (-1 = tombstone)
        self._chunk_toks = None    # [N, Lc] int32, 0-padded
        self._chunk_lens = None    # [N] int32
        self._tmpl_cache: dict[Any, tuple[torch.Tensor, ...]] = {}

    # ----------------------------------------------------------- corpus
    def build(self, chunk_texts: Sequence[str], vecs=None, ext_ids=None) -> None:
        """Embed (unless ``vecs`` is given) and tokenize the chunks to
        ``max_chunk_tokens``, then install them."""
        n = len(chunk_texts)
        if vecs is None:
            vecs = self.embedder.embed_documents(chunk_texts)
        if ext_ids is None:
            ext_ids = np.arange(n, dtype=np.int32)
        tok = self.embedder.tokenizer
        lc = self.max_chunk_tokens
        toks = np.zeros((n, lc), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, t in enumerate(chunk_texts):
            e = tok.encode(t)[:lc] or [0]
            toks[i, : len(e)] = e
            lens[i] = len(e)
        self.set_corpus(np.asarray(vecs), np.asarray(ext_ids, np.int32),
                        toks, lens)

    def set_corpus(self, vecs: np.ndarray, ext_ids: np.ndarray,
                   chunk_toks: np.ndarray, chunk_lens: np.ndarray) -> None:
        """Install host corpus arrays. With ``quantize``, rows are
        normalised and stored as symmetric per-row int8 with f32 scales."""
        dev = self.device
        if self.quantize:
            vf = np.asarray(vecs, np.float32)
            vf = vf / np.maximum(np.linalg.norm(vf, axis=1, keepdims=True), 1e-9)
            scale = np.abs(vf).max(axis=1) / 127.0
            q8 = np.clip(np.round(vf / np.maximum(scale[:, None], 1e-12)),
                         -127, 127).astype(np.int8)
            rows = (torch.from_numpy(q8).to(dev),
                    torch.from_numpy(scale.astype(np.float32)).to(dev))
        else:
            rows = torch.from_numpy(np.asarray(vecs, np.float32)).to(
                dev).to(torch.bfloat16)
        self.set_corpus_arrays(
            rows, torch.from_numpy(np.asarray(ext_ids, np.int32)).to(dev),
            torch.from_numpy(np.asarray(chunk_toks, np.int32)).to(dev),
            torch.from_numpy(np.minimum(chunk_lens, self.max_chunk_tokens)
                             .astype(np.int32)).to(dev))

    def set_corpus_arrays(self, vecs, ext_ids: torch.Tensor,
                          chunk_toks: torch.Tensor,
                          chunk_lens: torch.Tensor) -> None:
        """Install corpus tensors that already live on the device. With
        ``quantize``, ``vecs`` is the ``(int8 rows, f32 scales)`` pair (as
        from ``ops.topk.quantize_rows_int8``)."""
        if self.quantize != isinstance(vecs, tuple):
            raise ValueError("vecs form does not match pipeline quantize flag")
        rows = vecs[0] if isinstance(vecs, tuple) else vecs
        for t in (*((vecs,) if not isinstance(vecs, tuple) else vecs),
                  ext_ids, chunk_toks, chunk_lens):
            if t.device != self.device:
                raise ValueError(f"corpus tensor on {t.device}, pipeline on "
                                 f"{self.device}")
        self._vecs = vecs
        self._slots = torch.arange(rows.shape[0], dtype=torch.int32,
                                   device=self.device)
        self._ext_ids = ext_ids
        self._chunk_toks = chunk_toks
        self._chunk_lens = chunk_lens

    # ----------------------------------------------------------- stages
    def finish_qvecs(self, qvecs: torch.Tensor, q_ids: torch.Tensor,
                     q_len: torch.Tensor, q_word: torch.Tensor,
                     n_seg: int) -> torch.Tensor:
        """Append the lexical block (hashed from the raw query tokens, one
        block per query repeated over its segments) to the pooled dense
        segment vectors; bf16 for the scan."""
        if not self._lex_dim:
            return qvecs.to(torch.bfloat16)
        lqr = q_ids.shape[1]
        qmask = (torch.arange(lqr, device=q_ids.device)[None, :]
                 < q_len[:, None]).to(torch.int32)
        lex = lexical_block(q_ids, qmask, dim=self._lex_dim,
                            vocab_size=self._lex_vocab)
        if self._word_dim or self._bi_dim:
            v = self._bi_w if self._bi_dim else 0.0
            x = self._word_w if self._word_dim else 0.0
            parts = [float(np.sqrt(max(1.0 - v - x, 0.0))) * lex]
            if self._word_dim:
                parts.append(float(np.sqrt(x)) * q_word.float())
            if self._bi_dim:
                parts.append(float(np.sqrt(v))
                             * bigram_block(q_ids, qmask, dim=self._bi_dim))
            lex = torch.cat(parts, dim=-1)
        lex = torch.repeat_interleave(lex, n_seg, dim=0)  # [b, dim] → [b*s, dim]
        q = torch.cat([float(np.sqrt(1.0 - self._lex_w)) * qvecs.float(),
                       float(np.sqrt(self._lex_w)) * lex], dim=-1)
        return q.to(torch.bfloat16)

    def scan_topk(self, qvecs: torch.Tensor):
        """Exact top-``top_k_retrieve`` slots for each segment vector."""
        kr = self.top_k_retrieve
        if isinstance(self._vecs, tuple):
            v8, scales = self._vecs
            return topk_scan_int8(v8, scales, self._slots, qvecs, kr)
        return topk_scan_bf16(self._vecs, self._slots, qvecs, kr)

    def merge_segments(self, scores: torch.Tensor, slots: torch.Tensor,
                       seg_valid: torch.Tensor):
        """[B, S, Kr] → per query: dedup by slot keeping the max score,
        tombstones dropped, top ``pre_rerank_limit`` → (scores, slots)."""
        cap = self.pre_rerank_limit
        b = scores.shape[0]
        neg = torch.full((), _NEG, device=scores.device)
        s = torch.where(seg_valid[:, :, None] > 0, scores, neg).reshape(b, -1)
        sl = slots.reshape(b, -1).long()
        s = torch.where(self._ext_ids[sl] >= 0, s, neg)
        # lexsort((-s, sl)): slot ascending, then score descending
        by_score = torch.argsort(-s, dim=1, stable=True)
        by_slot = torch.argsort(sl.gather(1, by_score), dim=1, stable=True)
        order = by_score.gather(1, by_slot)
        s_srt, sl_srt = s.gather(1, order), sl.gather(1, order)
        dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=s.device),
                         sl_srt[:, 1:] == sl_srt[:, :-1]], dim=1)
        s_ded = torch.where(dup, neg, s_srt)
        if s_ded.shape[1] < cap:  # fewer raw candidates than the cap
            pad = cap - s_ded.shape[1]
            s_ded = torch.nn.functional.pad(s_ded, (0, pad), value=_NEG)
            sl_srt = torch.nn.functional.pad(sl_srt, (0, pad))
        cs, ci = _top_stable(s_ded, cap)
        return cs, sl_srt.gather(1, ci)

    @staticmethod
    def assemble_pairs(q_ids, q_len, ctoks, clens, pre, mid, suf):
        """[B, Lqr] query tokens + [B, C, Lc] chunk tokens → [B*C, Lpair]
        pair tokens and mask, padding holes moved right (stable argsort)."""
        b, c, lc = ctoks.shape
        lqr = q_ids.shape[1]
        dev = ctoks.device
        lp = pre.shape[0] + lqr + mid.shape[0] + lc + suf.shape[0]
        lp_pad = -(-lp // 128) * 128

        def const(t):
            return t[None, None, :].expand(b, c, t.shape[0])

        def ones(n):
            return torch.ones((b, c, n), dtype=torch.int32, device=dev)

        q_part = q_ids[:, None, :].expand(b, c, lqr)
        q_mask = (torch.arange(lqr, device=dev)[None, None, :]
                  < q_len[:, None, None]).expand(b, c, lqr)
        c_mask = torch.arange(lc, device=dev)[None, None, :] < clens[:, :, None]
        ids = torch.cat([const(pre), q_part, const(mid), ctoks, const(suf)],
                        dim=-1).reshape(b * c, lp)
        mask = torch.cat([ones(pre.shape[0]), q_mask.to(torch.int32),
                          ones(mid.shape[0]), c_mask.to(torch.int32),
                          ones(suf.shape[0])], dim=-1).reshape(b * c, lp)
        if lp_pad != lp:
            ids = torch.nn.functional.pad(ids, (0, lp_pad - lp))
            mask = torch.nn.functional.pad(mask, (0, lp_pad - lp))
        perm = torch.argsort(1 - mask, dim=-1, stable=True)
        return ids.gather(1, perm), mask.gather(1, perm)

    def rerank_scores(self, pair_ids: torch.Tensor,
                      pair_mask: torch.Tensor) -> torch.Tensor:
        """Microbatched scoring of every member → [M, rows]."""
        mb = self.rerank_microbatch
        rows = pair_ids.shape[0]
        pad = -(-rows // mb) * mb - rows
        if pad:
            pair_ids = torch.nn.functional.pad(pair_ids, (0, 0, 0, pad))
            pair_mask = torch.nn.functional.pad(pair_mask, (0, 0, 0, pad))
            pair_mask[rows:, 0] = 1  # keep poolings well-defined
        out = []
        for m in self._rr_members:
            parts = [score_batch(m.params, m.cfg, m.spec.kind, m.spec.pooling,
                                 m.yes_no, pair_ids[i : i + mb],
                                 pair_mask[i : i + mb])
                     for i in range(0, rows + pad, mb)]
            out.append(torch.cat(parts)[:rows])
        return torch.stack(out)

    def blend_scores(self, rr_raw: torch.Tensor, kcs: torch.Tensor,
                     kvalid: torch.Tensor) -> torch.Tensor:
        """blend='z': z(cos) + Σ wᵢ·z(logit(sᵢ)) over the valid candidates
        (sample std); else the raw cascade of the single member."""
        def z(x):
            x = x.float()
            n = kvalid.sum(1, keepdim=True).clamp(min=1)
            zero = torch.zeros((), device=x.device)
            mu = torch.where(kvalid, x, zero).sum(1, keepdim=True) / n
            var = (torch.where(kvalid, (x - mu) ** 2, zero).sum(1, keepdim=True)
                   / (n - 1).clamp(min=1))
            return (x - mu) / torch.sqrt(var).clamp(min=1e-6)

        if self.rr_blend == "z":
            out = z(kcs)
            for mi, w in enumerate(self._rr_weights):
                p = rr_raw[mi].float().clamp(1e-6, 1 - 1e-6)
                out = out + w * z(torch.log(p / (1 - p)))
            return out
        if self.vector_weight:
            return rr_raw[0] + self.vector_weight * kcs.to(rr_raw.dtype)
        return rr_raw[0]

    # ------------------------------------------------------------- query
    def _template_tokens(self, instruction: str | None):
        key = instruction
        if key not in self._tmpl_cache:
            if not self._rr_members:
                z = torch.zeros((0,), dtype=torch.int32, device=self.device)
                self._tmpl_cache[key] = (z, z, z)
            else:
                tok = self._rr_members[0].tokenizer
                parts = _split_pair_template(self._rr_members[0].spec,
                                             instruction)
                self._tmpl_cache[key] = tuple(
                    torch.tensor(tok.encode(t, allowed_special="all"),
                                 dtype=torch.int32, device=self.device)
                    for t in parts)
        return self._tmpl_cache[key]

    def tokenize_queries(self, texts: Sequence[str], task: str | None = None):
        """Host prep: segment, format, tokenize, pad to shape buckets →
        (seg_ids [B,S,Lq], seg_mask, seg_valid [B,S], q_ids [B,Lqr],
        q_len [B], q_word [B, word_dim] float32) numpy arrays."""
        tok = self.embedder.tokenizer
        spec = self.embedder.spec
        per_query = [split_query_segments(t, tok, self.max_segments,
                                          self.segment_tokens,
                                          self.segment_overlap)
                     for t in texts]
        b = _bucket(len(texts), _B_BUCKETS)
        s = _bucket(max(len(p) for p in per_query), _S_BUCKETS)
        enc = [[tok.encode(spec.format_query(seg, task))
                [: self.segment_tokens + 64] or [0] for seg in p]
               for p in per_query]
        lq = _bucket(max(len(e) for p in enc for e in p), _LQ_BUCKETS)
        seg_ids = np.zeros((b, s, lq), np.int32)
        seg_mask = np.zeros((b, s, lq), np.int32)
        seg_valid = np.zeros((b, s), np.int32)
        for i, p in enumerate(enc):
            for j, e in enumerate(p[:s]):
                e = e[:lq]
                seg_ids[i, j, : len(e)] = e
                seg_mask[i, j, : len(e)] = 1
                seg_valid[i, j] = 1
        seg_mask[:, :, 0] = np.maximum(seg_mask[:, :, 0], 1)

        q_enc = [tok.encode(t)[: _LQR_BUCKETS[-1]] or [0] for t in texts]
        lqr = _bucket(max(len(e) for e in q_enc), _LQR_BUCKETS)
        q_ids = np.zeros((b, lqr), np.int32)
        q_len = np.ones((b,), np.int32)
        for i, e in enumerate(q_enc):
            e = e[:lqr]
            q_ids[i, : len(e)] = e
            q_len[i] = len(e)
        q_word = np.zeros((b, self._word_dim), np.float32)
        if self._word_dim:
            q_word[: len(texts)] = WordHasher(self._word_dim).vectors(texts)
        return seg_ids, seg_mask, seg_valid, q_ids, q_len, q_word

    @torch.inference_mode()
    def query(self, texts: Sequence[str], task: str | None = None,
              instruction: str | None = None):
        """→ dict of numpy arrays for the real batch rows: ``ids`` [B, top_k]
        (−1 = empty), ``rerank_scores``, ``vector_scores``."""
        if self._vecs is None:
            raise RuntimeError("call build()/set_corpus() first")
        dev = self.device
        with record_function("fused.tokenize"):
            arrays = self.tokenize_queries(texts, task)
            seg_ids, seg_mask, seg_valid, q_ids, q_len, q_word = (
                torch.from_numpy(a).to(dev) for a in arrays)
            pre, mid, suf = self._template_tokens(instruction)
        out_ids, rr_s, vec_s = self._run(seg_ids, seg_mask, seg_valid, q_ids,
                                         q_len, q_word, pre, mid, suf)
        nb = len(texts)
        with record_function("fused.fetch"):
            return {"ids": out_ids[:nb].cpu().numpy(),
                    "rerank_scores": rr_s[:nb].float().cpu().numpy(),
                    "vector_scores": vec_s[:nb].float().cpu().numpy()}

    def _run(self, seg_ids, seg_mask, seg_valid, q_ids, q_len, q_word,
             pre, mid, suf):
        emb = self.embedder
        kr, cap, k = self.top_k_retrieve, self.pre_rerank_limit, self.top_k
        keep = self.rerank_keep or cap
        b, s, lq = seg_ids.shape
        flat_ids, flat_mask = seg_ids.reshape(b * s, lq), seg_mask.reshape(b * s, lq)
        with record_function("fused.embed"):
            hidden = emb._encode_fn(emb.params, emb.cfg, flat_ids, flat_mask)
            qvecs = self.finish_qvecs(
                pool_hidden(hidden, flat_mask, emb.spec.pooling,
                            emb.spec.normalize), q_ids, q_len, q_word, s)
        with record_function("fused.scan"):
            scores, slots = self.scan_topk(qvecs)
        with record_function("fused.merge"):
            cs, cslots = self.merge_segments(scores.reshape(b, s, kr),
                                             slots.reshape(b, s, kr), seg_valid)
        valid = cs > _NEG / 2
        minus1 = torch.full((), -1, dtype=self._ext_ids.dtype, device=cs.device)
        if not self._rr_members:
            out_ids = torch.where(valid, self._ext_ids[cslots], minus1)[:, :k]
            return out_ids, cs[:, :k], cs[:, :k]
        kslots, kvalid, kcs = cslots[:, :keep], valid[:, :keep], cs[:, :keep]
        with record_function("fused.assemble"):
            ctoks = self._chunk_toks[kslots]
            clens = torch.where(kvalid, self._chunk_lens[kslots],
                                torch.ones((), dtype=self._chunk_lens.dtype,
                                           device=cs.device))
            pair_ids, pair_mask = self.assemble_pairs(q_ids, q_len, ctoks,
                                                      clens, pre, mid, suf)
        with record_function("fused.rerank"):
            rr_raw = self.rerank_scores(pair_ids, pair_mask).reshape(-1, b, keep)
        with record_function("fused.blend"):
            rr_s = torch.where(kvalid, self.blend_scores(rr_raw, kcs, kvalid),
                               torch.full((), _NEG, device=cs.device))
            top_rr, ti = _top_stable(rr_s, k)
        out_slots = kslots.gather(1, ti)
        out_valid = kvalid.gather(1, ti)
        out_ids = torch.where(out_valid, self._ext_ids[out_slots], minus1)
        vec_s = kcs.gather(1, ti)
        return (out_ids, torch.where(out_valid, top_rr,
                                     torch.full((), _NEG, device=cs.device)),
                vec_s)
