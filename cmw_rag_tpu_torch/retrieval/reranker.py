"""Rerankers: batched (query, document) scoring (port of
``cmw_rag_tpu/retrieval/reranker.py:97-320, 323-433``).

Two families, as in the JAX package: ``cross_encoder`` (T5 encoder over the
pair, pooled, sigmoid of a linear score head) and ``llm_reranker`` (Qwen3
decoder, softmax over the yes/no logits at the last real token). The
ensemble blends members as z(cos) + Σ wᵢ·z(logit(sᵢ)) with the population
std (``np.std``), as the host ensemble does; the fused pipeline's in-program
blend keeps its own sample std.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np
import torch

from cmw_rag_tpu_torch.config import RerankerModelSpec, Settings, get_reranker
from cmw_rag_tpu_torch.device import REPO_ROOT, resolve_device
from cmw_rag_tpu_torch.models.common import dense_init
from cmw_rag_tpu_torch.models.pooling import pool_hidden
from cmw_rag_tpu_torch.models.qwen3 import (
    Qwen3Config,
    init_qwen3,
    qwen3_hidden_states,
    qwen3_layout,
)
from cmw_rag_tpu_torch.models.t5_encoder import (
    T5EncoderConfig,
    init_t5_encoder,
    t5_encode,
    t5_layout,
)
from cmw_rag_tpu_torch.models.weights import load_params_npz

_SEQ_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class Candidate:
    """A chunk entering rerank."""

    id: Any
    text: str
    metadata: dict[str, Any] = field(default_factory=dict)
    score: float = 0.0          # vector-stage score in, rerank score out


def score_batch(params, cfg, kind: str, pooling: str, yes_no: tuple[int, int],
                ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Model scores in [0, 1] for [B, L] pair tokens: sigmoid of the
    cross-encoder head, or P(yes) from the yes/no logits at the last real
    token of the decoder."""
    if kind == "llm_reranker":
        hidden = qwen3_hidden_states(params, cfg, ids, mask)
        last = (mask.sum(dim=1) - 1).clamp(min=0).long()
        h = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
        no_id, yes_id = yes_no[1], yes_no[0]
        head = params["embed"][[no_id, yes_id]]          # [2, D]
        logits = h.float() @ head.float().T              # [B, (no, yes)]
        return torch.softmax(logits, dim=1)[:, 1]
    hidden = t5_encode(params, cfg, ids, mask)
    pooled = pool_hidden(hidden, mask, pooling, normalize=False)
    return torch.sigmoid((pooled @ params["score_head"].float())[:, 0])


class TorchReranker:
    """Batched scorer for both reranker families."""

    def __init__(self, spec: RerankerModelSpec, tokenizer=None, params=None,
                 seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 max_pair_tokens: int = 1024,
                 vocab_size: Optional[int] = None,
                 checkpoint: Optional[str] = None, vector_weight: float = 0.0,
                 blend: str = "raw", ce_weight: float = 0.55,
                 device: str | torch.device = "cuda"):
        if spec.kind not in ("cross_encoder", "llm_reranker"):
            raise ValueError(f"unsupported reranker kind: {spec.kind!r}")
        if blend not in ("raw", "z"):
            raise ValueError(f"unknown blend: {blend!r}")
        self.spec = spec
        self.device = resolve_device(device)
        self.vector_weight = float(vector_weight)
        self.blend = blend
        self.ce_weight = float(ce_weight)
        if tokenizer is None:
            from cmw_rag_tpu_torch.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        self.max_pair_tokens = min(max_pair_tokens, spec.max_tokens)
        vocab = vocab_size or max(spec.vocab_size, tokenizer.n_vocab)
        vocab = -(-vocab // 128) * 128
        gen = torch.Generator().manual_seed(seed)
        if spec.kind == "llm_reranker":
            self.cfg = Qwen3Config(
                vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
                num_layers=spec.num_layers, num_heads=spec.num_heads,
                num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
                dtype=dtype)
            layout = qwen3_layout(self.cfg)
            self.yes_no = (int(tokenizer.encode(spec.yes_token)[0]),
                           int(tokenizer.encode(spec.no_token)[0]))
        else:
            self.cfg = T5EncoderConfig(
                vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
                num_layers=spec.num_layers, num_heads=spec.num_heads,
                dtype=dtype)
            layout = t5_layout(self.cfg, score_head=True)
            self.yes_no = (0, 0)
        if checkpoint:
            self.params = load_params_npz(layout, checkpoint, self.device)
        elif params is not None:
            self.params = params
        elif spec.kind == "llm_reranker":
            self.params = init_qwen3(gen, self.cfg, self.device)
        else:
            self.params = init_t5_encoder(gen, self.cfg, self.device)
            self.params["score_head"] = dense_init(
                gen, self.cfg.d_model, 1, torch.float32).to(self.device)

    @torch.inference_mode()
    def score_tokens(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Scores for pre-tokenized pairs [B, L] on this reranker's device."""
        return score_batch(self.params, self.cfg, self.spec.kind,
                           self.spec.pooling, self.yes_no, ids, mask)

    def score_pairs(self, query: str, documents: Sequence[str],
                    instruction: str | None = None) -> np.ndarray:
        """Model scores in [0, 1] for each (query, document) pair."""
        if not documents:
            return np.zeros((0,), np.float32)
        if self.spec.kind == "llm_reranker":
            # truncate the DOCUMENT, never the prompt: the score is read at
            # the template's last token
            overhead = len(self.tokenizer.encode(
                self.spec.format_pair(query, "", instruction)))
            budget = max(self.max_pair_tokens - overhead, 8)
            docs = []
            for d in documents:
                d_ids = self.tokenizer.encode(d)
                docs.append(self.tokenizer.decode(d_ids[:budget])
                            if len(d_ids) > budget else d)
        else:
            docs = list(documents)
        texts = [self.spec.format_pair(query, d, instruction) for d in docs]
        out: list[np.ndarray] = []
        max_batch = _BATCH_BUCKETS[-1]
        for start in range(0, len(texts), max_batch):
            chunk = texts[start : start + max_batch]
            ids, mask = self._tokenize(chunk)
            scores = self.score_tokens(ids, mask)
            out.append(scores[: len(chunk)].float().cpu().numpy())
        return np.concatenate(out)

    def _tokenize(self, texts: Sequence[str]):
        encoded = [self.tokenizer.encode(t, allowed_special="all")
                   [: self.max_pair_tokens] or [0] for t in texts]
        seq = _bucket(max(len(e) for e in encoded), _SEQ_BUCKETS)
        bsz = _bucket(len(encoded), _BATCH_BUCKETS)
        ids = np.zeros((bsz, seq), np.int32)
        mask = np.zeros((bsz, seq), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e[:seq]
            mask[i, : len(e)] = 1
        mask[len(encoded):, 0] = 1
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))


def _ranked(candidates, final, top_k) -> list[Candidate]:
    out = [Candidate(c.id, c.text, dict(c.metadata), float(s))
           for c, s in zip(candidates, final)]
    out.sort(key=lambda c: -c.score)
    return out[:top_k]


#: bundled trained checkpoints (``checkpoints/`` at the repo root)
_BUNDLED_CHECKPOINTS = {
    "cross-encoder-micro": "reranker_hn2_kb.npz",
    "cross-encoder-small": "reranker_small_hn2.npz",
    "cross-encoder-micro-r3": "reranker_hn_kb.npz",
    "cross-encoder-small-r3": "reranker_small_hn.npz",
    "qwen3-reranker-micro": "llm_reranker_micro.npz",
}


def _zlogit(scores: np.ndarray) -> np.ndarray:
    """z-normalise model scores in logit space over one candidate set."""
    p = np.clip(np.asarray(scores, np.float64), 1e-6, 1.0 - 1e-6)
    lg = np.log(p / (1.0 - p))
    return ((lg - lg.mean()) / max(float(lg.std()), 1e-6)).astype(np.float32)


class EnsembleReranker:
    """Weighted z-logit ensemble: final = z(cos) + Σ wᵢ·z(logit(sᵢ))."""

    def __init__(self, members: Sequence[TorchReranker],
                 weights: Optional[Sequence[float]] = None):
        if not members:
            raise ValueError("ensemble needs at least one member")
        self.members = list(members)
        self.weights = ([float(w) for w in weights] if weights is not None
                        else [0.55] * len(self.members))
        if len(self.weights) != len(self.members):
            raise ValueError("one weight per member")
        self.blend = "z"

    def score_pairs(self, query: str, documents: Sequence[str],
                    instruction: str | None = None) -> np.ndarray:
        """Weight-normalised mean of member scores in [0, 1]."""
        if not documents:
            return np.zeros((0,), np.float32)
        total = sum(self.weights) or 1.0
        out = np.zeros((len(documents),), np.float32)
        for w, m in zip(self.weights, self.members):
            out += (w / total) * m.score_pairs(query, documents, instruction)
        return out

    def rerank(self, query: str, candidates: Sequence[Candidate], top_k: int,
               instruction: str | None = None) -> list[Candidate]:
        if not candidates:
            return []
        if len(candidates) == 1:
            return list(candidates)[:top_k]
        docs = [c.text for c in candidates]
        vec = np.asarray([c.score for c in candidates], np.float32)
        final = (vec - vec.mean()) / max(float(vec.std()), 1e-6)
        for w, m in zip(self.weights, self.members):
            final = final + w * _zlogit(m.score_pairs(query, docs, instruction))
        return _ranked(candidates, final, top_k)


def _bundled_checkpoint(slug: str) -> Optional[str]:
    name = _BUNDLED_CHECKPOINTS.get(slug.lower())
    if not name:
        return None
    path = Path(REPO_ROOT) / "checkpoints" / name
    return str(path) if path.is_file() else None


def create_reranker(settings: Optional[Settings] = None, tokenizer=None,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.bfloat16):
    """Factory over ``settings.reranker_model``: a comma-separated list of
    slugs is a z-logit ensemble (the shipping default), one slug a single
    ``TorchReranker``. Every member loads its bundled checkpoint; a slug
    with none raises (random rerank weights destroy the vector ranking)."""
    settings = settings or Settings()
    slugs = [p.strip() for p in settings.reranker_model.split(",") if p.strip()]
    if not slugs:
        raise ValueError("no reranker configured")
    members = []
    for slug in slugs:
        ckpt = _bundled_checkpoint(slug)
        if ckpt is None:
            raise ValueError(f"no bundled checkpoint for reranker {slug!r}")
        members.append(TorchReranker(
            get_reranker(slug), tokenizer=tokenizer, checkpoint=ckpt, device=device, dtype=dtype,
            vector_weight=settings.reranker_vector_weight,
            blend=settings.reranker_blend,
            ce_weight=settings.reranker_ce_weight))
    if len(members) == 1:
        return members[0]
    return EnsembleReranker(members,
                            weights=[settings.reranker_ce_weight] * len(members))
