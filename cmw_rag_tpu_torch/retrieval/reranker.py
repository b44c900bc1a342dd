"""Rerankers: batched (query, document) scoring (port of
``cmw_rag_tpu/retrieval/reranker.py:47-480``).

Two families, as in the JAX package: ``cross_encoder`` (T5 encoder over the
pair, pooled, sigmoid of a linear score head) and ``llm_reranker`` (Qwen3
decoder, softmax over the yes/no logits at the last real token; padded
batches of ``flash_min_seq`` tokens or more that are a multiple of 512 take
the flash attention kernel). ``TorchReranker.rerank`` blends the vector
score with the model score, raw (``s + w·cos``) or in z-space
(``z(cos) + w·z(logit(s))``, plus the structural priors); the ensemble
blends members as z(cos) + Σ wᵢ·z(logit(sᵢ)) plus the priors, with the
population std (``np.std``), as the host ensemble does; the fused
pipeline's in-program blend keeps its own sample std. Metadata boosts
multiply the final score. ``IdentityReranker`` keeps the vector order;
``create_reranker`` falls back to it, with a warning, when a model has no
weights, as the JAX factory does.
"""

from __future__ import annotations

import logging
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
from cmw_rag_tpu_torch.retrieval.priors import apply_structural_priors

log = logging.getLogger(__name__)

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


def apply_metadata_boosts(score: float, metadata: dict[str, Any],
                          boosts: dict[str, float]) -> float:
    """score × (1 + boost) for each matching metadata signal. Recognized
    boost keys: ``has_code``, ``tag:<name>`` (matches the comma-joined tags
    field), ``section:<n>``."""
    factor = 1.0
    for key, boost in boosts.items():
        if key == "has_code" and metadata.get("has_code"):
            factor *= 1.0 + boost
        elif key.startswith("tag:"):
            tags = str(metadata.get("tags", ""))
            if key[4:] in [t.strip() for t in tags.split(",")]:
                factor *= 1.0 + boost
        elif (key.startswith("section:")
              and str(metadata.get("section_index")) == key[8:]):
            factor *= 1.0 + boost
    return score * factor


def _boosted_top(candidates, final, boosts, top_k) -> list[Candidate]:
    out = [Candidate(c.id, c.text, dict(c.metadata),
                     apply_metadata_boosts(float(s), c.metadata, boosts))
           for c, s in zip(candidates, final)]
    out.sort(key=lambda c: -c.score)
    return out[:top_k]


class IdentityReranker:
    """Pass-through: keeps the vector-stage order (boosts still apply)."""

    def __init__(self, boosts: Optional[dict[str, float]] = None):
        self.boosts = boosts or {}

    def rerank(self, query: str, candidates: Sequence[Candidate], top_k: int,
               instruction: str | None = None) -> list[Candidate]:
        return _boosted_top(candidates, [c.score for c in candidates],
                            self.boosts, top_k)


def score_batch(params, cfg, kind: str, pooling: str, yes_no: tuple[int, int],
                ids: torch.Tensor, mask: torch.Tensor,
                use_flash: bool = False) -> torch.Tensor:
    """Model scores in [0, 1] for [B, L] pair tokens: sigmoid of the
    cross-encoder head, or P(yes) from the yes/no logits at the last real
    token of the decoder (its attention through the flash kernel when
    ``use_flash``)."""
    if kind == "llm_reranker":
        hidden = qwen3_hidden_states(params, cfg, ids, mask,
                                     use_flash=use_flash)
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
                 seed: int = 0, boosts: Optional[dict[str, float]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 max_pair_tokens: int = 1024,
                 vocab_size: Optional[int] = None,
                 checkpoint: Optional[str] = None, vector_weight: float = 0.0,
                 blend: str = "raw", ce_weight: float = 0.55,
                 current_version: str = "", prior_version_weight: float = 0.0,
                 prior_language_weight: float = 0.0,
                 device: str | torch.device = "cuda"):
        if spec.kind not in ("cross_encoder", "llm_reranker"):
            raise ValueError(f"unsupported reranker kind: {spec.kind!r}")
        if blend not in ("raw", "z"):
            raise ValueError(f"unknown blend: {blend!r}")
        self.spec = spec
        self.device = resolve_device(device)
        self.boosts = boosts or {}
        self.vector_weight = float(vector_weight)
        self.blend = blend
        self.ce_weight = float(ce_weight)
        # structural priors (retrieval/priors.py), z-blend only
        self.current_version = current_version
        self.prior_version_weight = float(prior_version_weight)
        self.prior_language_weight = float(prior_language_weight)
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
        # long decoder pairs take the flash kernel on a card from this many
        # tokens (the JAX package's TPU threshold); off on the CPU, as the
        # JAX package has it off away from the TPU; T5 keeps plain attention
        self.flash_min_seq = (1024 if spec.kind == "llm_reranker"
                              and self.device.type == "cuda" else 0)

    def uses_flash(self, seq_len: int) -> bool:
        """Whether a padded batch of ``seq_len`` tokens takes the flash
        route (the JAX reranker's rule)."""
        return bool(self.flash_min_seq and seq_len >= self.flash_min_seq
                    and seq_len % 512 == 0)

    @torch.inference_mode()
    def score_tokens(self, ids: torch.Tensor, mask: torch.Tensor,
                     use_flash: bool = False) -> torch.Tensor:
        """Scores for pre-tokenized pairs [B, L] on this reranker's device."""
        return score_batch(self.params, self.cfg, self.spec.kind,
                           self.spec.pooling, self.yes_no, ids, mask,
                           use_flash=use_flash)

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
            scores = self.score_tokens(ids, mask,
                                       use_flash=self.uses_flash(ids.shape[1]))
            out.append(scores[: len(chunk)].float().cpu().numpy())
        return np.concatenate(out)

    def rerank(self, query: str, candidates: Sequence[Candidate], top_k: int,
               instruction: str | None = None) -> list[Candidate]:
        if not candidates:
            return []
        raw = self.score_pairs(query, [c.text for c in candidates], instruction)
        vec = np.asarray([c.score for c in candidates], np.float32)
        if self.blend == "z" and len(candidates) > 1:
            final = ((vec - vec.mean()) / max(float(vec.std()), 1e-6)
                     + self.ce_weight * _zlogit(raw))
            final = apply_structural_priors(
                final, query, candidates, self.current_version,
                self.prior_version_weight, self.prior_language_weight)
        else:  # raw cascade: the model score refines the vector order
            final = raw + self.vector_weight * vec
        return _boosted_top(candidates, final, self.boosts, top_k)

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
                 weights: Optional[Sequence[float]] = None,
                 boosts: Optional[dict[str, float]] = None,
                 current_version: str = "",
                 prior_version_weight: float = 0.0,
                 prior_language_weight: float = 0.0):
        if not members:
            raise ValueError("ensemble needs at least one member")
        self.members = list(members)
        self.weights = ([float(w) for w in weights] if weights is not None
                        else [0.55] * len(self.members))
        if len(self.weights) != len(self.members):
            raise ValueError("one weight per member")
        self.boosts = boosts or {}
        self.blend = "z"
        self.current_version = current_version
        self.prior_version_weight = float(prior_version_weight)
        self.prior_language_weight = float(prior_language_weight)

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
        final = apply_structural_priors(
            final, query, candidates, self.current_version,
            self.prior_version_weight, self.prior_language_weight)
        return _boosted_top(candidates, final, self.boosts, top_k)


def _bundled_checkpoint(slug: str) -> Optional[str]:
    name = _BUNDLED_CHECKPOINTS.get(slug.lower())
    if not name:
        return None
    path = Path(REPO_ROOT) / "checkpoints" / name
    return str(path) if path.is_file() else None


def create_reranker(settings: Optional[Settings] = None, tokenizer=None,
                    boosts: Optional[dict[str, float]] = None, seed: int = 0,
                    params=None, device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.bfloat16):
    """Factory over ``settings.reranker_model`` (the JAX package's policy):
    "identity" (or "", "none") is ``IdentityReranker``; a comma-separated
    list of slugs a z-logit ensemble (the shipping default) whose members
    load ``settings.reranker_checkpoint`` or their bundled checkpoint; one
    slug a ``TorchReranker`` with ``params``, or that checkpoint. A model
    with no weights, or an unknown slug, degrades to ``IdentityReranker``
    with a warning: random rerank weights destroy the vector ranking."""
    settings = settings or Settings()
    slug = settings.reranker_model
    if slug.lower() in ("", "identity", "none"):
        return IdentityReranker(boosts)
    priors = dict(current_version=settings.current_product_version,
                  prior_version_weight=settings.prior_version_weight,
                  prior_language_weight=settings.prior_language_weight)
    if "," in slug:
        try:
            members = []
            for part in (p.strip() for p in slug.split(",") if p.strip()):
                spec = get_reranker(part)
                ckpt = (settings.reranker_checkpoint
                        or _bundled_checkpoint(part))
                if ckpt is None:
                    raise ValueError(f"no checkpoint for ensemble member {part!r}")
                members.append(TorchReranker(
                    spec, tokenizer=tokenizer, seed=seed, checkpoint=ckpt,
                    device=device, dtype=dtype))
            return EnsembleReranker(
                members, weights=[settings.reranker_ce_weight] * len(members),
                boosts=boosts, **priors)
        except (KeyError, ValueError, OSError) as e:
            log.warning("ensemble %r unavailable (%s); identity", slug, e)
            return IdentityReranker(boosts)
    try:
        spec = get_reranker(slug)
        if spec.kind == "identity":
            return IdentityReranker(boosts)
        checkpoint = settings.reranker_checkpoint or _bundled_checkpoint(slug)
        if params is None and checkpoint is None:
            log.warning("reranker %r has no checkpoint: serving the identity "
                        "reranker instead of random weights", slug)
            return IdentityReranker(boosts)
        return TorchReranker(
            spec, tokenizer=tokenizer, boosts=boosts, seed=seed, params=params,
            checkpoint=checkpoint, vector_weight=settings.reranker_vector_weight,
            blend=settings.reranker_blend or "raw",
            ce_weight=settings.reranker_ce_weight, device=device, dtype=dtype,
            **priors)
    except (KeyError, ValueError, OSError) as e:
        log.warning("reranker %r unavailable (%s); falling back to identity",
                    slug, e)
        return IdentityReranker(boosts)
