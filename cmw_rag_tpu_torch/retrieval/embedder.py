"""Embedder: texts → unit vectors (port of ``cmw_rag_tpu/retrieval/embedder.py:50-160, 183-433``).

``TorchEmbedder`` runs a dense tower, T5 (``frida-*``) or Qwen3
(``qwen3-*``: instruction-formatted queries, last-token pooling, and the
flash attention kernel for sequences of ``flash_min_seq`` tokens or more
that are a multiple of 512), and, for hybrid specs
such as ``frida-hybrid``, appends the signed-hash lexical blocks: subword
unigrams, adjacent-subword bigrams and RU-stemmed words. Two forms of the
hash exist, as in the JAX package:

- the host form (``LexicalHasher`` over token-id lists, numpy), used by
  ``embed_queries``/``embed_documents``;
- the in-program form (``lexical_block``, ``bigram_block``) over padded
  token-id tensors, used by the fused pipeline. Buckets and signs are
  computed in int64 and are bit-exact with both JAX forms; weights follow
  ``lexical_block_jit`` (float32 ``log1p``, which XLA and PyTorch round
  differently in the last bit for a few ids).

The transliteration block is not ported (``frida-hybrid`` has none).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from cmw_rag_tpu_torch.config import EmbeddingModelSpec, get_embedding_model
from cmw_rag_tpu_torch.device import REPO_ROOT, resolve_device
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
from cmw_rag_tpu_torch.retrieval.wordhash import WordHasher

_SEQ_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

#: Knuth's multiplicative hash constant and the sign-hash multiplier
_HASH_MULT = 2654435761
_SIGN_MULT = 40503
BIGRAM_MULT = 32003
BIGRAM_MOD = 32749


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class LexicalHasher:
    """Signed feature hashing of token ids → unit vector [dim] (host form):
    rarity-weighted (log1p(id)/log1p(vocab)) term frequency per bucket,
    log1p-dampened, L2-normalised."""

    def __init__(self, dim: int, vocab_size: int = 16512):
        self.dim = dim
        self.vocab_size = vocab_size
        self._rarity_norm = float(np.log1p(max(vocab_size, 2)))

    def vectors(self, token_rows: Sequence[Sequence[int]]) -> np.ndarray:
        out = np.zeros((len(token_rows), self.dim), np.float32)
        for i, row in enumerate(token_rows):
            if not len(row):
                continue
            ids = np.asarray(row, np.uint64)
            buckets = ((ids * np.uint64(_HASH_MULT)) >> np.uint64(16)) \
                % np.uint64(self.dim)
            signs = np.where(((ids * np.uint64(_SIGN_MULT)) >> np.uint64(7))
                             & np.uint64(1), 1.0, -1.0).astype(np.float32)
            wts = (np.log1p(ids.astype(np.float64))
                   / self._rarity_norm).astype(np.float32)
            raw = np.zeros(self.dim, np.float32)
            np.add.at(raw, buckets.astype(np.int64), signs * wts)
            v = np.sign(raw) * np.log1p(np.abs(raw))
            n = np.linalg.norm(v)
            out[i] = v / n if n > 0 else v
        return out


def bigram_ids(rows: Sequence[Sequence[int]]) -> list[list[int]]:
    """Host-side adjacent-pair ids for ``LexicalHasher`` (bigram view)."""
    out: list[list[int]] = []
    for r in rows:
        if len(r) < 2:
            out.append([])
            continue
        a = np.asarray(r, np.int64)
        out.append(((a[:-1] * BIGRAM_MULT + a[1:]) % BIGRAM_MOD).tolist())
    return out


def hash_buckets_signs(ids: torch.Tensor, dim: int):
    """Bucket ``((id * 2654435761) >> 16) % dim`` and sign
    ``((id * 40503) >> 7) & 1 ? +1 : -1`` of each id, in int64: bit-exact
    with the host hasher's uint64 and ``lexical_block_jit``'s int32 forms."""
    x = ids.long()
    buckets = ((x * _HASH_MULT) >> 16) % dim
    signs = torch.where(((x * _SIGN_MULT) >> 7) & 1 == 1, 1.0, -1.0)
    return buckets, signs


def lexical_block(ids: torch.Tensor, mask: torch.Tensor, *, dim: int,
                  vocab_size: int = 16512, skip: int = 0) -> torch.Tensor:
    """In-program form of ``LexicalHasher.vectors`` over [B, L] id/mask
    tensors (port of ``lexical_block_jit``). ``skip`` masks the first tokens.
    Returns [B, dim] float32 unit rows."""
    b, l = ids.shape
    dev = ids.device
    valid = (mask > 0) & (torch.arange(l, device=dev)[None, :] >= skip)
    x = ids.long()
    buckets, signs = hash_buckets_signs(x, dim)
    norm = torch.log1p(torch.tensor(float(max(vocab_size, 2)),
                                    dtype=torch.float64)).float().item()
    wts = torch.log1p(x.float()) / norm
    vals = torch.where(valid, signs * wts, torch.zeros((), device=dev))
    raw = torch.zeros((b, dim), dtype=torch.float32, device=dev)
    raw.scatter_add_(1, buckets, vals.float())
    v = torch.sign(raw) * torch.log1p(raw.abs())
    n = v.norm(dim=1, keepdim=True)
    return torch.where(n > 0, v / n.clamp(min=1e-20), torch.zeros((), device=dev))


def bigram_block(ids: torch.Tensor, mask: torch.Tensor, *, dim: int,
                 skip: int = 0) -> torch.Tensor:
    """In-program form of the bigram view (port of ``bigram_block_jit``):
    pair ids of adjacent valid tokens, hashed like ``lexical_block``."""
    l = ids.shape[1]
    valid = (mask > 0) & (torch.arange(l, device=ids.device)[None, :] >= skip)
    pair_valid = (valid[:, :-1] & valid[:, 1:]).to(torch.int32)
    x = ids.long()
    e = (x[:, :-1] * BIGRAM_MULT + x[:, 1:]) % BIGRAM_MOD
    return lexical_block(e, pair_valid, dim=dim, vocab_size=BIGRAM_MOD)


class TorchEmbedder:
    """In-process embedder for the port's embedding specs."""

    def __init__(self, spec: EmbeddingModelSpec, tokenizer=None, params=None,
                 seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                 vocab_size: Optional[int] = None,
                 checkpoint: Optional[str] = None,
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        if tokenizer is None:
            from cmw_rag_tpu_torch.tokenizer import get_tokenizer

            tokenizer = get_tokenizer()
        self.tokenizer = tokenizer
        vocab = vocab_size or max(spec.vocab_size, tokenizer.n_vocab)
        vocab = -(-vocab // 128) * 128
        if spec.arch == "t5_encoder":
            self.cfg = T5EncoderConfig(
                vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
                num_layers=spec.num_layers, num_heads=spec.num_heads,
                dtype=dtype)
            self._encode_fn, layout_fn, init_fn = (
                t5_encode, t5_layout, init_t5_encoder)
        elif spec.arch == "qwen3":
            self.cfg = Qwen3Config(
                vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
                num_layers=spec.num_layers, num_heads=spec.num_heads,
                num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
                dtype=dtype)
            self._encode_fn, layout_fn, init_fn = (
                qwen3_hidden_states, qwen3_layout, init_qwen3)
        else:
            raise ValueError(f"unknown embedding arch: {spec.arch!r}")
        if checkpoint:
            self.params = load_params_npz(layout_fn(self.cfg), checkpoint,
                                          self.device)
        elif params is not None:
            self.params = params
        else:
            self.params = init_fn(torch.Generator().manual_seed(seed),
                                  self.cfg, self.device)
        # the flash kernel serves the causal Qwen3 towers; T5 keeps plain
        # attention (its relative-position bias). It takes over from this
        # many tokens on a card (the JAX package's TPU threshold) and is off
        # on the CPU, as the JAX package has it off away from the TPU
        self._flash_capable = spec.arch == "qwen3"
        self.flash_min_seq = 1024 if self.device.type == "cuda" else 0

        if getattr(spec, "lexical_translit_dim", 0):
            raise NotImplementedError("the translit block is not ported")
        self._lex = (LexicalHasher(spec.lexical_dim, vocab_size=vocab)
                     if spec.lexical_dim else None)
        self._lex_w = float(spec.lexical_weight or 0.0)
        bi_dim = int(spec.lexical_bigram_dim or 0)
        self._lex_bi = (LexicalHasher(bi_dim, vocab_size=BIGRAM_MOD)
                        if self._lex is not None and bi_dim else None)
        self._lex_bi_w = float(spec.lexical_bigram_weight or 0.0)
        word_dim = int(spec.lexical_word_dim or 0)
        self._lex_word = (WordHasher(word_dim)
                          if self._lex is not None and word_dim else None)
        self._lex_word_w = float(spec.lexical_word_weight or 0.0)

    @property
    def dim(self) -> int:
        return self.spec.dimensions if self.spec.dimensions else self.cfg.d_model

    def embed_query(self, text: str, task: str | None = None) -> np.ndarray:
        return self.embed_queries([text], task)[0]

    def embed_queries(self, texts: Sequence[str],
                      task: str | None = None) -> np.ndarray:
        return self._embed([self.spec.format_query(t, task) for t in texts],
                           raw=texts)

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self._embed([self.spec.format_document(t) for t in texts],
                           raw=texts)

    def tokenize_batch(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize, truncate to the model window, pad to shape buckets:
        → (ids, mask) int32 [B_pad, L_pad]."""
        max_tok = self.spec.max_tokens or self.cfg.vocab_size
        encoded = [self.tokenizer.encode(t)[:max_tok] or [0] for t in texts]
        seq = _bucket(max(len(e) for e in encoded), _SEQ_BUCKETS)
        seq = min(seq, max_tok) if max_tok >= _SEQ_BUCKETS[0] else seq
        bsz = _bucket(len(encoded), _BATCH_BUCKETS)
        ids = np.zeros((bsz, seq), np.int32)
        mask = np.zeros((bsz, seq), np.int32)
        for i, e in enumerate(encoded):
            e = e[:seq]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        mask[len(encoded):, 0] = 1  # padding rows stay well-defined
        return ids, mask

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                use_flash: bool = False) -> torch.Tensor:
        """Dense tower + pooling on [B, L] tensors → [B, d_model] float32."""
        if self._flash_capable and use_flash:
            hidden = self._encode_fn(self.params, self.cfg, ids, mask,
                                     use_flash=True)
        else:
            hidden = self._encode_fn(self.params, self.cfg, ids, mask)
        return pool_hidden(hidden, mask, self.spec.pooling, self.spec.normalize)

    def uses_flash(self, seq_len: int) -> bool:
        """Whether a padded batch of ``seq_len`` tokens takes the flash
        route (the JAX embedder's rule)."""
        return bool(self._flash_capable and self.flash_min_seq
                    and seq_len >= self.flash_min_seq and seq_len % 512 == 0)

    @torch.inference_mode()
    def _embed(self, texts: Sequence[str],
               raw: Optional[Sequence[str]] = None) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out: list[np.ndarray] = []
        max_batch = _BATCH_BUCKETS[-1]
        for start in range(0, len(texts), max_batch):
            chunk = texts[start : start + max_batch]
            ids, mask = self.tokenize_batch(chunk)
            vecs = self.forward(torch.from_numpy(ids).to(self.device),
                                torch.from_numpy(mask).to(self.device),
                                use_flash=self.uses_flash(ids.shape[1]))
            out.append(vecs[: len(chunk)].float().cpu().numpy())
        result = np.concatenate(out, axis=0)
        if self._lex is None:
            return result
        # hash the RAW text: the constant prefixes would only add a shared
        # component to every vector
        raw = list(raw if raw is not None else texts)
        max_tok = self.spec.max_tokens or 512
        rows = [self.tokenizer.encode(t)[: 4 * max_tok] for t in raw]
        lex = self._lex.vectors(rows)
        if self._lex_word is not None or self._lex_bi is not None:
            v = self._lex_bi_w if self._lex_bi is not None else 0.0
            x = self._lex_word_w if self._lex_word is not None else 0.0
            parts = [np.sqrt(max(1.0 - v - x, 0.0)) * lex]
            if self._lex_word is not None:
                parts.append(np.sqrt(x) * self._lex_word.vectors(raw))
            if self._lex_bi is not None:
                parts.append(np.sqrt(v) * self._lex_bi.vectors(bigram_ids(rows)))
            lex = np.concatenate(parts, axis=1)
        w = self._lex_w
        return np.concatenate([np.sqrt(1.0 - w) * result, np.sqrt(w) * lex],
                              axis=1).astype(np.float32)


#: bundled trained checkpoints (``checkpoints/`` at the repo root)
_BUNDLED_CHECKPOINTS = {
    "frida-hybrid": "frida_mini_cl2.npz",
    "frida-mini": "frida_mini_cl2.npz",
}


def _bundled_checkpoint(slug: str) -> Optional[str]:
    name = _BUNDLED_CHECKPOINTS.get(slug.lower())
    if not name:
        return None
    path = Path(REPO_ROOT) / "checkpoints" / name
    return str(path) if path.is_file() else None


def create_embedder(slug: str = "frida-hybrid", tokenizer=None,
                    checkpoint: Optional[str] = None,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> TorchEmbedder:
    """Factory: the spec for ``slug`` with ``checkpoint``, else the bundled
    trained tower for the slug. Raises when neither exists: a tower with
    random weights would serve quietly wrong vectors."""
    ckpt = checkpoint or _bundled_checkpoint(slug)
    if ckpt is None:
        raise ValueError(f"no checkpoint for embedder {slug!r}")
    return TorchEmbedder(get_embedding_model(slug), tokenizer=tokenizer,
                         checkpoint=ckpt, device=device, dtype=dtype)
