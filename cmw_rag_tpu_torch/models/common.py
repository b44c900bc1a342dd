"""Shared model building blocks (port of ``cmw_rag_tpu/models/common.py:58-121``).

Parameters are plain nested dicts of tensors, as in the JAX package, so a
checkpoint's leaf order and every layout carry over unchanged: weight
matrices are ``[in, out]`` and applied as ``x @ w``. Matmul weights are held
in the config dtype (bf16 by default), norm scales in float32. Attention is
plain torch ops, softmax in float32, as the JAX package's XLA attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

Params = dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    d_model: int
    d_ff: int
    num_layers: int
    num_heads: int
    num_kv_heads: int = 0          # 0 → MHA (= num_heads)
    head_dim: int = 0              # 0 → d_model // num_heads
    dtype: torch.dtype = torch.bfloat16

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32)
    return (w / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """T5-style RMSNorm with float32 accumulation, returned in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def make_rope(head_dim: int, max_len: int, theta: float = 1e6,
              device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables [max_len, head_dim//2] (float32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, Dh]; cos/sin: [L, Dh//2]. Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask_bias: torch.Tensor,
              pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, L, Hq, Dh]; k, v: [B, L, Hkv, Dh]; mask_bias [B, 1, Lq, Lk] and
    pos_bias [H, Lq, Lk] additive float32. Products in float32 (bf16 inputs
    multiply exactly), softmax in float32, probabilities cast back to
    q.dtype before the value product. Returns [B, L, Hq, Dh] in q.dtype."""
    hq, dh = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if hq != hkv:  # GQA: repeat kv heads
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(float(dh)))
    if pos_bias is not None:
        scores = scores + pos_bias[None].float()
    scores = scores + mask_bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float())
    return out.to(q.dtype)


def padding_mask_bias(attention_mask: torch.Tensor,
                      causal: bool = False) -> torch.Tensor:
    """[B, L] with 1 = real token → additive bias [B, 1, L, L] float32
    (0 keep / -1e9 drop)."""
    l = attention_mask.shape[1]
    keep = attention_mask[:, None, None, :].float()
    if causal:
        tri = torch.tril(torch.ones((l, l), dtype=torch.float32,
                                    device=attention_mask.device))
        keep = keep * tri[None, None]
    return (keep - 1.0) * 1e9
