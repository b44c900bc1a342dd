"""T5 encoder stack (port of ``cmw_rag_tpu/models/t5_encoder.py:53-131``).

Pre-norm RMSNorm, a relative position bias computed once and shared by every
layer, gated-GELU FFN with the tanh approximation, no absolute positions.
Q is multiplied by sqrt(dh) before the shared ``attention``, which divides
by it again: T5 does not scale its logits, and the two roundings are kept
as the JAX package has them.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from cmw_rag_tpu_torch.models.common import (
    ModelConfig,
    Params,
    attention,
    dense_init,
    embed_init,
    padding_mask_bias,
    rms_norm,
)
from cmw_rag_tpu_torch.models.weights import Leaf, tree_map


@dataclass(frozen=True)
class T5EncoderConfig(ModelConfig):
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucketing, float32 on the CPU as the JAX package
    computes it: half the buckets per sign, half of each exact and half
    log-spaced. ``int(log(...))`` truncates, so the float32 steps are kept
    op for op; the bucket table is held equal to JAX's in the tests."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32))
    log_ratio = torch.log(n.float() / max_exact + 1e-6) / denom
    large = max_exact + (log_ratio * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


@functools.lru_cache(maxsize=32)
def _bucket_table(length: int, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """[L, L] int64 buckets, built on the CPU (a device ``log`` may round
    differently at a bucket boundary) and cached per length. Built outside
    inference mode: the cached table also indexes the bias in training,
    where autograd cannot save an inference tensor."""
    with torch.inference_mode(False):
        pos = torch.arange(length)
        rel = pos[None, :] - pos[:, None]  # key - query
        return _relative_position_bucket(rel, num_buckets, max_distance).long()


def _rel_pos_bias(params: Params, cfg: T5EncoderConfig,
                  length: int) -> torch.Tensor:
    """[H, L, L] additive bias, shared by every layer."""
    buckets = _bucket_table(length, cfg.rel_pos_buckets,
                            cfg.rel_pos_max_distance)
    bias = params["rel_bias"][buckets.to(params["rel_bias"].device)]
    return bias.permute(2, 0, 1)


def t5_layout(cfg: T5EncoderConfig, score_head: bool = False) -> Params:
    """Shapes and dtypes of the parameter tree (checkpoint loading)."""
    d, h, dh, ff = cfg.d_model, cfg.num_heads, cfg.hd, cfg.d_ff
    f32, w = torch.float32, cfg.dtype
    layer = {
        "attn_norm": Leaf((d,), f32), "wq": Leaf((d, h * dh), w),
        "wk": Leaf((d, h * dh), w), "wv": Leaf((d, h * dh), w),
        "wo": Leaf((h * dh, d), w), "ffn_norm": Leaf((d,), f32),
        "wi_gelu": Leaf((d, ff), w), "wi_lin": Leaf((d, ff), w),
        "wo_ff": Leaf((ff, d), w),
    }
    out: Params = {
        "embed": Leaf((cfg.vocab_size, d), w),
        "rel_bias": Leaf((cfg.rel_pos_buckets, h), f32),
        "final_norm": Leaf((d,), f32),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if score_head:
        out["score_head"] = Leaf((d, 1), f32)
    return out


def init_t5_encoder(gen: torch.Generator, cfg: T5EncoderConfig,
                    device="cpu") -> Params:
    """Random parameters drawn from ``gen`` (a CPU generator)."""
    d, h, dh, ff = cfg.d_model, cfg.num_heads, cfg.hd, cfg.d_ff
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, cfg.dtype),
        "rel_bias": torch.randn((cfg.rel_pos_buckets, h), generator=gen) * 0.02,
        "final_norm": torch.ones((d,)),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": torch.ones((d,)),
            "wq": dense_init(gen, d, h * dh, cfg.dtype),
            "wk": dense_init(gen, d, h * dh, cfg.dtype),
            "wv": dense_init(gen, d, h * dh, cfg.dtype),
            "wo": dense_init(gen, h * dh, d, cfg.dtype),
            "ffn_norm": torch.ones((d,)),
            "wi_gelu": dense_init(gen, d, ff, cfg.dtype),
            "wi_lin": dense_init(gen, d, ff, cfg.dtype),
            "wo_ff": dense_init(gen, ff, d, cfg.dtype),
        })
    return tree_map(lambda t: t.to(device), params)


def t5_encode(params: Params, cfg: T5EncoderConfig, input_ids: torch.Tensor,
              attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids/attention_mask: [B, L] int → hidden states [B, L, D] in
    cfg.dtype."""
    b, l = input_ids.shape
    h, dh = cfg.num_heads, cfg.hd
    x = params["embed"][input_ids.long()]
    mask_bias = padding_mask_bias(attention_mask, causal=False)
    pos_bias = _rel_pos_bias(params, cfg, l)
    q_scale = torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype)

    for layer in params["layers"]:
        y = rms_norm(x, layer["attn_norm"])
        q = (y @ layer["wq"]).reshape(b, l, h, dh)
        k = (y @ layer["wk"]).reshape(b, l, h, dh)
        v = (y @ layer["wv"]).reshape(b, l, h, dh)
        q = q * q_scale.to(q.device)
        attn = attention(q, k, v, mask_bias, pos_bias=pos_bias)
        x = x + attn.reshape(b, l, h * dh) @ layer["wo"]
        y = rms_norm(x, layer["ffn_norm"])
        gate = F.gelu(y @ layer["wi_gelu"], approximate="tanh")
        x = x + (gate * (y @ layer["wi_lin"])) @ layer["wo_ff"]

    return rms_norm(x, params["final_norm"])
