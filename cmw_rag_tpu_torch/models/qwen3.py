"""Qwen3-class causal decoder (port of ``cmw_rag_tpu/models/qwen3.py:90-160``).

Pre-norm RMSNorm, per-head q/k RMSNorm before RoPE (rotate-half), grouped
query attention, SwiGLU FFN, tied embeddings. Attention takes one of two
routes, as in the JAX package: the plain one (``models/common.attention``
under a causal padding bias), or, with ``use_flash=True``, the flash kernel
(``ops/flash_attention.flash_attention_bhld``, causal, the key mask passed
as is, K and V repeated to the full head count), which the embedder and
the LLM reranker choose for sequences of 1024 tokens or more.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from cmw_rag_tpu_torch.models.common import (
    ModelConfig,
    Params,
    apply_rope,
    attention,
    dense_init,
    embed_init,
    make_rope,
    padding_mask_bias,
    rms_norm,
)
from cmw_rag_tpu_torch.models.weights import Leaf, tree_map
from cmw_rag_tpu_torch.ops.flash_attention import flash_attention_bhld


@dataclass(frozen=True)
class Qwen3Config(ModelConfig):
    rope_theta: float = 1e6
    max_seq_len: int = 8192
    tie_embeddings: bool = True


def qwen3_layout(cfg: Qwen3Config) -> Params:
    """Shapes and dtypes of the parameter tree (checkpoint loading)."""
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied lm_head is not ported")
    d, hq, hkv, dh, ff = (cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
                          cfg.d_ff)
    f32, w = torch.float32, cfg.dtype
    layer = {
        "attn_norm": Leaf((d,), f32), "wq": Leaf((d, hq * dh), w),
        "wk": Leaf((d, hkv * dh), w), "wv": Leaf((d, hkv * dh), w),
        "wo": Leaf((hq * dh, d), w), "q_norm": Leaf((dh,), f32),
        "k_norm": Leaf((dh,), f32), "ffn_norm": Leaf((d,), f32),
        "w_gate": Leaf((d, ff), w), "w_up": Leaf((d, ff), w),
        "w_down": Leaf((ff, d), w),
    }
    return {"embed": Leaf((cfg.vocab_size, d), w),
            "final_norm": Leaf((d,), f32),
            "layers": [dict(layer) for _ in range(cfg.num_layers)]}


def init_qwen3(gen: torch.Generator, cfg: Qwen3Config,
               device="cpu") -> Params:
    """Random parameters drawn from ``gen`` (a CPU generator)."""
    d, hq, hkv, dh, ff = (cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
                          cfg.d_ff)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, cfg.dtype),
        "final_norm": torch.ones((d,)),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": torch.ones((d,)),
            "wq": dense_init(gen, d, hq * dh, cfg.dtype),
            "wk": dense_init(gen, d, hkv * dh, cfg.dtype),
            "wv": dense_init(gen, d, hkv * dh, cfg.dtype),
            "wo": dense_init(gen, hq * dh, d, cfg.dtype),
            "q_norm": torch.ones((dh,)),
            "k_norm": torch.ones((dh,)),
            "ffn_norm": torch.ones((d,)),
            "w_gate": dense_init(gen, d, ff, cfg.dtype),
            "w_up": dense_init(gen, d, ff, cfg.dtype),
            "w_down": dense_init(gen, ff, d, cfg.dtype),
        })
    return tree_map(lambda t: t.to(device), params)


def qwen3_hidden_states(params: Params, cfg: Qwen3Config,
                        input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        use_flash: bool = False,
                        flash_block: int = 256) -> torch.Tensor:
    """Causal forward → hidden states [B, L, D] in cfg.dtype.

    ``use_flash=True`` routes attention through the flash kernel; L must
    then be a multiple of ``flash_block`` (the plain twin's block on the
    CPU) and of the kernel's tile on a card."""
    b, l = input_ids.shape
    hq, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.hd
    x = params["embed"][input_ids.long()]
    mask_bias = None if use_flash else padding_mask_bias(attention_mask,
                                                         causal=True)
    cos, sin = make_rope(dh, l, cfg.rope_theta, device=x.device)

    for layer in params["layers"]:
        y = rms_norm(x, layer["attn_norm"])
        q = (y @ layer["wq"]).reshape(b, l, hq, dh)
        k = (y @ layer["wk"]).reshape(b, l, hkv, dh)
        v = (y @ layer["wv"]).reshape(b, l, hkv, dh)
        q = apply_rope(rms_norm(q, layer["q_norm"]), cos, sin)
        k = apply_rope(rms_norm(k, layer["k_norm"]), cos, sin)
        if use_flash:
            k_full = torch.repeat_interleave(k, hq // hkv, dim=2)
            v_full = torch.repeat_interleave(v, hq // hkv, dim=2)
            attn = flash_attention_bhld(q, k_full, v_full, attention_mask,
                                        causal=True, block_q=flash_block,
                                        block_k=flash_block)
        else:
            attn = attention(q, k, v, mask_bias)
        x = x + attn.reshape(b, l, hq * dh) @ layer["wo"]
        y = rms_norm(x, layer["ffn_norm"])
        x = x + (F.silu(y @ layer["w_gate"]) * (y @ layer["w_up"])) @ layer["w_down"]

    return rms_norm(x, params["final_norm"])
