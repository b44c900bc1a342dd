"""Autoregressive generation with a KV cache for the Qwen3-class LM
(port of ``cmw_rag_tpu/models/generate.py``).

Two phases share one layer implementation: **prefill**, one forward over the
(left-padded) prompt that writes every layer's K/V into a cache
``[layers, B, max_len, Hkv, Dh]``; **decode**, one token per step with RoPE
at the current position and attention over the cache under a length mask.
The paged engine (``models/engine.py``) reuses ``_write_kv`` and
``_layer_forward``.

Numerics follow the JAX functions: RoPE's cos/sin are cast to the working
type before they multiply; attention scores are float32 products of the
working-type q and k, masked with -1e30, softmaxed in float32 and cast back
to the working type before a float32 value product; the logits are a float32
product of the final hidden state and the tied embedding (JAX's
``preferred_element_type=float32``, see ``matmul_f32``). The cache is written in place where JAX returns an
updated copy. Sampling at temperature > 0 draws from a seeded CPU
``torch.Generator``, which cannot reproduce ``jax.random.categorical``'s
stream: greedy decoding is what agrees with the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cmw_rag_tpu_torch.models.common import make_rope, rms_norm
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config

MASK_FILL = -1e30
DEFAULT_STOP = ("<|im_end|>", "<|endoftext|>")


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` with a float32 result, as JAX's
    ``preferred_element_type=float32``: on a card, one bf16/fp16 product
    with a float32 output (float32 accumulation, no rounding of the result
    to the working type); elsewhere both inputs upcast."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16,
                                                        torch.float16):
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``ids``; an id past the table takes its last row,
    as JAX's gather clamps (a config may have fewer rows than the
    tokenizer has ids)."""
    table = params["embed"]
    return table[torch.clamp(ids.long(), max=table.shape[0] - 1)]


def _apply_rope_bt(x: torch.Tensor, cos_bt: torch.Tensor,
                   sin_bt: torch.Tensor) -> torch.Tensor:
    """Per-row RoPE: x [B, T, H, Dh]; cos/sin [B, T, Dh//2] (left-padded
    batches rotate each row by its own logical positions)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos_bt[:, :, None, :].to(x.dtype)
    sin = sin_bt[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer_forward(layer, cfg: Qwen3Config, x, cos, sin, k_cache, v_cache,
                   kv_len, q_positions, pad_offsets=None):
    """One decoder layer over query block x [B, T, D] attending to the cache
    [B, max_len, Hkv, Dh], which already holds this block's K/V at positions
    [kv_len - T, kv_len). cos/sin [B, T, Dh//2]; ``pad_offsets`` [B] marks
    left padding (keys at physical positions < pad are masked)."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.hd
    max_len = k_cache.shape[1]

    y = rms_norm(x, layer["attn_norm"])
    q = (y @ layer["wq"]).reshape(b, t, hq, dh)
    q = _apply_rope_bt(rms_norm(q, layer["q_norm"]), cos, sin)

    k, v = k_cache, v_cache
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    scores = torch.einsum("bthd,bmhd->bhtm", q.float(), k.float()) / math.sqrt(dh)
    key_pos = torch.arange(max_len, device=x.device)[None, None, None, :]
    keep = key_pos <= q_positions[None, None, :, None]
    keep = keep & (key_pos < kv_len)
    if pad_offsets is not None:
        keep = keep & (key_pos >= pad_offsets[:, None, None, None])
    scores = torch.where(keep, scores, torch.full_like(scores, MASK_FILL))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bhtm,bmhd->bthd", probs.float(), v.float()).to(x.dtype)
    x = x + attn.reshape(b, t, hq * dh) @ layer["wo"]

    y = rms_norm(x, layer["ffn_norm"])
    return x + (F.silu(y @ layer["w_gate"]) * (y @ layer["w_up"])) @ layer["w_down"]


def _write_kv(layer, cfg: Qwen3Config, x, cos, sin, k_cache, v_cache,
              start: int):
    """Project this block's K/V and write them into the caches
    [B, max_len, Hkv, Dh] at ``start``, in place; returns the caches."""
    b, t, _ = x.shape
    hkv, dh = cfg.kv_heads, cfg.hd
    y = rms_norm(x, layer["attn_norm"])
    k = (y @ layer["wk"]).reshape(b, t, hkv, dh)
    k = _apply_rope_bt(rms_norm(k, layer["k_norm"]), cos, sin)
    v = (y @ layer["wv"]).reshape(b, t, hkv, dh)
    k_cache[:, start:start + t] = k.to(k_cache.dtype)
    v_cache[:, start:start + t] = v.to(v_cache.dtype)
    return k_cache, v_cache


def init_cache(cfg: Qwen3Config, batch: int, max_len: int, device="cpu"):
    shape = (cfg.num_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "len": 0}


def _head(params, cfg: Qwen3Config) -> torch.Tensor:
    """The LM head [d, vocab]: the embedding's transpose, or ``lm_head``."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


@torch.no_grad()
def _block_forward(params, cfg: Qwen3Config, ids: torch.Tensor, cache,
                   start: int, pad_offsets: Optional[torch.Tensor] = None):
    """Shared prefill/decode block over ids [B, T] whose first token sits at
    PHYSICAL position ``start``; → (float32 logits at the last row [B, V],
    the cache, updated in place). Left-padded batches pass ``pad_offsets``
    [B]: row b's logical RoPE position is physical − pad, and keys before
    pad are masked."""
    b, t = ids.shape
    max_len = cache["k"].shape[2]
    dev = ids.device
    x = embed(params, ids)
    positions = start + torch.arange(t, device=dev)
    cos_full, sin_full = make_rope(cfg.hd, max_len, cfg.rope_theta, device=dev)
    if pad_offsets is None:
        logical = positions[None, :].expand(b, t)
    else:
        logical = torch.clamp(positions[None, :] - pad_offsets[:, None], min=0)
    cos, sin = cos_full[logical], sin_full[logical]
    kv_len = start + t
    for li, layer in enumerate(params["layers"]):
        kc, vc = _write_kv(layer, cfg, x, cos, sin, cache["k"][li],
                           cache["v"][li], start)
        x = _layer_forward(layer, cfg, x, cos, sin, kc, vc, kv_len, positions,
                           pad_offsets)
    x = rms_norm(x, params["final_norm"])
    logits = matmul_f32(x[:, -1], _head(params, cfg))
    cache["len"] = kv_len
    return logits, cache


def _stop_ids(tokenizer, stop_tokens) -> set[int]:
    specials = tokenizer.special_tokens
    return {specials[s] for s in (stop_tokens or DEFAULT_STOP) if s in specials}


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> np.ndarray:
    """Greedy at temperature 0, else one categorical draw per row of
    ``logits / temperature`` from ``gen``; → int64 ids [B]."""
    if temperature <= 0:
        return logits.argmax(dim=-1).cpu().numpy()
    probs = torch.softmax(logits.float().cpu() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].numpy()


def generate(params, cfg: Qwen3Config, tokenizer, prompt: str,
             max_new_tokens: int = 128, temperature: float = 0.0,
             seed: int = 0, stop_tokens: Optional[list[str]] = None,
             max_len: int = 1024) -> str:
    """Generate a completion (greedy when temperature == 0) on the device
    that holds ``params``."""
    dev = params["embed"].device
    ids = tokenizer.encode(prompt, allowed_special="all")
    if len(ids) >= max_len - 1:
        ids = ids[-(max_len - max_new_tokens - 1):]
    stop_ids = _stop_ids(tokenizer, stop_tokens)
    cache = init_cache(cfg, batch=1, max_len=max_len, device=dev)
    prompt_t = torch.as_tensor(np.asarray(ids, np.int64)[None, :], device=dev)
    logits, cache = _block_forward(params, cfg, prompt_t, cache, 0)
    gen = torch.Generator().manual_seed(seed)
    out: list[int] = []
    pos = len(ids)
    for _ in range(max_new_tokens):
        next_id = int(_sample(logits, temperature, gen)[0])
        if next_id in stop_ids:
            break
        out.append(next_id)
        logits, cache = _block_forward(
            params, cfg, torch.tensor([[next_id]], device=dev), cache, pos)
        pos += 1
        if pos >= max_len:
            break
    return tokenizer.decode(out)


def generate_batch(params, cfg: Qwen3Config, tokenizer, prompts: list[str],
                   max_new_tokens: int = 128, temperature: float = 0.0,
                   seed: int = 0, stop_tokens: Optional[list[str]] = None,
                   max_len: int = 1024) -> list[str]:
    """Batched generation: prompts are LEFT-padded so every row's decode
    position stays aligned; each row's RoPE runs at its own logical
    positions via ``pad_offsets``."""
    if not prompts:
        return []
    dev = params["embed"].device
    encoded = [tokenizer.encode(p, allowed_special="all") for p in prompts]
    limit = max_len - max_new_tokens - 1
    encoded = [e[-limit:] if len(e) > limit else e for e in encoded]
    t = max(len(e) for e in encoded)
    b = len(encoded)
    ids = np.zeros((b, t), np.int64)
    pads = np.zeros((b,), np.int64)
    for i, e in enumerate(encoded):
        pads[i] = t - len(e)
        ids[i, pads[i]:] = e
    stop_ids = _stop_ids(tokenizer, stop_tokens)
    cache = init_cache(cfg, batch=b, max_len=max_len, device=dev)
    pad_t = torch.as_tensor(pads, device=dev)
    logits, cache = _block_forward(params, cfg, torch.as_tensor(ids, device=dev),
                                   cache, 0, pad_t)
    gen = torch.Generator().manual_seed(seed)
    done = [False] * b
    outs: list[list[int]] = [[] for _ in range(b)]
    pos = t
    for _ in range(max_new_tokens):
        next_ids = _sample(logits, temperature, gen)
        for i in range(b):
            if done[i]:
                continue
            if int(next_ids[i]) in stop_ids:
                done[i] = True
            else:
                outs[i].append(int(next_ids[i]))
        if all(done) or pos >= max_len:
            break
        logits, cache = _block_forward(
            params, cfg, torch.as_tensor(next_ids[:, None], device=dev), cache,
            pos, pad_t)
        pos += 1
    return [tokenizer.decode(o) for o in outs]
