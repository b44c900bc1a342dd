"""Continuous-batching LLM engine with a paged KV cache
(port of ``cmw_rag_tpu/models/engine.py``).

vLLM's role in the reference topology: sequences hold page tables into a
shared pool, so device memory is allocated in fixed pages, and new requests
join the decode batch the moment a slot frees.

- Device state is two pools ``[L, P, page, Hkv, Dh]`` (K and V; int8 pools
  carry page-granular float32 scales ``[L, P, Hkv]``) plus per-slot block
  tables and lengths on the host; page 0 is a reserved null page that idle
  slots write into.
- **Prefill** is a dense forward over a right-padded, bucketed prompt whose
  K/V are written into the slot's pages, or, with ``prefill_chunk``, one
  fixed-size chunk per step that attends to the slot's earlier pages.
- **Decode** is one step for all slots: embed the S last tokens, RoPE at each
  slot's length, write the new K/V into the pages and attend through
  ``ops/paged_attention`` (the hand-written kernel on a card, its plain twin
  on the CPU; ``use_kernel=False`` takes the gather golden on either).
- The host scheduler admits pending requests into free slots every step,
  allocates pages lazily as sequences grow and, when the pool runs dry,
  preempts the youngest-admitted request (re-queueing its prompt and
  generated prefix).

The pools and scales are updated in place where the JAX package donates
them. Numerics are those of ``models/generate.py``; the logits are float32
products of the final hidden state and the tied embedding.

With ``weights="int8"`` the parameters are quantized at construction
(``models/quantize``): prefill dequantizes a layer at a time and runs the
full-precision layer math, and the head is the float32 golden of
``int8_matmul``; decode runs the int8 kernels the JAX engine picks. At most
8 slots, one decoder-layer megakernel launch a layer
(``ops/decoder_layer``, ``layer_fused``) with slot-major attention over the
partitioned pool (``attn_slot``) while each slot's context fits
``SLOT_ATTN_VMEM_LIMIT``, paged attention past it. Past 8 slots, the fused
QKV ``int8_matmul``, slot-major attention (or, past the limit, the scatter
kernel) and the fused MLP (``ops/fused_mlp``, ``mlp_fused``). The head is
``int8_matmul`` on every int8 step. With int8 KV pages the megakernel runs
only when forced (``layer_fused=True``): ``decoder_layer_int8_kv8`` on the
paged route, at any slot count, each layer's [P, Hkv] scale planes updated
in place.

``weights="w8a8"`` quantizes the same tree and, in decode, quantizes the
activations too (``int8_matmul_w8a8`` for QKV, wo, gate-up, down and the
head on float32 x); by the JAX defaults it runs neither fused MLP, nor
megakernel, nor slot-major attention, and the scatter kernel. The JAX
refusals hold: ``mlp_fused`` or ``layer_fused`` with w8a8, ``attn_batched``
with int8 KV raise ``ValueError``. ``attn_batched`` takes the batched alias
of the paged kernel (and ``batched=True`` of the scatter kernel and the
megakernel, the same kernels). ``ablate`` (a diagnosis knob, wrong outputs
on purpose, ``_paged_decode``'s argument in the JAX package): ``"noattn"``
makes the unfused layers' attention return q, ``"noscatter"`` skips their
page writes, and either turns the fused scatter off; the megakernel routes
ignore it, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.models.common import make_rope, rms_norm
from cmw_rag_tpu_torch.models.generate import (DEFAULT_STOP, _head,
                                               _layer_forward, _write_kv,
                                               embed, matmul_f32)
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
from cmw_rag_tpu_torch.models.quantize import (dequantize_layer,
                                               quantize_qwen3_params)
from cmw_rag_tpu_torch.ops.decoder_layer import (decoder_layer_int8,
                                                 decoder_layer_int8_kv8,
                                                 make_rope_maps)
from cmw_rag_tpu_torch.ops.fused_mlp import fused_mlp_int8
from cmw_rag_tpu_torch.ops.int8_matmul import (int8_matmul, int8_matmul_w8a8,
                                               int8_matmul_w8a8_xla,
                                               int8_matmul_xla)
from cmw_rag_tpu_torch.ops.paged_attention import (
    KV_HEADROOM,
    paged_decode_attention_dma,
    paged_decode_attention_dma_batched,
    paged_decode_attention_dma_kv_int8,
    paged_decode_attention_dma_scatter,
    paged_decode_attention_dma_slot,
    paged_decode_attention_xla,
    paged_decode_attention_xla_kv_int8,
    quantize_kv_page,
    quantize_kv_token,
)

logger = logging.getLogger(__name__)

# The TPU's scoped-VMEM budget for the slot-major attention's K and V context
# buffers (n_buf x cap x page x Hkv x Dh each, JAX engine.py:57-61). Hopper
# has no such budget; the port keeps it so that it takes the route the
# reference takes (at qwen3guard-0.6b's width: slot-major up to cap 6, 384
# tokens). Lifting it on the card is later work (ROADMAP.md).
SLOT_ATTN_VMEM_LIMIT = 3 * 2 ** 20


def _rope_rows(x, cos, sin):
    """RoPE for one token per row: x [S, H, Dh]; cos/sin [S, Dh//2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, None, :].to(x.dtype)
    s = sin[:, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _write_pages(pool, scale, li, pages, blocks, kv_int8):
    """Write dense blocks [n, page, Hkv, Dh] into pages ``pages`` [n] of
    layer ``li``, quantizing them per page for int8 pools."""
    if kv_int8:
        q, s = quantize_kv_page(blocks)
        pool[li, pages] = q
        scale[li, pages] = s
    else:
        pool[li, pages] = blocks.to(pool.dtype)


def _layers(params, cfg: Qwen3Config, weights_int8: bool):
    """The layers in the full-precision layout: int8 ones dequantized one at
    a time (prefill is one pass per admission)."""
    for layer in params["layers"]:
        yield dequantize_layer(layer, cfg.dtype, cfg) if weights_int8 else layer


def _prefill_logits(params, cfg: Qwen3Config, h, weights_int8: bool):
    """float32 logits [V] of the final hidden state h [D]."""
    if weights_int8:
        return int8_matmul_xla(h[None].float(), params["head_q"],
                               params["head_s"])[0, :cfg.vocab_size]
    return matmul_f32(h, _head(params, cfg))


@torch.no_grad()
def _paged_prefill(params, k_pool, v_pool, k_scale, v_scale, ids, true_len,
                   table_row, cfg: Qwen3Config, kv_int8: bool = False,
                   weights_int8: bool = False):
    """Dense forward over right-padded ids [1, T] (T a page multiple); writes
    K/V for all T positions into the pages ``table_row`` [T // page] (rows at
    or past ``true_len`` are garbage, masked later by the lengths); → float32
    logits at ``true_len - 1`` [V]. The pools and scales are written in
    place. With ``weights_int8`` each layer is dequantized for the pass."""
    _, t = ids.shape
    page = k_pool.shape[2]
    hkv, dh = cfg.kv_heads, cfg.hd
    dev = ids.device
    x = embed(params, ids)
    positions = torch.arange(t, device=dev)
    cos_full, sin_full = make_rope(dh, t, cfg.rope_theta, device=dev)
    cos, sin = cos_full[None], sin_full[None]
    pages = table_row.long()
    kc = torch.zeros((1, t, hkv, dh), dtype=cfg.dtype, device=dev)
    vc = torch.zeros((1, t, hkv, dh), dtype=cfg.dtype, device=dev)
    for li, layer in enumerate(_layers(params, cfg, weights_int8)):
        _write_kv(layer, cfg, x, cos, sin, kc, vc, 0)
        x = _layer_forward(layer, cfg, x, cos, sin, kc, vc, t, positions)
        _write_pages(k_pool, k_scale, li, pages,
                     kc[0].reshape(t // page, page, hkv, dh), kv_int8)
        _write_pages(v_pool, v_scale, li, pages,
                     vc[0].reshape(t // page, page, hkv, dh), kv_int8)
    x = rms_norm(x, params["final_norm"])
    return _prefill_logits(params, cfg, x[0, true_len - 1], weights_int8)


@torch.no_grad()
def _prefill_chunk(params, k_pool, v_pool, k_scale, v_scale, ids_c, start,
                   valid_c, table_row, cfg: Qwen3Config, kv_int8: bool = False,
                   weights_int8: bool = False):
    """Chunked prefill: ONE chunk ``ids_c`` [1, C] of a prompt at absolute
    positions [start, start + C). The chunk attends to the slot's earlier
    pages (gathered through ``table_row`` [maxp]) and to itself causally,
    writes its own K/V into the pages it covers, and returns the float32
    logits at chunk position ``valid_c - 1`` (only the last chunk's are
    used). C must be a page multiple dividing max_ctx."""
    _, c = ids_c.shape
    page = k_pool.shape[2]
    maxp = table_row.shape[0]
    hkv, dh = cfg.kv_heads, cfg.hd
    dev = ids_c.device
    n_cpages = c // page
    x = embed(params, ids_c)
    cos_full, sin_full = make_rope(dh, maxp * page, cfg.rope_theta, device=dev)
    positions = start + torch.arange(c, device=dev)
    cos, sin = cos_full[positions][None], sin_full[positions][None]
    table = table_row.long()
    pidx = table[start // page:start // page + n_cpages]
    for li, layer in enumerate(_layers(params, cfg, weights_int8)):
        # the slot's earlier context; rows of the null page 0 are garbage,
        # masked by position and causality
        if kv_int8:
            ks = k_scale[li, table][:, None, :, None]
            vs = v_scale[li, table][:, None, :, None]
            prev_k = (k_pool[li, table].float() * ks).to(cfg.dtype)
            prev_v = (v_pool[li, table].float() * vs).to(cfg.dtype)
        else:
            prev_k = k_pool[li, table].to(cfg.dtype)
            prev_v = v_pool[li, table].to(cfg.dtype)
        kc = prev_k.reshape(1, maxp * page, hkv, dh)
        vc = prev_v.reshape(1, maxp * page, hkv, dh)
        _write_kv(layer, cfg, x, cos, sin, kc, vc, start)
        x = _layer_forward(layer, cfg, x, cos, sin, kc, vc, start + c,
                           positions)
        _write_pages(k_pool, k_scale, li, pidx,
                     kc[0, start:start + c].reshape(n_cpages, page, hkv, dh),
                     kv_int8)
        _write_pages(v_pool, v_scale, li, pidx,
                     vc[0, start:start + c].reshape(n_cpages, page, hkv, dh),
                     kv_int8)
    x = rms_norm(x, params["final_norm"])
    return _prefill_logits(params, cfg, x[0, valid_c - 1], weights_int8)


def _write_token_int8(pool, scale, li, page_idx, off, x):
    """int8 pools: the first token of a fresh page sets the page's scale
    with headroom; later tokens quantize against it (clipping at ±127)."""
    fresh = (off == 0)[:, None]                                  # [S, 1]
    amax = x.float().abs().amax(dim=-1)                          # [S, Hkv]
    cur = scale[li, page_idx]
    new = torch.where(fresh, torch.clamp(amax, min=1e-8) * (KV_HEADROOM / 127.0),
                      cur)
    pool[li, page_idx, off] = quantize_kv_token(x, new)
    scale[li, page_idx] = new


@torch.no_grad()
def _paged_decode(params, k_pool, v_pool, k_scale, v_scale, tables, lens,
                  cur_ids, active, cfg: Qwen3Config, use_kernel: bool, rope,
                  kv_int8: bool = False, scatter_fused: bool = False,
                  ablate: str = "", weights_int8: bool = False,
                  mlp_fused: bool = False, layer_fused: bool = False,
                  attn_slot: bool = False, slot_cap: int = 0,
                  w8a8: bool = False, attn_batched: bool = False):
    """One decode step for every slot: the new token ``cur_ids[s]`` sits at
    logical position ``lens[s]``. → float32 logits [S, V]; the pools (and
    int8 scales) are updated in place. Idle slots write their K/V into the
    null page 0. ``rope``: the (cos, sin) tables of ``maxp * page``
    positions (``make_rope``; the engine makes them once). The int8-weight
    routes follow the JAX engine's (``engine.py:229-513``); ``attn_slot``
    needs the partitioned pool and ``slot_cap`` pages covering every
    length. ``ablate`` (diagnosis only, wrong outputs): "noattn" makes the
    unfused layers' attention a passthrough of q, "noscatter" skips their
    K/V page writes."""
    s = cur_ids.shape[0]
    page = k_pool.shape[2]
    maxp = tables.shape[1]
    hq, hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.hd
    dev = cur_ids.device
    if attn_slot:
        # the TPU's context buffers for slot-major attention must fit its
        # scoped VMEM, and the megakernel past 8 slots overflows it: both
        # fall back to the paged route, as the JAX engine does
        kv_bytes = 2 * 2 * slot_cap * page * hkv * dh * k_pool.element_size()
        if slot_cap <= 0 or kv_bytes > SLOT_ATTN_VMEM_LIMIT:
            attn_slot = False
        if layer_fused and s > 8:
            attn_slot = False
    x = embed(params, cur_ids)                        # [S, D]
    cos, sin = rope[0][lens.long()], rope[1][lens.long()]  # [S, half]
    rows = torch.arange(s, device=dev)
    page_idx = tables.long()[rows, lens.long() // page]
    page_idx = torch.where(active, page_idx, 0).to(torch.int32)  # null page
    off = (lens % page).to(torch.int32)
    lens1 = (lens + 1).to(torch.int32)
    if weights_int8:
        # w8a8: the activations are quantized per token too (int8 x int8)
        if w8a8:
            mm_fn = int8_matmul_w8a8 if use_kernel else int8_matmul_w8a8_xla
        else:
            mm_fn = int8_matmul if use_kernel else int8_matmul_xla

        def mm(y, layer, name):
            return mm_fn(y, layer[name + "_q"], layer[name + "_s"])
    if layer_fused:
        # ONE launch a layer: norm, QKV, head norms, RoPE, K/V write,
        # attention, wo, norm, FFN (ops/decoder_layer.py); with int8 KV the
        # kernel also quantizes the new rows and updates this layer's
        # [P, Hkv] scale planes in place
        c2, s2 = make_rope_maps(cos, sin)
        for li, layer in enumerate(params["layers"]):
            weights = (layer["attn_norm"], layer["wqkv_q"], layer["wqkv_s"],
                       layer["q_norm"], layer["k_norm"], layer["wo_q"],
                       layer["wo_s"], layer["ffn_norm"], layer["w_gateup_q"],
                       layer["w_gateup_s"], layer["w_down_q"],
                       layer["w_down_s"])
            if kv_int8:
                x = decoder_layer_int8_kv8(
                    x, c2, s2, *weights, page_idx, off, k_pool, k_scale[li],
                    v_pool, v_scale[li], lens1, layer=li, tables=tables)[0]
            else:
                x = decoder_layer_int8(
                    x, c2, s2, *weights, page_idx, off, k_pool, v_pool, lens1,
                    layer=li, batched=attn_batched, attn_slot=attn_slot,
                    slot_cap=slot_cap, slot_maxp=maxp, tables=tables)[0]
        x = rms_norm(x, params["final_norm"])
        return mm_fn(x.float(), params["head_q"],
                     params["head_s"])[:, :cfg.vocab_size]
    fused = (scatter_fused and use_kernel and not kv_int8 and not ablate
             and not attn_slot)
    for li, layer in enumerate(params["layers"]):
        y = rms_norm(x, layer["attn_norm"])
        if weights_int8:
            qkv = mm(y, layer, "wqkv")        # fused: one launch for q, k, v
            q = qkv[:, : hq * dh].reshape(s, hq, dh)
            k = qkv[:, hq * dh:(hq + hkv) * dh].reshape(s, hkv, dh)
            v = qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)
        else:
            q = (y @ layer["wq"]).reshape(s, hq, dh)
            k = (y @ layer["wk"]).reshape(s, hkv, dh)
            v = (y @ layer["wv"]).reshape(s, hkv, dh)
        q = _rope_rows(rms_norm(q, layer["q_norm"]), cos, sin)
        k = _rope_rows(rms_norm(k, layer["k_norm"]), cos, sin)
        if fused:
            attn, _, _ = paged_decode_attention_dma_scatter(
                q, k.to(k_pool.dtype).contiguous(),
                v.to(v_pool.dtype).contiguous(), page_idx, off, k_pool, v_pool,
                tables, lens1, layer=li, batched=attn_batched)
        else:
            pi, of = page_idx.long(), off.long()
            if ablate == "noscatter":
                pass
            elif kv_int8:
                _write_token_int8(k_pool, k_scale, li, pi, of, k)
                _write_token_int8(v_pool, v_scale, li, pi, of, v)
            else:
                k_pool[li, pi, of] = k.to(k_pool.dtype)
                v_pool[li, pi, of] = v.to(v_pool.dtype)
            if ablate == "noattn":
                attn = q                  # diagnosis passthrough
            elif use_kernel and attn_slot and not kv_int8:
                attn = paged_decode_attention_dma_slot(
                    q.contiguous(), k_pool, v_pool, lens1, layer=li,
                    cap=slot_cap, maxp_slot=maxp)
            elif use_kernel and kv_int8:
                attn = paged_decode_attention_dma_kv_int8(
                    q, k_pool, k_scale, v_pool, v_scale, tables, lens1,
                    layer=li)
            elif use_kernel and attn_batched:
                attn = paged_decode_attention_dma_batched(
                    q, k_pool, v_pool, tables, lens1, layer=li)
            elif use_kernel:
                attn = paged_decode_attention_dma(q, k_pool, v_pool, tables,
                                                  lens1, layer=li)
            elif kv_int8:
                attn = paged_decode_attention_xla_kv_int8(
                    q, k_pool[li], k_scale[li], v_pool[li], v_scale[li],
                    tables, lens1)
            else:
                attn = paged_decode_attention_xla(q, k_pool[li], v_pool[li],
                                                  tables, lens1)
        attn = attn.reshape(s, hq * dh).to(x.dtype)
        if mlp_fused:
            # ONE launch for wo, residual, norm, gate/up, SiLU, down,
            # residual (ops/fused_mlp.py)
            x = fused_mlp_int8(
                x, attn.contiguous(), layer["wo_q"], layer["wo_s"],
                layer["ffn_norm"], layer["w_gateup_q"], layer["w_gateup_s"],
                layer["w_down_q"], layer["w_down_s"])
        elif weights_int8:
            x = x + mm(attn, layer, "wo")
            y = rms_norm(x, layer["ffn_norm"])
            gu = mm(y, layer, "w_gateup")     # fused: one launch for gate, up
            d_ff = gu.shape[1] // 2
            x = x + mm(F.silu(gu[:, :d_ff]) * gu[:, d_ff:], layer, "w_down")
        else:
            x = x + attn @ layer["wo"]
            y = rms_norm(x, layer["ffn_norm"])
            x = x + (F.silu(y @ layer["w_gate"]) * (y @ layer["w_up"])) @ layer["w_down"]
    x = rms_norm(x, params["final_norm"])
    if weights_int8:
        return mm_fn(x.float(), params["head_q"],
                     params["head_s"])[:, :cfg.vocab_size]
    return matmul_f32(x, _head(params, cfg))


@dataclasses.dataclass
class Request:
    rid: int
    ids: list[int]                      # prompt + generated so far
    prompt_len: int
    max_new_tokens: int
    temperature: float
    top_p: float
    top_k: int
    stop_ids: frozenset[int]
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""
    preemptions: int = 0
    emitted_chars: int = 0
    on_token: Optional[Callable[[Optional[int], str], None]] = None


class PagedLLMEngine:
    """Host-side scheduler over the paged prefill and decode steps.

    ``device`` (default ``"cuda"``) holds the parameters, pools and scales;
    ``use_kernel`` defaults to on for a CUDA device, as the JAX package's
    server decides for an accelerator. On the CPU, ``use_kernel=True`` runs
    the kernels' plain twins (the role of interpret mode in the JAX tests);
    ``use_kernel=False`` takes the gather golden on either device."""

    def __init__(
        self,
        params,
        cfg: Qwen3Config,
        tokenizer,
        *,
        max_slots: int = 4,
        page_size: int = 16,
        max_ctx: int = 1024,
        num_pages: Optional[int] = None,
        use_kernel: Optional[bool] = None,
        prefill_buckets: Optional[tuple[int, ...]] = None,
        prefill_chunk: int = 0,    # > 0: chunked prefill, C tokens a step
        seed: int = 0,
        weights: str = "native",   # "native" | "int8" | "w8a8"
        kv_dtype: str = "native",  # "native" (cfg.dtype) | "int8" pages
        mlp_fused: Optional[bool] = None,    # fused int8 MLP kernel
        scatter_fused: Optional[bool] = None,  # K/V write inside the kernel
        layer_fused: Optional[bool] = None,  # decoder-layer megakernel
        attn_batched: bool = False,          # the batched attention alias
        attn_slot: Optional[bool] = None,    # slot-major attention
        ablate: str = "",                    # "noattn" | "noscatter"
        device: str | torch.device = "cuda",
    ):
        if max_ctx % page_size:
            raise ValueError("max_ctx must be a multiple of page_size")
        if prefill_chunk:
            if prefill_chunk % page_size or max_ctx % prefill_chunk:
                raise ValueError(
                    "prefill_chunk must be a page multiple dividing max_ctx")
        self.device = resolve_device(device)
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        maxp = max_ctx // page_size
        num_pages = num_pages if num_pages is not None else 1 + max_slots * maxp
        # the JAX engine's defaults and refusals (engine.py:631-678)
        if mlp_fused is None:
            mlp_fused = weights == "int8" and use_kernel
        if mlp_fused and weights != "int8":
            raise ValueError("mlp_fused requires weights='int8' "
                             "(fused kernel streams the int8 layout)")
        if scatter_fused is None:
            scatter_fused = use_kernel and kv_dtype == "native"
        if scatter_fused and (not use_kernel or kv_dtype != "native"):
            raise ValueError("scatter_fused requires use_kernel=True and "
                             "native-dtype KV pages")
        if layer_fused is None:
            layer_fused = (use_kernel and weights == "int8"
                           and kv_dtype == "native" and max_slots <= 8)
        if layer_fused and (not use_kernel or weights != "int8"):
            raise ValueError("layer_fused requires use_kernel=True and "
                             "weights='int8'")
        if attn_batched and (not use_kernel or kv_dtype != "native"):
            raise ValueError("attn_batched requires use_kernel=True and "
                             "native-dtype KV pages")
        if attn_slot is None:
            attn_slot = (use_kernel and weights == "int8"
                         and kv_dtype == "native"
                         and num_pages >= 1 + max_slots * maxp)
        if attn_slot:
            if not use_kernel or kv_dtype != "native":
                raise ValueError("attn_slot requires use_kernel=True and "
                                 "native-dtype KV pages")
            if num_pages < 1 + max_slots * maxp:
                raise ValueError(
                    "attn_slot requires the full partitioned pool: "
                    "num_pages >= 1 + max_slots * max_ctx/page_size")
        if ablate not in ("", "noattn", "noscatter"):
            raise ValueError(f"ablate={ablate!r}: '', 'noattn' or "
                             f"'noscatter'")
        self.weights_int8 = weights in ("int8", "w8a8")
        self.w8a8 = weights == "w8a8"
        if self.weights_int8:
            params = quantize_qwen3_params(params, cfg)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.page = page_size
        self.maxp = maxp
        self.max_ctx = max_ctx
        self.slots: list[Optional[Request]] = [None] * max_slots
        # page 0 is the reserved null page (idle-slot writes land there)
        self.num_pages = num_pages
        if self.num_pages < 2:
            raise ValueError("pool needs at least the null page + one real page")
        self._free = deque(range(1, self.num_pages))
        shape = (cfg.num_layers, self.num_pages, page_size, cfg.kv_heads, cfg.hd)
        self.kv_int8 = kv_dtype == "int8"
        pool_dtype = torch.int8 if self.kv_int8 else cfg.dtype
        dev = self.device
        self.k_pool = torch.zeros(shape, dtype=pool_dtype, device=dev)
        self.v_pool = torch.zeros(shape, dtype=pool_dtype, device=dev)
        sshape = ((cfg.num_layers, self.num_pages, cfg.kv_heads)
                  if self.kv_int8 else (1,))
        self.k_scale = torch.zeros(sshape, dtype=torch.float32, device=dev)
        self.v_scale = torch.zeros(sshape, dtype=torch.float32, device=dev)
        self._rope = make_rope(cfg.hd, max_ctx, cfg.rope_theta, device=dev)
        self.tables = np.zeros((max_slots, self.maxp), np.int32)
        self.lens = np.zeros((max_slots,), np.int32)
        self.cur_ids = np.zeros((max_slots,), np.int32)
        self.pending: deque[Request] = deque()
        self.use_kernel = use_kernel
        self.scatter_fused = scatter_fused
        self.mlp_fused = mlp_fused
        self.layer_fused = layer_fused
        self.attn_batched = attn_batched
        self.attn_slot = attn_slot
        self.ablate = ablate
        # partitioned allocator: slot s's logical page j is always physical
        # 1 + s * maxp + j (contiguous per slot, the slot kernel's contract);
        # allocation and free leave the shared pool alone
        self.slot_pages = attn_slot
        self.decode_steps = 0
        if prefill_buckets is None:
            # the ladder always ends at max_ctx, so any prompt that passes
            # submit()'s length check has a bucket
            prefill_buckets = tuple(
                b for b in (64, 128, 256, 512, 1024, 2048, 4096)
                if b < max_ctx
            ) + (max_ctx,)
        self.prefill_buckets = tuple(sorted(
            -(-b // page_size) * page_size for b in prefill_buckets))
        self._rng = np.random.default_rng(seed)
        self._next_rid = itertools.count()
        self._lock = threading.Lock()
        self._admit_order: list[int] = []   # slot indices, oldest first
        self.prefill_chunk = int(prefill_chunk)
        # chunked-prefill streams: slot -> next chunk start. These slots hold
        # a Request and pages but stay out of decode (and of preemption)
        # until their prompt has streamed in.
        self._prefilling: dict[int, int] = {}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------ submit
    def _encode_stops(self, stop_tokens) -> frozenset[int]:
        specials = self.tokenizer.special_tokens
        return frozenset(specials[t] for t in (stop_tokens or DEFAULT_STOP)
                         if t in specials)

    def submit(
        self,
        prompt: str,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 1.0,
        top_k: int = 0,
        stop_tokens=None,
        on_token: Optional[Callable[[int, str], None]] = None,
    ) -> Request:
        ids = self.tokenizer.encode(prompt, allowed_special="all")
        limit = self.max_ctx - max_new_tokens - 1
        if limit < 1:
            raise ValueError("max_new_tokens leaves no room for the prompt")
        if len(ids) > limit:
            ids = ids[-limit:]
        req = Request(
            rid=next(self._next_rid), ids=list(ids), prompt_len=len(ids),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, top_k=top_k,
            stop_ids=self._encode_stops(stop_tokens), on_token=on_token,
        )
        with self._lock:
            self.pending.append(req)
        return req

    # ------------------------------------------------------------ pages
    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page)

    def _free_slot_pages(self, slot: int) -> None:
        if not self.slot_pages:   # partitioned pages never enter the pool
            used = self._pages_needed(int(self.lens[slot]))
            for i in range(used):
                p = int(self.tables[slot, i])
                if p > 0:
                    self._free.append(p)
        self.tables[slot, :] = 0
        self.lens[slot] = 0
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        self.slots[slot] = None

    def _preempt_youngest(self) -> bool:
        """Kick the most recently admitted request back to pending (its
        prompt + prefix re-prefills later); False if nothing to kick."""
        if not self._admit_order:
            return False
        slot = self._admit_order[-1]
        req = self.slots[slot]
        req.preemptions += 1
        self._free_slot_pages(slot)
        with self._lock:
            self.pending.appendleft(req)
        return True

    # ------------------------------------------------------------ admit
    def _bucket_for(self, n: int) -> Optional[int]:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return None   # longer than every bucket (custom ladder)

    def _admit_one_chunked(self, slot: int, req: Request) -> bool:
        """Chunked admission: allocate exactly the prompt's pages and queue
        the slot for incremental prefill."""
        n = len(req.ids)
        n_used = self._pages_needed(n)
        if n_used > self.num_pages - 1:
            req.done = True
            req.finish_reason = "context"
            return True
        if self.slot_pages:
            pages = [1 + slot * self.maxp + i for i in range(n_used)]
        elif len(self._free) < n_used:
            return False
        else:
            pages = [self._free.popleft() for _ in range(n_used)]
        self.tables[slot, :] = 0
        self.tables[slot, :n_used] = pages
        self.lens[slot] = 0
        self.slots[slot] = req
        self._prefilling[slot] = 0
        return True

    def _prefill_step(self) -> int:
        """Advance ONE chunk of ONE prefilling slot."""
        if not self._prefilling:
            return 0
        slot = next(iter(self._prefilling))
        req = self.slots[slot]
        pos = self._prefilling[slot]
        c = self.prefill_chunk
        n = len(req.ids)
        ids = np.zeros((1, c), np.int32)
        chunk_ids = req.ids[pos:pos + c]
        ids[0, : len(chunk_ids)] = chunk_ids
        valid = min(c, n - pos)
        logits = _prefill_chunk(
            self.params, self.k_pool, self.v_pool, self.k_scale, self.v_scale,
            self._dev(ids), pos, valid, self._dev(self.tables[slot]), self.cfg,
            kv_int8=self.kv_int8, weights_int8=self.weights_int8)
        pos += c
        if pos >= n:
            del self._prefilling[slot]
            self.lens[slot] = n
            self._admit_order.append(slot)
            next_id = self._sample_row(logits.cpu().numpy(), req)
            self._push_token(slot, req, next_id)
        else:
            self._prefilling[slot] = pos
        return 1

    def _admit_one(self, slot: int, req: Request) -> bool:
        if self.prefill_chunk:
            return self._admit_one_chunked(slot, req)
        n = len(req.ids)
        bucket = self._bucket_for(n)
        if bucket is None:
            # longer than the largest bucket (only with a custom ladder
            # shorter than max_ctx): fail the request, not the step loop
            req.done = True
            req.finish_reason = "context"
            return True
        n_bucket_pages = bucket // self.page
        n_used_pages = self._pages_needed(n)
        if n_bucket_pages > self.num_pages - 1:
            # can never fit, even with the whole pool
            req.done = True
            req.finish_reason = "context"
            return True
        if self.slot_pages:
            pages = [1 + slot * self.maxp + i for i in range(n_bucket_pages)]
        elif len(self._free) < n_bucket_pages:
            return False
        else:
            pages = [self._free.popleft() for _ in range(n_bucket_pages)]
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = req.ids
        logits = _paged_prefill(
            self.params, self.k_pool, self.v_pool, self.k_scale, self.v_scale,
            self._dev(ids), n, self._dev(np.asarray(pages, np.int32)),
            self.cfg, kv_int8=self.kv_int8, weights_int8=self.weights_int8)
        # keep only the pages that hold real context; return the rest
        if not self.slot_pages:
            for p in pages[n_used_pages:]:
                self._free.append(p)
        self.tables[slot, :] = 0
        self.tables[slot, :n_used_pages] = pages[:n_used_pages]
        self.lens[slot] = n
        self.slots[slot] = req
        self._admit_order.append(slot)
        next_id = self._sample_row(logits.cpu().numpy(), req)
        self._push_token(slot, req, next_id)
        return True

    def _admit(self) -> None:
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None:
                continue
            with self._lock:
                req = self.pending.popleft() if self.pending else None
            if req is None:
                return
            if not self._admit_one(slot, req):
                with self._lock:
                    self.pending.appendleft(req)
                return

    # ------------------------------------------------------------ step
    def _sample_row(self, logits_row: np.ndarray, req: Request) -> int:
        """Greedy at temperature 0; otherwise temperature with optional
        top-k / nucleus (top-p) filtering (the /v1/chat/completions
        sampling contract)."""
        if req.temperature <= 0:
            return int(logits_row.argmax())
        z = logits_row / req.temperature
        if req.top_k and req.top_k < len(z):
            kth = np.partition(z, -req.top_k)[-req.top_k]
            z = np.where(z < kth, -np.inf, z)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        if 0.0 < req.top_p < 1.0:
            order = np.argsort(-p)
            csum = np.cumsum(p[order])
            cut = int(np.searchsorted(csum, req.top_p)) + 1
            keep = order[:cut]
            mask = np.zeros_like(p)
            mask[keep] = p[keep]
            p = mask / mask.sum()
        return int(self._rng.choice(len(p), p=p))

    def _flush_text(self, req: Request, token: int, final: bool) -> None:
        """Incremental detokenisation: emit the NEW chars of decode(out). A
        byte-level token can end mid-UTF-8 sequence, so a trailing
        replacement char is held back until the next token completes it
        (flushed as it is on ``final``)."""
        if req.on_token is None:
            return
        full = self.tokenizer.decode(req.out)
        if not final and full.endswith("�"):
            full = full[:-1]
        new = full[req.emitted_chars:]
        req.emitted_chars += len(new)
        req.on_token(token, new)

    def _push_token(self, slot: int, req: Request, token: int) -> None:
        """Record a freshly sampled token (fed to the model on the next
        decode step through cur_ids)."""
        if token in req.stop_ids:
            req.done = True
            req.finish_reason = "stop"
            if req.on_token is not None:
                held = self.tokenizer.decode(req.out)[req.emitted_chars:]
                if held:
                    req.emitted_chars += len(held)
                    req.on_token(None, held)   # flush held-back chars only
            self._free_slot_pages(slot)
            return
        req.out.append(token)
        req.ids.append(token)
        if len(req.out) >= req.max_new_tokens:
            req.done = True
            req.finish_reason = "length"
        elif len(req.ids) >= self.max_ctx:
            req.done = True
            req.finish_reason = "context"
        self._flush_text(req, token, final=req.done)
        if req.done:
            self._free_slot_pages(slot)
            return
        self.cur_ids[slot] = token

    def _ensure_growth_pages(self) -> None:
        """Every active slot whose next write crosses a page boundary needs
        a fresh page; preempt the youngest until all survivors have one."""
        while True:
            need: list[int] = []
            for slot, req in enumerate(self.slots):
                if req is None:
                    continue
                length = int(self.lens[slot])
                if length % self.page == 0:
                    logical = length // self.page
                    if self.tables[slot, logical] == 0:
                        need.append(slot)
            if self.slot_pages:   # partitioned: the page is always there
                for slot in need:
                    logical = int(self.lens[slot]) // self.page
                    self.tables[slot, logical] = 1 + slot * self.maxp + logical
                return
            if len(need) <= len(self._free):
                for slot in need:
                    logical = int(self.lens[slot]) // self.page
                    self.tables[slot, logical] = self._free.popleft()
                return
            if not self._preempt_youngest():
                raise RuntimeError("KV pool exhausted and nothing to preempt")

    def decode_options(self, active: np.ndarray) -> dict:
        """The route keywords of ``_paged_decode`` for this step; slot-major
        attention covers exactly the pages of the longest active context
        (one more page whenever a length crosses a page boundary)."""
        slot_cap = 0
        if self.attn_slot:
            mx = int(self.lens[active].max()) + 1
            slot_cap = min(-(-mx // self.page), self.maxp)
        return dict(kv_int8=self.kv_int8, scatter_fused=self.scatter_fused,
                    weights_int8=self.weights_int8, w8a8=self.w8a8,
                    mlp_fused=self.mlp_fused, layer_fused=self.layer_fused,
                    attn_batched=self.attn_batched, attn_slot=self.attn_slot,
                    slot_cap=slot_cap, ablate=self.ablate)

    def _active_mask(self) -> np.ndarray:
        return np.asarray(
            [r is not None and s not in self._prefilling
             for s, r in enumerate(self.slots)], bool)

    def step(self) -> int:
        """Admit pending work, stream one prefill chunk (chunked mode), run
        one decode step; → the number of slots progressed (0 = idle)."""
        self._admit()
        n_pre = self._prefill_step() if self.prefill_chunk else 0
        active = self._active_mask()
        if not active.any():
            return n_pre
        self._ensure_growth_pages()
        active = self._active_mask()   # preemption may have freed slots
        if not active.any():
            return n_pre
        logits = _paged_decode(
            self.params, self.k_pool, self.v_pool, self.k_scale, self.v_scale,
            self._dev(self.tables), self._dev(self.lens),
            self._dev(self.cur_ids), self._dev(active), self.cfg,
            self.use_kernel, self._rope, **self.decode_options(active))
        self.decode_steps += 1
        logits_np = logits.cpu().numpy()
        n = 0
        for slot, req in enumerate(self.slots):
            if req is None or slot in self._prefilling:
                continue
            n += 1
            self.lens[slot] += 1
            token = self._sample_row(logits_np[slot], req)
            self._push_token(slot, req, token)
        return n + n_pre

    # ------------------------------------------------------------ frontends
    def run_until_done(self, reqs: list[Request], max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if all(r.done for r in reqs):
                return
            if self.step() == 0:
                if all(r.done for r in reqs):
                    return
                with self._lock:
                    stuck = bool(self.pending)
                if stuck:
                    raise RuntimeError(
                        "pending request cannot be admitted (prompt bucket "
                        "exceeds the page pool)")
                raise RuntimeError("engine idle with unfinished requests")
        raise RuntimeError("max_steps exceeded")

    def generate(self, prompts: list[str], max_new_tokens: int = 128,
                 temperature: float = 0.0, stop_tokens=None) -> list[str]:
        reqs = [self.submit(p, max_new_tokens=max_new_tokens,
                            temperature=temperature, stop_tokens=stop_tokens)
                for p in prompts]
        self.run_until_done(reqs)
        return [self.tokenizer.decode(r.out) for r in reqs]

    @property
    def free_pages(self) -> int:
        if self.slot_pages:
            return self.maxp * sum(1 for r in self.slots if r is None)
        return len(self._free)


class EngineLoop:
    """Background continuous-batching loop around a :class:`PagedLLMEngine`.

    Serving threads call :meth:`submit_stream` and read ``(token_id, text)``
    tuples off the returned queue (``None`` ends a request); one daemon
    thread steps the engine whenever there is work, so requests arriving at
    any time join the in-flight decode batch. Kernels launch on that
    thread's current CUDA stream."""

    def __init__(self, engine: PagedLLMEngine):
        self.engine = engine
        self._wake = threading.Event()
        self._stop = False
        self._tracked: dict[int, tuple] = {}   # rid -> (Request, Queue)
        self._track_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.fatal: Optional[BaseException] = None

    def start(self) -> "EngineLoop":
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="llm-engine-loop")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def submit_stream(self, prompt: str, max_new_tokens: int = 128,
                      temperature: float = 0.0, top_p: float = 1.0,
                      top_k: int = 0, stop_tokens=None):
        """→ (Request, queue); the queue yields (token_id, text) per
        generated token and a final ``None``."""
        if self.fatal is not None:
            raise RuntimeError(
                "engine loop died; refusing new submissions"
            ) from self.fatal
        q: queue.Queue = queue.Queue()
        req = self.engine.submit(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, top_k=top_k, stop_tokens=stop_tokens,
            on_token=lambda tid, text: q.put((tid, text)),
        )
        with self._track_lock:
            self._tracked[req.rid] = (req, q)
        self._wake.set()
        return req, q

    def _run(self) -> None:
        while not self._stop:
            try:
                stepped = self.engine.step()
            except BaseException as exc:   # noqa: BLE001 — device errors too
                # a failed step must not strand submit_stream() consumers:
                # finish every tracked request with reason "error", deliver
                # the None sentinel, and refuse further submissions
                self.fatal = exc
                logger.exception("engine step failed; draining %d requests",
                                 len(self._tracked))
                with self._track_lock:
                    for r, q in self._tracked.values():
                        r.done = True
                        r.finish_reason = r.finish_reason or "error"
                        q.put(None)
                    self._tracked.clear()
                return
            with self._track_lock:
                finished = [rid for rid, (r, _) in self._tracked.items()
                            if r.done]
                for rid in finished:
                    self._tracked.pop(rid)[1].put(None)
            if stepped == 0:
                with self.engine._lock:
                    idle = not self.engine.pending
                if idle:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
