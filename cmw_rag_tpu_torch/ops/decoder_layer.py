"""Decoder-layer decode megakernel: a whole int8-weight decode layer in ONE
kernel launch (port of ``cmw_rag_tpu/ops/decoder_layer.py``).

The layer, for one new token per slot: attention RMSNorm → fused int8 QKV →
per-head q/k RMSNorm and rotate-half RoPE (through the ``c2``/``s2`` maps of
``make_rope_maps``) → the new K/V rows written into the pools IN PLACE (the
JAX kernel aliases them) → attention, slot-major over the partitioned
layout (``attn_slot``) or paged over ``tables`` → wo and the residual → the
fused MLP of ``ops/fused_mlp``. ``lens`` already counts the new token.

- ``decoder_layer_int8_xla`` (:70) is the golden: the engine's unfused XLA
  ops in float32.
- ``decoder_layer_int8_plain`` is the twin of the TPU kernel (:264, body
  ``_decoder_layer_kernel`` :143), whose rounding points it keeps: the
  normed input rounded to bf16 before the QKV product, q, k and v in
  float32 from it, q kept in float32 through norm and RoPE, k and v cast to
  the pool dtype, attention in float32, its output rounded to bf16 before
  wo, then the fused MLP's points (``ops.fused_mlp``).
- ``decoder_layer_int8`` is the wrapper. On CUDA tensors it launches the
  cooperative kernel of ``csrc/decoder_layer.cuh`` (on the weight phases
  of ``csrc/weight_phases.cuh``), built from
  ``csrc/decoder_layer.cu`` (x and pools bf16, Dh 64
  or 128, Hq / Hkv at most 8, D, Hq·Dh and F multiples of 64) and adds one
  to its ``launches`` count; on CPU tensors it runs the twin. There is no
  fallback. The launch follows the host plan ``weight_phases.layer_plan``
  (the splits of the four weight products, the ring of weight stages, the
  grid of one block a SM) and reads the weights through tensor maps
  encoded once a weight (``_weight_maps``). Its partial tiles, q, the
  attention output, x1, h and the counters live in the per-(device,
  stream) workspace it shares with the fused MLP
  (``weight_phases.workspace``), with
  the attention splits' partials and counters sized by
  ``paged_attention.split_scratch`` from the cap or the table width; the
  attention is split over positions (``paged_attention.ATTN_SPLIT``). The
  JAX signature's ``worklist``, ``block_f``, ``chunk`` and ``n_buf`` are
  TPU schedule and change nothing; the paged route reads
  ``tables`` (a keyword here) directly. ``batched`` (the TPU's cross-slot
  attention iterations, :213) is schedule too: the same kernel runs.
  ``ablate="noattn"`` (:213, :577; diagnosis only, wrong outputs on
  purpose) makes the attention output q, in the kernel and in the twin.

int8 KV pages (:422-650, engine ``layer_fused=True`` with
``kv_dtype="int8"``):

- ``decoder_layer_int8_kv8_xla`` (:422) is the golden: the engine's XLA
  int8-KV decode ops over the [L, P, Hkv] scales.
- ``decoder_layer_int8_kv8_plain`` is the twin of the TPU kernel (:618,
  body ``_decoder_layer_kv8_kernel`` :480): the rounding points above, and
  k (after norm and RoPE) and v rounded to x's dtype before the page's
  amax; the first row of a page (``off == 0``) sets its scale to
  ``max(amax, 1e-8) · KV_HEADROOM / 127``, other rows take the page's
  scale; rows quantized by division, round half to even and a clip to
  ±127; attention folds the scales into the float32 products, as the TPU's
  int8 pipeline does (no bf16 rounding of dequantized K and V).
- ``decoder_layer_int8_kv8`` is the wrapper: the same cooperative kernel
  instantiated for int8 pools (``csrc/decoder_layer_kv8.cu``, over the
  shared ``csrc/decoder_layer.cuh``), paged route only (as the TPU
  kernel). It takes THIS layer's scale planes in the engine's [P, Hkv]
  layout (JAX ships the head-major [Hkv, P] plane, the TPU's lane layout)
  and ``tables``, updates pools and planes in place and returns JAX's
  tuple ``(x_out, k_pools, k_scales, v_pools, v_scales)``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from cmw_rag_tpu_torch.device import need, on_cpu
from cmw_rag_tpu_torch.models.common import rms_norm
from cmw_rag_tpu_torch.ops import cuda_build
from cmw_rag_tpu_torch.ops import paged_attention as PA
from cmw_rag_tpu_torch.ops import weight_phases as WP
from cmw_rag_tpu_torch.ops.fused_mlp import fused_mlp_int8_xla, mlp_tail_plain
from cmw_rag_tpu_torch.ops.int8_matmul import int8_matmul_xla
from cmw_rag_tpu_torch.ops.paged_attention import (
    KV_HEADROOM, check_attention_shape, paged_decode_attention_xla,
    paged_decode_attention_xla_kv_int8, quantize_kv_token, slot_tables)


def make_rope_maps(cos: torch.Tensor, sin: torch.Tensor):
    """Full-head-width RoPE maps from half-width tables: rotate-half
    ``rope(x) = x·c2 + roll(x, Dh/2)·s2`` with c2 = [cos, cos] and
    s2 = [-sin, sin]. cos/sin [S, Dh/2] → float32 ([S, Dh], [S, Dh])."""
    c2 = torch.cat([cos, cos], dim=1).float().contiguous()
    s2 = torch.cat([-sin, sin], dim=1).float().contiguous()
    return c2, s2


def _rope_rows(t, cos, sin):
    half = t.shape[-1] // 2
    t1, t2 = t[..., :half], t[..., half:]
    c = cos[:, None, :].to(t.dtype)
    sn = sin[:, None, :].to(t.dtype)
    return torch.cat([t1 * c - t2 * sn, t2 * c + t1 * sn], dim=-1)


def decoder_layer_int8_xla(x, cos, sin, layer, page_idx, off, k_pools,
                           v_pools, tables, lens, li: int, hq: int, hkv: int,
                           dh: int, eps: float = 1e-6):
    """Golden: the engine's per-layer XLA decode ops; → (x_out, k_pools,
    v_pools), the pools written in place."""
    s = x.shape[0]
    y = rms_norm(x, layer["attn_norm"], eps=eps)
    qkv = int8_matmul_xla(y, layer["wqkv_q"], layer["wqkv_s"])
    q = qkv[:, : hq * dh].reshape(s, hq, dh)
    k = qkv[:, hq * dh:(hq + hkv) * dh].reshape(s, hkv, dh)
    v = qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)
    q = _rope_rows(rms_norm(q, layer["q_norm"], eps=eps), cos, sin)
    k = _rope_rows(rms_norm(k, layer["k_norm"], eps=eps), cos, sin)
    pi, of = page_idx.long(), off.long()
    k_pools[li, pi, of] = k.to(k_pools.dtype)
    v_pools[li, pi, of] = v.to(v_pools.dtype)
    attn = paged_decode_attention_xla(q, k_pools[li], v_pools[li], tables,
                                      lens)
    x_out = fused_mlp_int8_xla(
        x, attn.reshape(s, hq * dh).to(x.dtype), layer["wo_q"], layer["wo_s"],
        layer["ffn_norm"], layer["w_gateup_q"], layer["w_gateup_s"],
        layer["w_down_q"], layer["w_down_s"], eps=eps)
    return x_out, k_pools, v_pools


def _norm_rope(t, w, c2, s2, eps):
    """Per-head RMSNorm then rotate-half RoPE, float32 (the kernel's)."""
    n = t * torch.rsqrt(t.square().mean(dim=-1, keepdim=True) + eps) \
        * w.float()[None, None, :]
    return n * c2[:, None, :] + torch.roll(n, n.shape[-1] // 2, -1) \
        * s2[:, None, :]


def _front_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm,
                 hkv: int, dh: int, eps: float):
    """The kernel's phases 1-2 up to the pool write: → (x float32, q, k, v
    [S, H, Dh] float32), q and k normed and roped."""
    s = x.shape[0]
    hq = wqkv_q.shape[1] // dh - 2 * hkv
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
         * attn_norm.float()[None, :]).to(torch.bfloat16).float()
    qkv = (y @ wqkv_q.float()) * wqkv_s[None, :]
    q = _norm_rope(qkv[:, : hq * dh].reshape(s, hq, dh), q_norm, c2, s2, eps)
    k = _norm_rope(qkv[:, hq * dh:(hq + hkv) * dh].reshape(s, hkv, dh),
                   k_norm, c2, s2, eps)
    v = qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)
    return xf, q, k, v


def _back_plain(xf, aout, wo_q, wo_s, ffn_norm, gateup_q, gateup_s, down_q,
                down_s, eps: float, dtype):
    """The attention output rounded to bf16, wo, the residual, the MLP."""
    a = aout.reshape(xf.shape[0], -1).to(torch.bfloat16).float()
    x1 = xf + (a @ wo_q.float()) * wo_s[None, :]
    return mlp_tail_plain(x1, ffn_norm, gateup_q, gateup_s, down_q, down_s,
                          eps, dtype)


def decoder_layer_int8_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm,
                             k_norm, wo_q, wo_s, ffn_norm, gateup_q, gateup_s,
                             down_q, down_s, page_idx, off, k_pools, v_pools,
                             lens, layer: int, tables=None,
                             attn_slot: bool = False, slot_cap: int = 0,
                             slot_maxp: int = 0, slot_base: int = 1,
                             eps: float = 1e-6, ablate: str = ""):
    """Twin of the kernel (the rounding points in the module docstring);
    → (x_out, k_pools, v_pools), the pools written in place."""
    hkv, dh = k_pools.shape[3], k_pools.shape[4]
    xf, q, k, v = _front_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm,
                               k_norm, hkv, dh, eps)
    pi, of = page_idx.long(), off.long()
    k_pools[layer, pi, of] = k.to(k_pools.dtype)
    v_pools[layer, pi, of] = v.to(v_pools.dtype)
    if ablate == "noattn":
        aout = q
    else:
        if attn_slot:
            tables = slot_tables(x.shape[0], slot_cap, slot_maxp, slot_base,
                                 x.device)
        aout = paged_decode_attention_xla(q, k_pools[layer], v_pools[layer],
                                          tables, lens)
    x_out = _back_plain(xf, aout, wo_q, wo_s, ffn_norm, gateup_q, gateup_s,
                        down_q, down_s, eps, x.dtype)
    return x_out, k_pools, v_pools


def decoder_layer_int8_kv8_xla(x, cos, sin, layer, page_idx, off, k_pools,
                               k_scales, v_pools, v_scales, tables, lens,
                               li: int, hq: int, hkv: int, dh: int,
                               eps: float = 1e-6):
    """Golden: the engine's XLA int8-KV decode ops over the [L, P, Hkv]
    scales; → (x_out, k_pools, k_scales, v_pools, v_scales), all written
    in place."""
    s = x.shape[0]
    y = rms_norm(x, layer["attn_norm"], eps=eps)
    qkv = int8_matmul_xla(y, layer["wqkv_q"], layer["wqkv_s"])
    q = qkv[:, : hq * dh].reshape(s, hq, dh)
    k = qkv[:, hq * dh:(hq + hkv) * dh].reshape(s, hkv, dh)
    v = qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)
    q = _rope_rows(rms_norm(q, layer["q_norm"], eps=eps), cos, sin)
    k = _rope_rows(rms_norm(k, layer["k_norm"], eps=eps), cos, sin)
    pi, of = page_idx.long(), off.long()
    fresh = (of == 0)[:, None]
    for pools, scales, t in ((k_pools, k_scales, k), (v_pools, v_scales, v)):
        amax = t.float().abs().amax(dim=-1)
        new = torch.where(fresh, torch.clamp(amax, min=1e-8)
                          * (KV_HEADROOM / 127.0), scales[li, pi])
        pools[li, pi, of] = quantize_kv_token(t, new)
        scales[li, pi] = new
    attn = paged_decode_attention_xla_kv_int8(
        q, k_pools[li], k_scales[li], v_pools[li], v_scales[li], tables, lens)
    x_out = fused_mlp_int8_xla(
        x, attn.reshape(s, hq * dh).to(x.dtype), layer["wo_q"], layer["wo_s"],
        layer["ffn_norm"], layer["w_gateup_q"], layer["w_gateup_s"],
        layer["w_down_q"], layer["w_down_s"], eps=eps)
    return x_out, k_pools, k_scales, v_pools, v_scales


def decoder_layer_int8_kv8_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s,
                                 q_norm, k_norm, wo_q, wo_s, ffn_norm,
                                 gateup_q, gateup_s, down_q, down_s, page_idx,
                                 off, k_pools, k_scales, v_pools, v_scales,
                                 lens, layer: int, tables, eps: float = 1e-6,
                                 ablate: str = ""):
    """Twin of the int8-KV kernel over this layer's [P, Hkv] scale planes;
    → (x_out, k_pools, k_scales, v_pools, v_scales), pools and planes
    written in place."""
    hkv, dh = k_pools.shape[3], k_pools.shape[4]
    xf, q, k, v = _front_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm,
                               k_norm, hkv, dh, eps)
    pi, of = page_idx.long(), off.long()
    fresh = (of == 0)[:, None]
    for pools, plane, t in ((k_pools, k_scales, k), (v_pools, v_scales, v)):
        t = t.to(x.dtype).float()                  # the residual's dtype
        new = torch.where(fresh, torch.clamp(t.abs().amax(dim=-1), min=1e-8)
                          * (KV_HEADROOM / 127.0), plane[pi])
        pools[layer, pi, of] = quantize_kv_token(t, new)
        plane[pi] = new
    if ablate == "noattn":
        aout = q
    else:
        kd = k_pools[layer].float() * k_scales[:, None, :, None]
        vd = v_pools[layer].float() * v_scales[:, None, :, None]
        aout = paged_decode_attention_xla(q, kd, vd, tables, lens)
    x_out = _back_plain(xf, aout, wo_q, wo_s, ffn_norm, gateup_q, gateup_s,
                        down_q, down_s, eps, x.dtype)
    return x_out, k_pools, k_scales, v_pools, v_scales


#: grid-wide waits a layer: attention -> wo, wo -> the FFN norm, gate/up
#: -> down (attention waits on counters of its head group's QKV merges)
GRID_WAITS = 3


def layer_workspace(plan: WP.LayerPlan, s: int, d: int, hq: int, hkv: int,
                    dh: int, f: int) -> tuple[tuple[int, ...], int]:
    """Float32 words of each workspace buffer the kernel reads and writes
    (the split partial tiles, h as bf16, q, the attention output, x1; each
    a multiple of 4 words, so that every buffer starts 16-byte aligned) and
    the int32 counters (the products' arrival counters, then the head
    groups')."""
    a = hq * dh
    sizes = (WP.part_words(plan), -(-s * f // 2), s * a, s * a, s * d)
    counts = WP.tile_counters(plan) + plan.mtiles * hkv
    return tuple(-(-n // 4) * 4 for n in sizes), counts


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device, mt: int, dh: int, kv8: bool) -> int:
    """Blocks of the cooperative launch: all that can be resident at once
    at the most shared memory the plan gives the row tile (one a SM)."""
    with torch.cuda.device(device):
        n = _entry(kv8, "blocks")(mt, dh)
    if n <= 0:
        raise RuntimeError(f"decoder_layer_int8: occupancy query failed ({n})")
    return n


_ENTRIES = {False: ("decoder_layer", "decoder_layer_int8",
                    "decoder_layer_blocks", "decoder_layer_encode"),
            True: ("decoder_layer_kv8", "decoder_layer_int8_kv8",
                   "decoder_layer_kv8_blocks", "decoder_layer_kv8_encode")}


def _entry(kv8: bool, which: str):
    """The C function ``which`` ("layer", "blocks" or "encode") of the
    library for bf16 pools (``csrc/decoder_layer.cu``) or int8 pools
    (``csrc/decoder_layer_kv8.cu``)."""
    stem, *names = _ENTRIES[kv8]
    lib = cuda_build.library(stem)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        layer, blocks, encode = (getattr(lib, n) for n in names)
        layer.argtypes = ([p] * 22 + [i] * 11 + [f] + [i] * 4 + [p] * 8
                          + [i] * 3 + [p] * 4 + [i] * 2 + [p])
        layer.restype = ctypes.c_int
        blocks.argtypes = [i, i]
        blocks.restype = ctypes.c_int
        encode.argtypes = [p, i, i, p]
        encode.restype = ctypes.c_int
        lib._typed = True
    return getattr(lib, names[("layer", "blocks", "encode").index(which)])


def _weight_maps(kv8: bool, weights) -> ctypes.Array:
    """The four weights' tensor maps (QKV, wo, gate/up, down), 4 x 128
    bytes, each encoded once a weight (``weight_phases.weight_maps``)."""
    return WP.weight_maps(_entry(kv8, "encode"), weights,
                          "decoder_layer_int8")


def _check_ablate(ablate: str) -> None:
    if ablate not in ("", "noattn"):
        raise ValueError(f"ablate={ablate!r}: the megakernels take '' or "
                         f"'noattn'")


def launch_config(s: int, d: int, hq: int, hkv: int, dh: int, f: int,
                  page: int, width: int, blocks: int):
    """What a launch needs from the host: the plan, the workspace's float32
    buffers and counters (``layer_workspace``), attention's splits (each
    (slot, KV head) of at most ``width`` pages), its partials' floats and
    counters. → (plan, float sizes, n_split, attention floats, counters in
    all)."""
    plan = WP.layer_plan(s, d, hq, hkv, dh, f, blocks)
    sizes, counts = layer_workspace(plan, s, d, hq, hkv, dh, f)
    n_split, part_shape, n_attn = PA.split_scratch(
        s, hkv, hq // hkv, dh, width * page, PA.ATTN_SPLIT)
    return (plan, sizes, n_split, -(-math.prod(part_shape) // 4) * 4,
            counts + n_attn)


def _launch(x, c2, s2, weights, page_idx, off, k_pools, v_pools, lens,
            layer: int, tables, slot, eps: float, ablate: str,
            k_scales=None, v_scales=None) -> torch.Tensor:
    """Check every operand and launch the kernel; ``slot`` is (slot_cap,
    slot_maxp, slot_base) for the slot-major route, else None; int8 pools
    come with this layer's [P, Hkv] scale planes. → x_out."""
    (attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s, ffn_norm,
     gateup_q, gateup_s, down_q, down_s) = weights
    if k_pools.dim() != 5 or not 0 <= layer < k_pools.shape[0]:
        raise ValueError(f"layer {layer} of a pool shaped "
                         f"{tuple(k_pools.shape)}")
    s, d = x.shape
    n_layers, n_pages, page, hkv, dh = k_pools.shape
    a3 = wqkv_q.shape[1]
    hq = a3 // dh - 2 * hkv
    a, f = hq * dh, down_q.shape[0]
    kv8 = k_scales is not None
    check_attention_shape(hq, hkv, dh)
    need(x, "x", torch.bfloat16, (s, d))
    for name, t in (("c2", c2), ("s2", s2)):
        need(t, name, torch.float32, (s, dh))
    need(wqkv_q, "wqkv_q", torch.int8, (d, (hq + 2 * hkv) * dh))
    need(wo_q, "wo_q", torch.int8, (a, d))
    need(gateup_q, "gateup_q", torch.int8, (d, 2 * f))
    need(down_q, "down_q", torch.int8, (f, d))
    for name, t, n in (("attn_norm", attn_norm, d), ("wqkv_s", wqkv_s, a3),
                       ("q_norm", q_norm, dh), ("k_norm", k_norm, dh),
                       ("wo_s", wo_s, d), ("ffn_norm", ffn_norm, d),
                       ("gateup_s", gateup_s, 2 * f), ("down_s", down_s, d)):
        need(t, name, torch.float32, (n,))
    for name, t in (("page_idx", page_idx), ("off", off), ("lens", lens)):
        need(t, name, torch.int32, (s,))
    pool_dtype = torch.int8 if kv8 else torch.bfloat16
    need(k_pools, "k_pools", pool_dtype, k_pools.shape)
    need(v_pools, "v_pools", pool_dtype, k_pools.shape)
    for name, t in ((("k_scales", k_scales), ("v_scales", v_scales))
                    if kv8 else ()):
        # a layer's plane of the engine's [L, P, Hkv] scales: floats, read
        # one at a time, so 4-byte alignment is enough
        if (t.dtype != torch.float32 or tuple(t.shape) != (n_pages, hkv)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: float32 [{n_pages}, {hkv}] contiguous "
                             f"expected, got {t.dtype} {tuple(t.shape)}")
    if d % WP.LAYER_ROWS or a % WP.LAYER_ROWS or f % WP.LAYER_ROWS:
        raise ValueError(f"D={d}, Hq*Dh={a} and F={f} must be multiples of "
                         f"{WP.LAYER_ROWS}")
    if slot is not None:
        slot_cap, slot_maxp, slot_base = slot
        maxp = 0
        if (slot_cap < 1 or slot_base < 0
                or slot_base + (s - 1) * slot_maxp + slot_cap > n_pages):
            raise ValueError(f"{s} partitions of {slot_maxp} pages from page "
                             f"{slot_base}, cap {slot_cap}, overrun a pool of "
                             f"{n_pages}")
    else:
        slot_cap, slot_maxp, slot_base = 0, 0, 1
        maxp = tables.shape[1]
        need(tables, "tables", torch.int32, (s, maxp))
    dev = x.device
    plan, sizes, n_split, n_attn, n_counts = launch_config(
        s, d, hq, hkv, dh, f, page, slot_cap if slot is not None else maxp,
        _grid(dev, WP.layer_tile(s), dh, kv8))
    maps = _weight_maps(kv8, (wqkv_q, wo_q, gateup_q, down_q))
    out = torch.empty_like(x)
    stride = n_pages * page * hkv * dh * k_pools.element_size()  # one layer
    kl = k_pools.data_ptr() + layer * stride
    vl = v_pools.data_ptr() + layer * stride
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # float32 words: the partial tiles, h, q, the attention output, x1,
        # attention's split partials; int32: the products' and head groups'
        # counters, then attention's
        floats, counts = WP.workspace(dev, stream, sum(sizes) + n_attn,
                                      n_counts)
        part_a, part_b, qbuf, aout, x1, attn_part = (
            floats.data_ptr() + 4 * o
            for o in itertools.accumulate((0,) + sizes))
        n_layer_counts = n_counts - s * hkv
        attn_count = counts.data_ptr() + 4 * n_layer_counts
        ks = [q.ks for q in plan.products]
        err = _entry(kv8, "layer")(
            x.data_ptr(), c2.data_ptr(), s2.data_ptr(), attn_norm.data_ptr(),
            wqkv_q.data_ptr(), wqkv_s.data_ptr(), q_norm.data_ptr(),
            k_norm.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(),
            ffn_norm.data_ptr(), gateup_q.data_ptr(), gateup_s.data_ptr(),
            down_q.data_ptr(), down_s.data_ptr(), page_idx.data_ptr(),
            off.data_ptr(), kl, vl, lens.data_ptr(),
            None if slot is not None else tables.data_ptr(), part_a,
            s, d, hq, hkv, dh, f, page, maxp, slot_cap, slot_maxp, slot_base,
            eps, *ks, part_b, qbuf, aout, x1, None,
            out.data_ptr(), k_scales.data_ptr() if kv8 else None,
            v_scales.data_ptr() if kv8 else None, int(ablate == "noattn"),
            PA.ATTN_SPLIT, n_split, attn_part, attn_count, maps,
            counts.data_ptr(), plan.ring, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"decoder_layer_int8 launch failed: CUDA error "
                           f"{err}")
    return out


def decoder_layer_int8(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm,
                       wo_q, wo_s, ffn_norm, gateup_q, gateup_s, down_q,
                       down_s, page_idx, off, k_pools, v_pools, lens,
                       worklist=None, layer: int = 0, block_f: int = 768,
                       chunk: int = 1, eps: float = 1e-6, n_buf: int = 2,
                       ablate: str = "", batched: bool = False,
                       attn_slot: bool = False, slot_cap: int = 0,
                       slot_maxp: int = 0, slot_base: int = 1, tables=None):
    """One fused decoder-layer decode step over layer ``layer`` of the
    pools [L, P, page, Hkv, Dh]; → (x_out, k_pools, v_pools), the pools
    updated in place. ``page_idx``/``off`` [S] name each slot's new row;
    slot-major attention (``attn_slot``) reads ``slot_cap`` pages of slot
    s's partition ``slot_base + s * slot_maxp + j``, the paged route reads
    ``tables`` [S, maxp] (``batched`` changes nothing)."""
    if not attn_slot and tables is None:
        raise ValueError("the paged route needs tables")
    _check_ablate(ablate)
    weights = (attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s,
               ffn_norm, gateup_q, gateup_s, down_q, down_s)
    rest = (page_idx, off, k_pools, v_pools, lens)
    if on_cpu(x, c2, s2, *weights, *rest,
              *(() if tables is None else (tables,))):
        return decoder_layer_int8_plain(
            x, c2, s2, *weights, *rest, layer=layer, tables=tables,
            attn_slot=attn_slot, slot_cap=slot_cap, slot_maxp=slot_maxp,
            slot_base=slot_base, eps=eps, ablate=ablate)
    out = _launch(x, c2, s2, weights, page_idx, off, k_pools, v_pools, lens,
                  layer, tables,
                  (slot_cap, slot_maxp, slot_base) if attn_slot else None,
                  eps, ablate)
    decoder_layer_int8.launches += 1
    return out, k_pools, v_pools


def decoder_layer_int8_kv8(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm,
                           k_norm, wo_q, wo_s, ffn_norm, gateup_q, gateup_s,
                           down_q, down_s, page_idx, off, k_pools, k_scales,
                           v_pools, v_scales, lens, worklist=None,
                           layer: int = 0, block_f: int = 512, chunk: int = 1,
                           eps: float = 1e-6, n_buf: int = 3,
                           ablate: str = "", tables=None):
    """The int8-KV megakernel over layer ``layer`` of int8 pools
    [L, P, page, Hkv, Dh], with THIS layer's scale planes ``k_scales``,
    ``v_scales`` [P, Hkv] and the block table ``tables`` [S, maxp]; →
    (x_out, k_pools, k_scales, v_pools, v_scales), pools and planes
    updated in place."""
    if tables is None:
        raise ValueError("the int8-KV megakernel needs tables (paged route)")
    _check_ablate(ablate)
    weights = (attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s,
               ffn_norm, gateup_q, gateup_s, down_q, down_s)
    rest = (page_idx, off, k_pools, k_scales, v_pools, v_scales, lens)
    if on_cpu(x, c2, s2, *weights, *rest, tables):
        return decoder_layer_int8_kv8_plain(
            x, c2, s2, *weights, *rest, layer=layer, tables=tables, eps=eps,
            ablate=ablate)
    out = _launch(x, c2, s2, weights, page_idx, off, k_pools, v_pools, lens,
                  layer, tables, None, eps, ablate, k_scales, v_scales)
    decoder_layer_int8_kv8.launches += 1
    return out, k_pools, k_scales, v_pools, v_scales


decoder_layer_int8.launches = 0
decoder_layer_int8_kv8.launches = 0
