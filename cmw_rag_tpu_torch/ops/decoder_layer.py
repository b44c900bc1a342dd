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
  cooperative kernel of ``csrc/decoder_layer.cu`` (x and pools bf16, Dh 64
  or 128, Hq / Hkv at most 8, D, Hq·Dh and F multiples of 64) and adds one
  to its ``launches`` count; on CPU tensors it runs the twin. There is no
  fallback. The JAX signature's ``worklist``, ``block_f``, ``chunk`` and
  ``n_buf`` are TPU schedule and change nothing; the paged route reads
  ``tables`` (a keyword here) directly. ``batched`` and ``ablate`` raise
  ``NotImplementedError`` (``ROADMAP.md`` Queue 2 #9).

The int8-KV megakernel (:618) waits for the next slice (Queue 2 #8).
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from cmw_rag_tpu_torch.device import need, on_cpu
from cmw_rag_tpu_torch.models.common import rms_norm
from cmw_rag_tpu_torch.ops import cuda_build
from cmw_rag_tpu_torch.ops.fused_mlp import (fused_mlp_int8_xla, mlp_splits,
                                             mlp_tail_plain)
from cmw_rag_tpu_torch.ops.int8_matmul import (K_TILE, N_TILE,
                                               int8_matmul_xla, k_split,
                                               m_tile)
from cmw_rag_tpu_torch.ops.paged_attention import (check_attention_shape,
                                                   paged_decode_attention_xla,
                                                   slot_tables)


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


def decoder_layer_int8_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm,
                             k_norm, wo_q, wo_s, ffn_norm, gateup_q, gateup_s,
                             down_q, down_s, page_idx, off, k_pools, v_pools,
                             lens, layer: int, tables=None,
                             attn_slot: bool = False, slot_cap: int = 0,
                             slot_maxp: int = 0, slot_base: int = 1,
                             eps: float = 1e-6):
    """Twin of the kernel (the rounding points in the module docstring);
    → (x_out, k_pools, v_pools), the pools written in place."""
    s = x.shape[0]
    hkv, dh = k_pools.shape[3], k_pools.shape[4]
    hq = wqkv_q.shape[1] // dh - 2 * hkv
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
         * attn_norm.float()[None, :]).to(torch.bfloat16).float()
    qkv = (y @ wqkv_q.float()) * wqkv_s[None, :]
    q = _norm_rope(qkv[:, : hq * dh].reshape(s, hq, dh), q_norm, c2, s2, eps)
    k = _norm_rope(qkv[:, hq * dh:(hq + hkv) * dh].reshape(s, hkv, dh),
                   k_norm, c2, s2, eps)
    v = qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)
    pi, of = page_idx.long(), off.long()
    k_pools[layer, pi, of] = k.to(k_pools.dtype)
    v_pools[layer, pi, of] = v.to(v_pools.dtype)
    if attn_slot:
        tables = slot_tables(s, slot_cap, slot_maxp, slot_base, x.device)
    aout = paged_decode_attention_xla(q, k_pools[layer], v_pools[layer],
                                      tables, lens)
    a = aout.reshape(s, hq * dh).to(torch.bfloat16).float()
    x1 = xf + (a @ wo_q.float()) * wo_s[None, :]
    x_out = mlp_tail_plain(x1, ffn_norm, gateup_q, gateup_s, down_q, down_s,
                           eps, x.dtype)
    return x_out, k_pools, v_pools


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device, mt: int, dh: int) -> int:
    """Blocks of the cooperative launch: all that can be resident at once."""
    with torch.cuda.device(device):
        n = _lib().decoder_layer_blocks(mt, dh)
    if n <= 0:
        raise RuntimeError(f"decoder_layer_int8: occupancy query failed ({n})")
    return n


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("decoder_layer")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decoder_layer_int8.argtypes = ([p] * 22 + [i] * 11 + [f]
                                           + [i] * 4 + [p] * 7)
        lib.decoder_layer_int8.restype = ctypes.c_int
        lib.decoder_layer_blocks.argtypes = [i, i]
        lib.decoder_layer_blocks.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    ``tables`` [S, maxp]."""
    if batched or ablate:
        raise NotImplementedError(
            "batched attention and ablations of the megakernel are not "
            "ported: ROADMAP.md Queue 2 #9")
    if not attn_slot and tables is None:
        raise ValueError("the paged route needs tables")
    weights = (attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s,
               ffn_norm, gateup_q, gateup_s, down_q, down_s)
    rest = (page_idx, off, k_pools, v_pools, lens)
    if on_cpu(x, c2, s2, *weights, *rest,
              *(() if tables is None else (tables,))):
        return decoder_layer_int8_plain(
            x, c2, s2, *weights, *rest, layer=layer, tables=tables,
            attn_slot=attn_slot, slot_cap=slot_cap, slot_maxp=slot_maxp,
            slot_base=slot_base, eps=eps)
    if k_pools.dim() != 5 or not 0 <= layer < k_pools.shape[0]:
        raise ValueError(f"layer {layer} of a pool shaped "
                         f"{tuple(k_pools.shape)}")
    s, d = x.shape
    n_layers, n_pages, page, hkv, dh = k_pools.shape
    a3 = wqkv_q.shape[1]
    hq = a3 // dh - 2 * hkv
    a, f = hq * dh, down_q.shape[0]
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
    need(k_pools, "k_pools", torch.bfloat16, k_pools.shape)
    need(v_pools, "v_pools", torch.bfloat16, k_pools.shape)
    if d % K_TILE or a % K_TILE or f % K_TILE:
        raise ValueError(f"D={d}, Hq*Dh={a} and F={f} must be multiples of "
                         f"{K_TILE}")
    if attn_slot:
        maxp = 0
        if (slot_cap < 1 or slot_base < 0
                or slot_base + (s - 1) * slot_maxp + slot_cap > n_pages):
            raise ValueError(f"{s} partitions of {slot_maxp} pages from page "
                             f"{slot_base}, cap {slot_cap}, overrun a pool of "
                             f"{n_pages}")
    else:
        maxp = tables.shape[1]
        need(tables, "tables", torch.int32, (s, maxp))
    mt = m_tile(s)
    blocks = _grid(x.device, mt, dh)
    mtiles = -(-s // mt)
    ks_qkv = k_split(d, mtiles * -(-a3 // N_TILE), blocks)
    ks_wo, ks_gu, ks_dn = mlp_splits(s, d, f, a, blocks)
    dev = x.device
    # one float32 scratch: partial sums (two), q, the attention output, x1, y
    sizes = (max(ks_qkv * a3, ks_wo * d, ks_dn * d) * s, ks_gu * s * 2 * f,
             s * a, s * a, s * d, s * d)
    scratch = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    part_a, part_b, qbuf, aout, x1, ybuf = (
        scratch.data_ptr() + 4 * o
        for o in itertools.accumulate((0,) + sizes[:-1]))
    out = torch.empty_like(x)
    stride = n_pages * page * hkv * dh * 2      # bytes of one layer's pool
    kl = k_pools.data_ptr() + layer * stride
    vl = v_pools.data_ptr() + layer * stride
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().decoder_layer_int8(
            x.data_ptr(), c2.data_ptr(), s2.data_ptr(), attn_norm.data_ptr(),
            wqkv_q.data_ptr(), wqkv_s.data_ptr(), q_norm.data_ptr(),
            k_norm.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(),
            ffn_norm.data_ptr(), gateup_q.data_ptr(), gateup_s.data_ptr(),
            down_q.data_ptr(), down_s.data_ptr(), page_idx.data_ptr(),
            off.data_ptr(), kl, vl, lens.data_ptr(),
            None if attn_slot else tables.data_ptr(), part_a,
            s, d, hq, hkv, dh, f, page, maxp,
            slot_cap if attn_slot else 0, slot_maxp, slot_base, eps,
            ks_qkv, ks_wo, ks_gu, ks_dn, part_b, qbuf, aout, x1, ybuf,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decoder_layer_int8 launch failed: CUDA error "
                           f"{err}")
    decoder_layer_int8.launches += 1
    return out, k_pools, v_pools


decoder_layer_int8.launches = 0
