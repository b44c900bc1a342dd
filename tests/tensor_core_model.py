"""The decoder-layer megakernels' QKV product as the card's tensor cores
compute it, for the card tests' reference.

``mma.sync`` m16n8k16 with float32 sums does not round each product and
sum the IEEE way: each k16 step's 16 products and the accumulator are
aligned to the largest exponent among them, cut toward zero 26 bits below
its leading bit, summed, and the sum is rounded toward zero to float32.
The megakernel takes the QKV product over its split items, warp halves
and k16 steps in a fixed order (``csrc/weight_phases.cuh``), so its q, k
and v differ from the plain twin's IEEE float32 product in the last bits,
and a bf16 rounding downstream (y, h, the output) can then land one step
apart and move every product it feeds. ``tensor_core_qkv`` models the
product in the kernel's order (26 bits below the leading bit, cut toward
zero: of the variants tried on the card, 24 to 28 bits, groups of 4, 8 or
16 products, cut toward -inf, the sum rounded to nearest, the closest,
all but 2 to 19 of 32,768 q elements), ``kernel_order_heads`` the head
norm and RoPE in the kernel's order (a lane's chain of fused squares and
a butterfly; RoPE with its first product fused), and
``kernel_order_attention`` decode attention in ``attend_split``'s order.
``run_twin`` runs the plain twin (``ops/decoder_layer.py``) with its
front and its attention replaced by these, the rest as it is.
The reference is held against the plain IEEE twin at a stated bound:
their attention outputs, rounded to bf16, part by at most
``ATTENTION_STEPS`` bf16 step at the largest |value| of each (row, head)
(``head_steps_apart``; the largest measured over the card tests' cases
and 9 more seeds, ``tests/twin_margins.py``), and their layer outputs by
at most that gap carried through wo and the MLP (``carried_step_bound``).
"""

from __future__ import annotations

import contextlib
import math
from unittest import mock

import torch

from cmw_rag_tpu_torch.ops import decoder_layer as DL
from cmw_rag_tpu_torch.ops import paged_attention as PA
from cmw_rag_tpu_torch.ops import weight_phases as WP


def bf16_step(x):
    """One bf16 step at |x| (0 at 0)."""
    x = x.float()
    step = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
    return torch.where(x == 0, torch.zeros_like(x), step)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _butterfly(v, width: int):
    lane = torch.arange(width, device=v.device)
    o = width // 2
    while o:
        v = v + v[..., lane ^ o]
        o //= 2
    return v[..., 0]


def _toward_zero(x64):
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def tensor_core_qkv(y, wq, ks: int, bits: int = 26):
    """The QKV product in the megakernel's order under the model above:
    y [S, K] (bf16 values), wq [K, N] int8, ``ks`` splits of the
    contraction; → [S, N] float32 sums before the scale."""
    s, k = y.shape
    steps = k // 64
    yd, wd = y.double(), wq.double()
    total = torch.zeros((s, wq.shape[1]), dtype=torch.float32,
                        device=y.device)
    for ki in range(ks):
        halves = []
        for kh in range(2):
            acc = torch.zeros_like(total)
            for st in range(ki * steps // ks, (ki + 1) * steps // ks):
                for j in range(2):
                    r0 = st * 64 + 32 * kh + 16 * j
                    terms = torch.cat([yd[:, r0:r0 + 16, None]
                                       * wd[None, r0:r0 + 16, :],
                                       acc.double()[:, None, :]], dim=1)
                    _, e = torch.frexp(terms.abs().amax(dim=1))
                    grid = torch.ldexp(torch.ones_like(terms[:, 0]),
                                       e - bits)[:, None]
                    acc = _toward_zero(
                        (torch.trunc(terms / grid) * grid).sum(dim=1))
            halves.append(acc)
        total = total + (halves[0] + halves[1])
    return total


def kernel_order_heads(t, norm_w, c2, s2, heads: int, dh: int, eps: float):
    """Heads [S, heads * Dh] of the QKV sums normed and roped as the
    megakernel's merge forms them: → [S, heads, Dh] float32."""
    s = t.shape[0]
    t = t.reshape(s, heads, dh)
    v = t.reshape(s, heads, 32, dh // 32)
    ss = torch.zeros((s, heads, 32), device=t.device)
    for e in range(dh // 32):
        ss = _fma(v[..., e], v[..., e], ss)
    n = t * torch.rsqrt(_butterfly(ss, 32) / dh + eps)[..., None] \
        * norm_w.float()
    part = torch.roll(n, dh // 2, -1)
    return _fma(n, c2[:, None, :].expand_as(n), part * s2[:, None, :])


def kernel_order_q(qkv, q_norm, c2, s2, hq: int, dh: int, eps: float):
    """q from the QKV sums (``kernel_order_heads`` of the first Hq heads)."""
    return kernel_order_heads(qkv[:, :hq * dh], q_norm, c2, s2, hq, dh, eps)


def kernel_order_attention(q, k_pool, v_pool, tables, lens, split: int,
                           k_scale=None, v_scale=None):
    """Decode attention as the megakernel's ``attend_split``
    (``csrc/int8_decode.cuh``) orders it: q [S, Hq, Dh] float32 over one
    layer's pools [P, page, Hkv, Dh] (bf16, or int8 with [P, Hkv]
    scales), splits of ``split`` positions. A score is a chain of eight
    fused products a thread, a butterfly over the row's Dh / 8 threads,
    times the page's scale and rsqrt(Dh); each split's softmax sums e^(s -
    m) a lane at a time and by a butterfly; its output sums, a group of
    rows at a time, fused products of (p x scale) and the row, then the
    groups in order; the splits merge in order (given the kernel's own q,
    bit for bit the kernel's on the card): → [S, Hq, Dh] float32."""
    s_n, hq, dh = q.shape
    page, hkv = k_pool.shape[1], k_pool.shape[2]
    rep, tpr = hq // hkv, dh // 8
    ng = 256 // tpr                      # row groups of the 256 threads
    # rsqrtf(Dh) of a constant Dh: folded by the compiler, rounded once
    inv = torch.tensor(1.0 / math.sqrt(dh), device=q.device)
    out = torch.empty_like(q)
    for si in range(s_n):
        n = int(lens[si])
        pos = torch.arange(n, device=q.device)
        pg = tables[si].long()[pos // page]
        kf, vf = k_pool[pg, pos % page].float(), v_pool[pg, pos % page].float()
        ks = (torch.ones((n, hkv), device=q.device) if k_scale is None
              else k_scale[pg])
        vs = (torch.ones((n, hkv), device=q.device) if v_scale is None
              else v_scale[pg])
        qc = q[si].reshape(hkv, rep, tpr, 8)
        kc = kf.reshape(n, hkv, 1, tpr, 8)
        d = torch.zeros((n, hkv, rep, tpr), device=q.device)
        for e in range(8):
            d = _fma(qc[None, ..., e], kc[..., e], d)
        sc = _butterfly(d, tpr) * ks[:, :, None] * inv     # [n, hkv, rep]
        parts = []
        for a in range(0, n, split):
            sj = sc[a:a + split]
            rows = sj.shape[0]
            mx = sj.amax(0)
            pr = torch.exp(sj - mx)
            lanes = torch.zeros((32,) + mx.shape, device=q.device)
            for t0 in range(0, rows, 32):
                c = pr[t0:t0 + 32]
                lanes[:c.shape[0]] = lanes[:c.shape[0]] + c
            l_sum = _butterfly(lanes.permute(1, 2, 0), 32)
            w = pr * vs[a:a + rows, :, None]
            acc = torch.zeros((ng, hkv, rep, dh), device=q.device)
            for t0 in range(0, rows, ng):
                c = min(ng, rows - t0)
                acc[:c] = _fma(w[t0:t0 + c, :, :, None],
                               vf[a + t0:a + t0 + c, :, None, :], acc[:c])
            red = torch.zeros((hkv, rep, dh), device=q.device)
            for i in range(ng):
                red = red + acc[i]
            parts.append((mx, l_sum, red))
        if len(parts) == 1:
            o = parts[0][2] / parts[0][1].clamp_min(1e-30)[..., None]
        else:
            top = torch.stack([m for m, _, _ in parts]).amax(0)
            num = torch.zeros_like(parts[0][2])
            den = torch.zeros_like(parts[0][1])
            for m, l_sum, red in parts:
                w = torch.exp(m - top)
                num = _fma(w[..., None].expand_as(red), red, num)
                den = _fma(w, l_sum, den)
            o = num / den.clamp_min(1e-30)[..., None]
        out[si] = o.reshape(hq, dh)
    return out


def qkv_splits(device, s: int, d: int, hq: int, hkv: int, dh: int, f: int,
               kv8: bool) -> int:
    """Splits of the contraction the megakernel's plan gives the QKV
    product at ``s`` rows on ``device``."""
    blocks = DL._grid(device, WP.layer_tile(s), dh, kv8)
    return WP.layer_plan(s, d, hq, hkv, dh, f, blocks).products[0].ks


def tensor_core_front(ks: int):
    """``DL._front_plain`` with the QKV product on the tensor-core model
    and the head norms and RoPE in the kernel's order."""
    def front(x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm,
              hkv: int, dh: int, eps: float):
        s = x.shape[0]
        hq = wqkv_q.shape[1] // dh - 2 * hkv
        xf = x.float()
        y = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
             * attn_norm.float()[None, :]).to(torch.bfloat16).float()
        qkv = tensor_core_qkv(y, wqkv_q, ks) * wqkv_s[None, :]
        q = kernel_order_heads(qkv[:, :hq * dh], q_norm, c2, s2, hq, dh, eps)
        k = kernel_order_heads(qkv[:, hq * dh:(hq + hkv) * dh], k_norm, c2,
                               s2, hkv, dh, eps)
        v = qkv[:, (hq + hkv) * dh:].reshape(s, hkv, dh)
        return xf, q, k, v
    return front


@contextlib.contextmanager
def _twin_with(front, attention, seen: list):
    """The twin with ``front`` and ``attention`` (None: its own) and the
    attention output it passes to its back half appended to ``seen``."""
    back = DL._back_plain

    def record(xf, aout, *rest):
        seen.append(aout)
        return back(xf, aout, *rest)

    with contextlib.ExitStack() as stack:
        if front is not None:
            stack.enter_context(mock.patch.object(DL, "_front_plain", front))
        if attention is not None:
            stack.enter_context(mock.patch.object(
                DL, "paged_decode_attention_xla", attention))
        stack.enter_context(mock.patch.object(DL, "_back_plain", record))
        yield


def run_twin(twin, args, pools, lens_t, kw, kv8, ablate="", ks=None):
    """``twin(args, pools, lens_t, kw, kv8, ablate)`` (the card tests'
    ``_mega_twin`` over layer 1 of ``pools``) with, when ``ks`` is given,
    the tensor-core front and the attention in the kernel's order (over
    the pools and scale planes as the twin has just written them), else
    the IEEE twin as it is: → (output, attention output float32)."""
    seen: list = []
    front = attention = None
    if ks is not None:
        front = tensor_core_front(ks)

        def attention(q, k_pool, v_pool, tables, lens):
            if kv8:   # the int8 rows and scales, not the twin's dequantized
                kq, k_sc, vq, v_sc = pools
                return kernel_order_attention(q, kq[1], vq[1], tables, lens,
                                              PA.ATTN_SPLIT, k_sc[1], v_sc[1])
            return kernel_order_attention(q, k_pool, v_pool, tables, lens,
                                          PA.ATTN_SPLIT)
    with _twin_with(front, attention, seen):
        out = twin(args, pools, lens_t, kw, kv8, ablate)
    return out, seen[-1]


#: bf16 steps, at the largest |value| of each (row, head), by which the
#: reference's attention output may part from the IEEE twin's
ATTENTION_STEPS = 1


def _head_step(ar, ai):
    """One bf16 step at the largest |value| of each (row, head) of the
    attention outputs [S, Hq, Dh], broadcast over the head's elements."""
    top = torch.maximum(ar.abs(), ai.abs()).amax(-1, keepdim=True)
    return bf16_step(top).expand_as(ar)


def steps_apart(a_ref, a_ieee) -> float:
    """The most bf16 steps (at the larger magnitude of the element) by
    which the two attention outputs, each rounded to bf16, part."""
    ar = a_ref.to(torch.bfloat16).float()
    ai = a_ieee.to(torch.bfloat16).float()
    step = bf16_step(torch.maximum(ar.abs(), ai.abs()))
    apart = (ar - ai).abs()
    return float(torch.where(apart > 0, apart / step.clamp_min(1e-38),
                             torch.zeros_like(apart)).max())


def head_steps_apart(a_ref, a_ieee) -> float:
    """The most bf16 steps, at the largest |value| of each (row, head),
    by which the two attention outputs [S, Hq, Dh], each rounded to bf16,
    part (an element near 0 may part by many of its own steps and still
    by less than one of its head's)."""
    ar = a_ref.to(torch.bfloat16).float()
    ai = a_ieee.to(torch.bfloat16).float()
    step = _head_step(ar, ai)
    apart = (ar - ai).abs()
    return float(torch.where(apart > 0, apart / step.clamp_min(1e-38),
                             torch.zeros_like(apart)).max())


def carried_step_bound(args, a_ref, a_ieee, eps: float = 1e-6):
    """Elementwise bound on |reference - IEEE twin| of the layer's output
    when their attention outputs [S, Hq, Dh], rounded to bf16, part by at
    most ``ATTENTION_STEPS`` bf16 steps at each head's largest |value|
    (``head_steps_apart`` checks that): that gap carried through wo (|wo|
    products), the FFN norm (first order), the bf16 rounding of y (one
    more step), gate/up, SiLU (|SiLU'| <= 1.1), the bf16 rounding of h,
    down, and the output's bf16 rounding."""
    (x, _, _, _, _, _, _, _, wo_q, wo_s, ffn_norm, gu_q, gu_s, dn_q,
     dn_s) = args[:15]
    s = x.shape[0]
    ar3 = a_ref.to(torch.bfloat16).float()
    ai3 = a_ieee.to(torch.bfloat16).float()
    ar, ai = ar3.reshape(s, -1), ai3.reshape(s, -1)
    da = ATTENTION_STEPS * _head_step(ar3, ai3).reshape(s, -1)
    xf = x.float()
    x1 = xf + (ai @ wo_q.float()) * wo_s[None, :]
    dx1 = (da @ wo_q.float().abs()) * wo_s.abs()[None, :] + 1e-6 * x1.abs()
    r = torch.rsqrt(x1.square().mean(-1, keepdim=True) + eps)
    dr = r ** 3 * (x1.abs() * dx1).mean(-1, keepdim=True)
    w = ffn_norm.float().abs()[None, :]
    n = x1 * r * ffn_norm.float()[None, :]
    dn = w * (r * dx1 + x1.abs() * dr)
    y = n.to(torch.bfloat16).float()
    dy = dn + bf16_step(n.abs() + dn)
    f = dn_q.shape[0]
    g = (y @ gu_q[:, :f].float()) * gu_s[None, :f]
    u = (y @ gu_q[:, f:].float()) * gu_s[None, f:]
    dg = (dy @ gu_q[:, :f].float().abs()) * gu_s[None, :f].abs()
    du = (dy @ gu_q[:, f:].float().abs()) * gu_s[None, f:].abs()
    silu = g * torch.sigmoid(g)
    dh_pre = 1.1 * dg * u.abs() + (silu.abs() + 1.1 * dg) * du
    h = silu * u
    dh = dh_pre + bf16_step(h.abs() + dh_pre)
    out = x1 + (h.to(torch.bfloat16).float() @ dn_q.float()) * dn_s[None, :]
    dout = dx1 + (dh @ dn_q.float().abs()) * dn_s.abs()[None, :]
    return dout + bf16_step(out.abs() + dout)
