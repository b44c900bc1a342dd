"""The decoder-layer megakernels against their plain twins on a card, over
seeds: how often the card tests' criterion holds, and where kernel and
twin part.

    python tests/twin_margins.py [--root ROOT] [--seeds 10] [--parting]

ROOT is a checkout of the repository (this one by default; another, such
as a parent commit unpacked under ``build/``, to compare): its package and
its ``tests/test_torch_cuda_kernels.py`` build the cases, as the card
tests do. For each configuration of the card tests' paged route (8, 16 and
32 rows; bf16 and int8 pages; Dh 64 and 128; splits of 64 and 128
positions) and each seed (the card test's, ``s * 7 + Dh``, then 1000,
1001, ...), the criterion's margin: the largest |kernel - twin| less one
bf16 step at the element and 1e-3 of the largest |twin| (above 0 the card
test fails). Prints one JSON line a configuration (failures, the worst
margin) and the total.

``--parting`` (this checkout's layout only) adds, at the card test's seed
of the int8-KV case at 16 rows, Dh 128, splits of 128: the margin when the
twin restarts from the kernel's own float32 attention output (its
workspace); the attention output's elements whose bf16 rounding differs
between kernel and twin; q's elements that differ; and q's elements that
differ from a model of the QKV product on the tensor cores (the
megakernel's order of items, warp halves and ``mma.sync`` k16 steps; each
step's 16 products and the accumulator aligned to the largest exponent
and cut toward zero 26 bits below its leading bit, summed, then rounded
toward zero to float32; the head norm and RoPE in the kernel's order)
beside those from the twin's IEEE float32 product. Needs a card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import torch


def margin(got, want, step_of, tol: float = 1e-3) -> float:
    """The card tests' criterion: > 0 where it fails."""
    err = (got.float() - want.float()).abs()
    step = step_of(torch.maximum(got.float().abs(), want.float().abs()))
    return float((err - step - tol * want.float().abs().max()).max())


def sweep(T, PA, card, seeds: int) -> int:
    """The criterion over the paged route's configurations and seeds."""
    fails_all = 0
    for kv8, s, dh, split in itertools.product((True, False), (8, 16, 32),
                                               (128, 64), (64, 128)):
        PA.ATTN_SPLIT = split
        fails, worst = 0, -float("inf")
        for seed in [s * 7 + dh] + [1000 + i for i in range(seeds - 1)]:
            args, pools, lens_t, kw, _ = T._mega_case(card, s, dh, "paged",
                                                      kv8, seed=seed)
            twin_pools = [t.clone() for t in pools]
            got = T._mega_call(args, pools, lens_t, kw, kv8)
            want = T._mega_twin(args, twin_pools, lens_t, kw, kv8)
            torch.cuda.synchronize()
            m = margin(got, want, T._bf16_step)
            fails += m > 0
            worst = max(worst, m)
        fails_all += fails
        print(json.dumps({"kv8": kv8, "rows": s, "dh": dh, "split": split,
                          "seeds": seeds, "fails": fails, "worst": worst}),
              flush=True)
    return fails_all


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


def kernel_order_q(qkv, q_norm, c2, s2, hq: int, dh: int, eps: float):
    """q from the QKV sums as the megakernel's merge forms it: a lane's
    chain of fused squares and a butterfly for the head norm, RoPE with
    the first product fused."""
    s = qkv.shape[0]
    t = qkv[:, :hq * dh].reshape(s, hq, dh)
    el = dh // 32
    v = t.reshape(s, hq, 32, el)
    ss = torch.zeros((s, hq, 32), device=t.device)
    for e in range(el):
        ss = _fma(v[..., e], v[..., e], ss)
    n = t * torch.rsqrt(_butterfly(ss, 32) / dh + eps)[..., None] \
        * q_norm.float()
    part = torch.roll(n, dh // 2, -1)
    return _fma(n, c2[:, None, :].expand_as(n), part * s2[:, None, :])


def parting(T, PA, DL, WP, card) -> dict:
    """Where kernel and twin part at the int8-KV case, 16 rows, Dh 128,
    splits of 128, the card test's seed."""
    s, dh, split = 16, 128, 128
    PA.ATTN_SPLIT = split
    args, pools, lens_t, kw, tables = T._mega_case(card, s, dh, "paged",
                                                   True, seed=s * 7 + dh)
    twin_pools = [t.clone() for t in pools]
    got = T._mega_call(args, pools, lens_t, kw, True)
    want = T._mega_twin(args, twin_pools, lens_t, kw, True)
    torch.cuda.synchronize()
    hq, hkv, d, f, page = T.MEGA_WIDTHS[dh]
    plan, sizes, *_ = DL.launch_config(
        s, d, hq, hkv, dh, f, page, tables.shape[1],
        DL._grid(card, WP.layer_tile(s), dh, True))
    floats, _ = WP._WORKSPACES[(card.index or 0,
                                torch.cuda.current_stream(card).cuda_stream)]
    at = list(itertools.accumulate((0,) + sizes))
    q_k = floats[at[2]:at[2] + s * hq * dh].reshape(s, hq, dh).clone()
    a_k = floats[at[3]:at[3] + s * hq * dh].reshape(s, hq, dh).clone()
    (x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s,
     ffn_norm, gu_q, gu_s, dn_q, dn_s) = args[:15]
    xf, q_t, _, _ = DL._front_plain(x, c2, s2, attn_norm, wqkv_q, wqkv_s,
                                    q_norm, k_norm, hkv, dh, 1e-6)
    kq, ks, vq, vs = pools
    kd = kq[1].float() * ks[1][:, None, :, None]
    vd = vq[1].float() * vs[1][:, None, :, None]
    a_t = PA.paged_decode_attention_xla(q_t, kd, vd, tables, lens_t)
    from_kernel = DL._back_plain(xf, a_k, wo_q, wo_s, ffn_norm, gu_q, gu_s,
                                 dn_q, dn_s, 1e-6, x.dtype)
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
         * attn_norm.float()).to(torch.bfloat16).float()
    q_model = kernel_order_q(
        tensor_core_qkv(y, wqkv_q, plan.products[0].ks) * wqkv_s, q_norm,
        c2, s2, hq, dh, 1e-6)
    q_ieee = kernel_order_q((y @ wqkv_q.float()) * wqkv_s, q_norm, c2, s2,
                            hq, dh, 1e-6)
    return {"case": "int8 KV, 16 rows, Dh 128, splits of 128",
            "margin": margin(got, want, T._bf16_step),
            "margin_from_kernel_attention": margin(got, from_kernel,
                                                   T._bf16_step),
            "attention_bf16_differs": int((a_k.bfloat16()
                                           != a_t.bfloat16()).sum()),
            "q_differs": int((q_k != q_t).sum()),
            "q_differs_kernel_order_ieee_product": int((q_k != q_ieee).sum()),
            "q_differs_tensor_core_model": int((q_k != q_model).sum()),
            "q_elements": q_k.numel()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--parting", action="store_true")
    args = ap.parse_args(argv)
    root = str(args.root.resolve())
    sys.path[:0] = [root, str(Path(root) / "tests")]
    for name in [m for m in sys.modules if m.startswith("cmw_rag_tpu_torch")]:
        del sys.modules[name]          # the checkout's own package
    torch.backends.cuda.matmul.allow_tf32 = False
    import test_torch_cuda_kernels as T
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    card = torch.device("cuda", 0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    if args.parting:
        from cmw_rag_tpu_torch.ops import decoder_layer as DL
        from cmw_rag_tpu_torch.ops import weight_phases as WP
        out["parting"] = parting(T, PA, DL, WP, card)
    out["fails"] = sweep(T, PA, card, args.seeds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
