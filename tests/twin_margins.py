"""The decoder-layer megakernels against their plain twins on a card, over
seeds: how often the card tests' criterion holds, and where kernel and
twin part.

    python tests/twin_margins.py [--root ROOT] [--seeds 10] [--parting]
                                 [--ieee]

ROOT is a checkout of the repository (this one by default; another, such
as a parent commit unpacked under ``build/``, to compare): its package and
its ``tests/test_torch_cuda_kernels.py`` build the cases, as the card
tests do, and its ``tests/tensor_core_model.py`` the reference. For each configuration of the card
tests' paged route (8, 16 and 32 rows; bf16 and int8 pages; Dh 64 and 128;
splits of 64 and 128 positions) and each seed (the card test's,
``s * 7 + Dh``, then 1000, 1001, ...), the criterion's margin against the
card tests' reference (the twin with the QKV product on the tensor cores'
model; ``--ieee``: the plain IEEE twin): the largest |kernel - reference|
less one bf16 step at the element and 1e-3 of the largest |reference|
(above 0 the card test fails). Prints one JSON line a configuration
(failures, the worst margin, how far the reference parts from the IEEE
twin) and the total.

``--parting`` (this checkout's layout only) adds, at the card test's seed
of the int8-KV case at 16 rows, Dh 128, splits of 128: the margin against
the IEEE twin, against the reference, and when the twin restarts from the
kernel's own float32 attention output (its workspace); q's elements that
differ from the kernel's for the IEEE twin, the IEEE product in the
kernel's order and the tensor-core model; the reference's written K and V
rows and scales that differ from the kernel's; and the attention output's
elements that differ from the kernel's (bf16 roundings for the twin and
the reference; exact float32 for ``kernel_order_attention`` given the
kernel's own q). Needs a card.
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


def sweep(T, PA, TC, card, seeds: int, ieee: bool) -> int:
    """The criterion over the paged route's configurations and seeds,
    against the card tests' reference (the tensor-core model's QKV
    product; with ``ieee`` the plain twin as it is). Each line also gives
    the most bf16 steps by which the reference's attention output parts
    from the IEEE twin's, at the element's magnitude and at its head's
    largest (``tensor_core_model.head_steps_apart``), and how often the
    reference leaves the stated bound (more than ``ATTENTION_STEPS`` head
    steps, or outside ``carried_step_bound``)."""
    fails_all = 0
    for kv8, s, dh, split in itertools.product((True, False), (8, 16, 32),
                                               (128, 64), (64, 128)):
        PA.ATTN_SPLIT = split
        fails, worst, out_of_bound = 0, -float("inf"), 0
        steps = head_steps = 0.0
        for seed in [s * 7 + dh] + [1000 + i for i in range(seeds - 1)]:
            args, pools, lens_t, kw, _ = T._mega_case(card, s, dh, "paged",
                                                      kv8, seed=seed)
            before = [t.clone() for t in pools]
            got = T._mega_call(args, pools, lens_t, kw, kv8)
            hq, hkv, d, f, _ = T.MEGA_WIDTHS[dh]
            ks = TC.qkv_splits(card, s, d, hq, hkv, dh, f, kv8)
            ref, a_ref = TC.run_twin(T._mega_twin, args,
                                     [t.clone() for t in before], lens_t,
                                     kw, kv8, ks=ks)
            plain, a_ieee = TC.run_twin(T._mega_twin, args,
                                        [t.clone() for t in before], lens_t,
                                        kw, kv8)
            torch.cuda.synchronize()
            m = margin(got, plain if ieee else ref, T._bf16_step)
            fails += m > 0
            worst = max(worst, m)
            steps = max(steps, TC.steps_apart(a_ref, a_ieee))
            head = TC.head_steps_apart(a_ref, a_ieee)
            head_steps = max(head_steps, head)
            bound = TC.carried_step_bound(args, a_ref, a_ieee)
            out_of_bound += bool(((ref.float() - plain.float()).abs()
                                  > bound).any()
                                 or head > TC.ATTENTION_STEPS)
        fails_all += fails
        print(json.dumps({"kv8": kv8, "rows": s, "dh": dh, "split": split,
                          "seeds": seeds, "fails": fails, "worst": worst,
                          "attention_steps_apart": steps,
                          "attention_head_steps_apart": head_steps,
                          "out_of_carried_bound": out_of_bound}),
              flush=True)
    return fails_all


def parting(T, PA, DL, WP, TC, card) -> dict:
    """Where kernel and twin part at the int8-KV case, 16 rows, Dh 128,
    splits of 128, the card test's seed."""
    s, dh, split = 16, 128, 128
    PA.ATTN_SPLIT = split
    args, pools, lens_t, kw, tables = T._mega_case(card, s, dh, "paged",
                                                   True, seed=s * 7 + dh)
    twin_pools = [t.clone() for t in pools]
    tc_pools = [t.clone() for t in pools]
    got = T._mega_call(args, pools, lens_t, kw, True)
    want = T._mega_twin(args, twin_pools, lens_t, kw, True)
    hq, hkv, d, f, page = T.MEGA_WIDTHS[dh]
    want_tc, a_ref = TC.run_twin(
        T._mega_twin, args, tc_pools, lens_t, kw, True,
        ks=TC.qkv_splits(card, s, d, hq, hkv, dh, f, True))
    torch.cuda.synchronize()
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
    q_model = TC.kernel_order_q(
        TC.tensor_core_qkv(y, wqkv_q, plan.products[0].ks) * wqkv_s, q_norm,
        c2, s2, hq, dh, 1e-6)
    q_ieee = TC.kernel_order_q((y @ wqkv_q.float()) * wqkv_s, q_norm, c2,
                               s2, hq, dh, 1e-6)
    a_tcq = TC.kernel_order_attention(q_model, kq[1], vq[1], tables, lens_t,
                                      split, ks[1], vs[1])
    a_order = TC.kernel_order_attention(q_k, kq[1], vq[1], tables, lens_t,
                                        split, ks[1], vs[1])
    rows = (args[-2].long(), args[-1].long())
    return {"case": "int8 KV, 16 rows, Dh 128, splits of 128",
            "margin": margin(got, want, T._bf16_step),
            "margin_tensor_core_reference": margin(got, want_tc,
                                                   T._bf16_step),
            "k_rows_differ_tensor_core": int((pools[0][1][rows]
                                              != tc_pools[0][1][rows]).sum()),
            "v_rows_differ_tensor_core": int((pools[2][1][rows]
                                              != tc_pools[2][1][rows]).sum()),
            "k_scales_differ_tensor_core": int(
                (pools[1][1][rows[0]] != tc_pools[1][1][rows[0]]).sum()),
            "attention_bf16_differs_tensor_core_q_kernel_pools": int(
                (a_k.bfloat16() != a_tcq.bfloat16()).sum()),
            "attention_bf16_differs_tensor_core_reference": int(
                (a_k.bfloat16() != a_ref.bfloat16()).sum()),
            "attention_max_abs_tensor_core_q_kernel_pools": float(
                (a_k - a_tcq).abs().max()),
            "attention_differs_kernel_order_from_kernel_q": int(
                (a_k != a_order).sum()),

            "q_heads_differing_tensor_core_model": int(
                (q_k != q_model).any(-1).sum()),
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
    ap.add_argument("--ieee", action="store_true",
                    help="count against the plain IEEE twin, as before the "
                         "tensor-core reference")
    args = ap.parse_args(argv)
    root = str(args.root.resolve())
    sys.path[:0] = [root, str(Path(root) / "tests")]
    for name in [m for m in sys.modules if m.startswith("cmw_rag_tpu_torch")]:
        del sys.modules[name]          # the checkout's own package
    torch.backends.cuda.matmul.allow_tf32 = False
    import test_torch_cuda_kernels as T
    from cmw_rag_tpu_torch.ops import paged_attention as PA
    import tensor_core_model as TC

    card = torch.device("cuda", 0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    if args.parting:
        from cmw_rag_tpu_torch.ops import decoder_layer as DL
        from cmw_rag_tpu_torch.ops import weight_phases as WP
        out["parting"] = parting(T, PA, DL, WP, TC, card)
    out["reference"] = "ieee twin" if args.ieee else "tensor-core model"
    out["fails"] = sweep(T, PA, TC, card, args.seeds, args.ieee)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
