"""The card tests' reference model of the megakernels' arithmetic
(``tests/tensor_core_model.py``) on the CPU, at small widths: the QKV
product on the tensor cores' truncating accumulation, the head norm and
RoPE in the kernel's order, and the attention in ``attend_split``'s order
stay within float32 rounding of the plain twin's IEEE forms (the model
moves last bits, never values); bf16 and int8 pools, one split and
several."""

import numpy as np
import pytest
import torch

import tensor_core_model as TC
from cmw_rag_tpu_torch.ops import decoder_layer as DL
from cmw_rag_tpu_torch.ops import paged_attention as PA


def _pools(int8, seed=0, n_pages=9, page=16, hkv=2, dh=64):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((n_pages, page, hkv, dh),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((n_pages, page, hkv, dh),
                                             dtype=np.float32))
    if int8:
        (kq, ks), (vq, vs) = PA.quantize_kv_page(k), PA.quantize_kv_page(v)
        return kq, ks, vq, vs
    return k.bfloat16(), None, v.bfloat16(), None


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("split", [16, 64])
def test_kernel_order_attention_is_the_attention(int8, split):
    """Against ``paged_decode_attention_xla`` (over the dequantized pools
    for int8) to float32 rounding, at lengths of one position, on both
    sides of a split and the whole table."""
    rng = np.random.default_rng(1)
    kp, ks, vp, vs = _pools(int8)
    q = torch.from_numpy(rng.standard_normal((4, 8, 64), dtype=np.float32))
    tables = torch.from_numpy(rng.permutation(8).reshape(4, 2) + 1).int()
    tables = torch.cat([tables, tables.flip(1)], 1)
    lens = torch.tensor([1, 17, 63, 64], dtype=torch.int32)
    got = TC.kernel_order_attention(q, kp, vp, tables, lens, split, ks, vs)
    kd = kp.float() if ks is None else kp.float() * ks[:, None, :, None]
    vd = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
    want = PA.paged_decode_attention_xla(q, kd, vd, tables, lens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_tensor_core_front_is_the_front():
    """The tensor-core QKV product, head norms and RoPE against the twin's
    ``_front_plain`` to float32 rounding; the product itself never above
    the IEEE one's magnitude by more than its truncation."""
    rng = np.random.default_rng(2)
    s, d, hq, hkv, dh = 3, 128, 4, 2, 64
    n = (hq + 2 * hkv) * dh
    x = torch.from_numpy(rng.standard_normal((s, d), dtype=np.float32)
                         ).bfloat16()
    w = torch.from_numpy(rng.integers(-127, 128, (d, n))).to(torch.int8)
    ws = torch.from_numpy(rng.uniform(0.001, 0.01, n).astype(np.float32))
    ang = torch.from_numpy(rng.uniform(0, 6.28, (s, dh // 2))
                           .astype(np.float32))
    c2, s2 = DL.make_rope_maps(torch.cos(ang), torch.sin(ang))
    an, qn, kn = (torch.from_numpy(rng.uniform(0.5, 1.5, m).astype(
        np.float32)) for m in (d, dh, dh))
    want = DL._front_plain(x, c2, s2, an, w, ws, qn, kn, hkv, dh, 1e-6)
    for ks in (1, 2):
        got = TC.tensor_core_front(ks)(x, c2, s2, an, w, ws, qn, kn, hkv,
                                       dh, 1e-6)
        for g, t in zip(got, want):
            torch.testing.assert_close(g, t, rtol=1e-5, atol=1e-5)
    y = want[0] * torch.rsqrt(want[0].square().mean(-1, keepdim=True)
                              + 1e-6) * an
    y = y.bfloat16().float()
    tc, ieee = TC.tensor_core_qkv(y, w, 2), y.double() @ w.double()
    assert ((tc.double() - ieee).abs()
            <= 1e-5 * ieee.abs() + 1e-4).all()


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("s", [8, 32])
def test_reference_is_within_the_stated_bound_of_the_ieee_twin(kv8, s):
    """The card tests' reference (``run_twin`` with the tensor-core front
    and the attention in the kernel's order, the QKV product split as a
    132-SM card's plan splits it) against the plain IEEE twin, on the
    CPU at the card tests' Dh-64 widths and seed: the attention outputs
    within ``ATTENTION_STEPS`` bf16 step at each head's largest |value|,
    the layer outputs within ``carried_step_bound``."""
    import test_torch_cuda_kernels as CK
    from cmw_rag_tpu_torch.ops import weight_phases as WP

    dh = 64
    hq, hkv, d, f, _ = CK.MEGA_WIDTHS[dh]
    cpu = torch.device("cpu")
    args, pools, lens_t, kw, _ = CK._mega_case(cpu, s, dh, "paged", kv8,
                                               seed=s * 7 + dh)
    ks = WP.layer_plan(s, d, hq, hkv, dh, f, 132).products[0].ks
    ref, a_ref = TC.run_twin(CK._mega_twin, args, [t.clone() for t in pools],
                             lens_t, kw, kv8, ks=ks)
    ieee, a_ieee = TC.run_twin(CK._mega_twin, args,
                               [t.clone() for t in pools], lens_t, kw, kv8)
    assert a_ref.shape == (s, hq, dh)
    assert TC.head_steps_apart(a_ref, a_ieee) <= TC.ATTENTION_STEPS
    assert TC.steps_apart(a_ref, a_ieee) >= TC.head_steps_apart(a_ref,
                                                                a_ieee)
    bound = TC.carried_step_bound(args, a_ref, a_ieee)
    assert ((ref.float() - ieee.float()).abs() <= bound).all()
