"""The port's decoder-layer megakernel (cmw_rag_tpu_torch.ops.decoder_layer)
and slot-major paged attention (ops.paged_attention.
paged_decode_attention_dma_slot) on the CPU against the JAX package's, at the
shapes of ``tests/test_decoder_layer.py`` and
``tests/test_engine.py::test_paged_attention_slot_matches_golden``.

The megakernel's CPU route, the twin of the CUDA kernel, keeps the TPU
kernel's rounding points (the normed input, the attention output, y and h
rounded to bf16; q in float32; k and v in the pool dtype), so on both
attention routes it meets the JAX Pallas kernel in interpret mode within
1e-4 in x and the written pool rows (float32 sums in another order; a bf16
rounding moved one step moves an output by ~1e-5), and the float32 golden
within the JAX tests' 0.05 (x) and 0.02 (pools). The pools are written in
place and only at the new rows. The slot-major twin meets the JAX kernel
within the JAX test's 2e-5. ``batched=True`` (TPU schedule) changes
nothing, and ``ablate="noattn"`` meets the JAX kernel's ablation as the
routes do.

The int8-KV megakernel (``decoder_layer_int8_kv8``) takes this layer's
[P, Hkv] scale planes where JAX takes the head-major [Hkv, P] plane; its
twin keeps the JAX kernel's rounding points (the new rows rounded to x's
dtype before the amax, division, round half to even) and meets it in
interpret mode within 1e-4 in x, one int8 step in the written rows and
1e-6 relative in the scales (the QKV sums in another float32 order move a
row's amax by a float32 step, and a value within a step of a half rounds
the other way), every other row and scale bit for bit; and the JAX golden
within the JAX test's 0.06 in x, one int8 step in the rows and 2e-2
relative in the scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import decoder_layer as J
from cmw_rag_tpu.ops.paged_attention import (make_decode_worklist,
                                             make_decode_worklist_flat,
                                             paged_decode_attention_dma_slot)
from cmw_rag_tpu_torch.ops import decoder_layer as T
from cmw_rag_tpu_torch.ops import paged_attention as PA
from tests.test_decoder_layer import (DH, HKV, HQ, MAXP, PAGE, S, _setup,
                                      _setup_kv8, _setup_partitioned)

WEIGHTS = ("attn_norm", "wqkv_q", "wqkv_s", "q_norm", "k_norm", "wo_q",
           "wo_s", "ffn_norm", "w_gateup_q", "w_gateup_s", "w_down_q",
           "w_down_s")
ROUTES = {"paged": (lambda: _setup(), {}),
          "slot-cap2": (lambda: _setup_partitioned(lens=(0, 5, 14, 30)),
                        dict(attn_slot=True, slot_cap=2, slot_maxp=MAXP)),
          "slot-cap4": (lambda: _setup_partitioned(lens=(0, 17, 30, 62)),
                        dict(attn_slot=True, slot_cap=4, slot_maxp=MAXP))}


def _t(a):
    return torch.from_numpy(np.array(a))


def _run_port(setup, kw, li=1):
    layer, x, kp, vp, tables, cur, cos, sin, pi, off = setup
    c2, s2 = T.make_rope_maps(_t(cos), _t(sin))
    tkp, tvp = _t(kp), _t(vp)
    out = T.decoder_layer_int8(
        _t(x), c2, s2, *[_t(layer[n]) for n in WEIGHTS], _t(pi), _t(off),
        tkp, tvp, _t(cur + 1), layer=li, tables=_t(tables), **kw)
    return out, tkp, tvp


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_megakernel_matches_jax_kernel_and_golden(route):
    make, kw = ROUTES[route]
    setup = make()
    layer, x, kp, vp, tables, cur, cos, sin, pi, off = setup
    li = 1
    c2, s2 = J.make_rope_maps(cos, sin)
    wl = make_decode_worklist(tables, cur + 1, PAGE, chunk=1)
    kx, kkp, kvp = J.decoder_layer_int8(
        x, c2, s2, *[layer[n] for n in WEIGHTS], pi, off, kp, vp, cur + 1,
        wl, layer=li, block_f=128, interpret=True, **kw)
    gx, gkp, gvp = J.decoder_layer_int8_xla(
        x, cos, sin, layer, pi, off, kp, vp, tables, cur + 1, li, hq=HQ,
        hkv=HKV, dh=DH)
    (ox, okp, ovp), tkp, tvp = _run_port(setup, kw, li)
    assert okp is tkp and ovp is tvp                    # written in place
    np.testing.assert_allclose(ox.numpy(), np.asarray(kx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(okp.numpy(), np.asarray(kkp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ovp.numpy(), np.asarray(kvp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ox.numpy(), np.asarray(gx), rtol=0, atol=0.05)
    np.testing.assert_allclose(okp.numpy(), np.asarray(gkp), rtol=0,
                               atol=0.02)
    np.testing.assert_allclose(ovp.numpy(), np.asarray(gvp), rtol=0,
                               atol=0.02)
    # only the new rows of layer li changed
    changed = (okp.numpy() != np.asarray(kp)).any(axis=(3, 4))
    rows = {(li, int(p), int(o)) for p, o in zip(np.asarray(pi),
                                                 np.asarray(off))}
    assert set(zip(*np.nonzero(changed))) <= rows


def test_port_golden_matches_jax_golden():
    layer, x, kp, vp, tables, cur, cos, sin, pi, off = _setup()
    gx, gkp, gvp = J.decoder_layer_int8_xla(
        x, cos, sin, layer, pi, off, kp, vp, tables, cur + 1, 1, hq=HQ,
        hkv=HKV, dh=DH)
    ox, okp, ovp = T.decoder_layer_int8_xla(
        _t(x), _t(cos), _t(sin), {k: _t(v) for k, v in layer.items()},
        _t(pi), _t(off), _t(kp), _t(vp), _t(tables), _t(cur + 1), 1, hq=HQ,
        hkv=HKV, dh=DH)
    np.testing.assert_allclose(ox.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(okp.numpy(), np.asarray(gkp), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ovp.numpy(), np.asarray(gvp), rtol=0,
                               atol=1e-5)


def test_rope_maps_match_jax():
    rng = np.random.default_rng(3)
    cos, sin = rng.normal(size=(2, S, DH // 2)).astype(np.float32)
    for a, b in zip(J.make_rope_maps(jnp.asarray(cos), jnp.asarray(sin)),
                    T.make_rope_maps(_t(cos), _t(sin))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_megakernel_refuses_what_is_not_ported():
    """Nothing of the megakernel's signature is refused any more but a
    paged call without its block table and an unknown ablation."""
    setup = _setup()
    layer, x, kp, vp, tables, cur, cos, sin, pi, off = setup
    c2, s2 = T.make_rope_maps(_t(cos), _t(sin))
    with pytest.raises(ValueError, match="tables"):
        T.decoder_layer_int8(_t(x), c2, s2, *[_t(layer[n]) for n in WEIGHTS],
                             _t(pi), _t(off), _t(kp), _t(vp), _t(cur + 1),
                             layer=1)
    with pytest.raises(ValueError, match="ablate"):
        _run_port(setup, dict(ablate="nomlp"))


@pytest.mark.parametrize("kw", [dict(batched=True), dict(ablate="noattn")],
                         ids=["batched", "noattn"])
def test_megakernel_batched_and_noattn_match_jax_kernel(kw):
    setup = _setup()
    layer, x, kp, vp, tables, cur, cos, sin, pi, off = setup
    c2, s2 = J.make_rope_maps(cos, sin)
    wl = make_decode_worklist(tables, cur + 1, PAGE, chunk=1)
    if kw.get("batched"):
        wl = make_decode_worklist_flat(tables, cur + 1, PAGE, chunk=1)
    kx, kkp, kvp = J.decoder_layer_int8(
        x, c2, s2, *[layer[n] for n in WEIGHTS], pi, off, kp, vp, cur + 1,
        wl, layer=1, block_f=128, interpret=True, **kw)
    (ox, okp, ovp), _, _ = _run_port(setup, kw)
    np.testing.assert_allclose(ox.numpy(), np.asarray(kx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(okp.numpy(), np.asarray(kkp), rtol=0,
                               atol=1e-4)
    (bx, _, _), _, _ = _run_port(setup, {})
    assert torch.equal(ox, bx) == bool(kw.get("batched"))


def _kv8_port(setup, li, **kw):
    layer, x, kq, ks, vq, vs, tables, cur, cos, sin, pi, off = setup
    c2, s2 = T.make_rope_maps(_t(cos), _t(sin))
    tkq, tks, tvq, tvs = _t(kq), _t(ks), _t(vq), _t(vs)
    out = T.decoder_layer_int8_kv8(
        _t(x), c2, s2, *[_t(layer[n]) for n in WEIGHTS], _t(pi), _t(off),
        tkq, tks[li], tvq, tvs[li], _t(cur + 1), layer=li,
        tables=_t(tables), **kw)
    return out, tkq, tks, tvq, tvs


@pytest.mark.parametrize("lens", [(0, 17, 30, 63), (1, 16, 32, 48)],
                         ids=["mid-page", "fresh-pages"])
def test_kv8_megakernel_matches_jax_kernel_and_golden(lens):
    setup = _setup_kv8(lens=lens)
    layer, x, kq, ks, vq, vs, tables, cur, cos, sin, pi, off = setup
    li = 1
    c2, s2 = J.make_rope_maps(cos, sin)
    wl = make_decode_worklist(tables, cur + 1, PAGE, chunk=1)
    kx, kkp, kks_l, kvp, kvs_l = J.decoder_layer_int8_kv8(
        x, c2, s2, *[layer[n] for n in WEIGHTS], pi, off, kq, ks[li].T, vq,
        vs[li].T, cur + 1, wl, layer=li, block_f=128, interpret=True)
    gx, gkp, gks, gvp, gvs = J.decoder_layer_int8_kv8_xla(
        x, cos, sin, layer, pi, off, kq, ks, vq, vs, tables, cur + 1, li,
        hq=HQ, hkv=HKV, dh=DH)
    (ox, okp, oks, ovp, ovs), tkq, tks, tvq, tvs = _kv8_port(setup, li)
    assert okp is tkq and ovp is tvq                      # in place
    assert oks.data_ptr() == tks[li].data_ptr()           # this layer's plane
    np.testing.assert_allclose(ox.numpy(), np.asarray(kx), rtol=0, atol=1e-4)
    for got, want in ((okp, kkp), (ovp, kvp)):
        np.testing.assert_allclose(got.numpy().astype(np.int32),
                                   np.asarray(want).astype(np.int32), atol=1)
    for got, want in ((oks, kks_l), (ovs, kvs_l)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).T,
                                   rtol=1e-6, atol=0)
    rows = np.zeros(okp.shape[:3], bool)
    rows[li, np.asarray(pi), np.asarray(off)] = True
    for got, before in ((okp, kq), (ovp, vq)):
        np.testing.assert_array_equal(got.numpy()[~rows],
                                      np.asarray(before)[~rows])
    fresh_pages = np.asarray(pi)[np.asarray(off) == 0]
    keep = np.ones(oks.shape[0], bool)
    keep[fresh_pages] = False
    np.testing.assert_array_equal(oks.numpy()[keep], np.asarray(ks[li])[keep])
    np.testing.assert_allclose(ox.numpy(), np.asarray(gx), rtol=0, atol=0.06)
    for got, want in ((okp, gkp), (ovp, gvp)):
        np.testing.assert_allclose(got.numpy().astype(np.int32),
                                   np.asarray(want).astype(np.int32), atol=1)
    np.testing.assert_allclose(tks.numpy(), np.asarray(gks), rtol=2e-2)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(gvs), rtol=2e-2)
    # the other layer's pools and planes are untouched
    np.testing.assert_array_equal(okp.numpy()[0], np.asarray(kq)[0])
    np.testing.assert_array_equal(tks.numpy()[0], np.asarray(ks)[0])


def test_kv8_noattn_matches_jax_kernel():
    setup = _setup_kv8()
    layer, x, kq, ks, vq, vs, tables, cur, cos, sin, pi, off = setup
    c2, s2 = J.make_rope_maps(cos, sin)
    wl = make_decode_worklist(tables, cur + 1, PAGE, chunk=1)
    kx = J.decoder_layer_int8_kv8(
        x, c2, s2, *[layer[n] for n in WEIGHTS], pi, off, kq, ks[1].T, vq,
        vs[1].T, cur + 1, wl, layer=1, block_f=128, interpret=True,
        ablate="noattn")[0]
    (ox, *_), *_ = _kv8_port(setup, 1, ablate="noattn")
    np.testing.assert_allclose(ox.numpy(), np.asarray(kx), rtol=0, atol=1e-4)


def test_kv8_golden_matches_jax_golden():
    setup = _setup_kv8()
    layer, x, kq, ks, vq, vs, tables, cur, cos, sin, pi, off = setup
    gx, gkp, gks, gvp, gvs = J.decoder_layer_int8_kv8_xla(
        x, cos, sin, layer, pi, off, kq, ks, vq, vs, tables, cur + 1, 1,
        hq=HQ, hkv=HKV, dh=DH)
    ox, okp, oks, ovp, ovs = T.decoder_layer_int8_kv8_xla(
        _t(x), _t(cos), _t(sin), {k: _t(v) for k, v in layer.items()},
        _t(pi), _t(off), _t(kq), _t(ks), _t(vq), _t(vs), _t(tables),
        _t(cur + 1), 1, hq=HQ, hkv=HKV, dh=DH)
    np.testing.assert_allclose(ox.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    for got, want in ((okp, gkp), (ovp, gvp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(oks.numpy(), np.asarray(gks), rtol=1e-6)
    np.testing.assert_allclose(ovs.numpy(), np.asarray(gvs), rtol=1e-6)


@pytest.mark.parametrize("cap", [4, 6])
def test_slot_attention_matches_jax_kernel(cap):
    rng = np.random.default_rng(4)
    n_layers, s, hq, hkv, dh, page, maxp = 2, 4, 8, 2, 64, 16, 6
    pool = 1 + s * maxp
    q = rng.normal(size=(s, hq, dh)).astype(np.float32)
    kp = rng.normal(size=(n_layers, pool, page, hkv, dh)).astype(np.float32)
    vp = rng.normal(size=(n_layers, pool, page, hkv, dh)).astype(np.float32)
    lens = np.minimum(np.asarray([1, 16, 61, 96], np.int32), cap * page)
    for li in range(n_layers):
        want = paged_decode_attention_dma_slot(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(lens), layer=li, cap=cap, maxp_slot=maxp,
            interpret=True)
        got = PA.paged_decode_attention_dma_slot(
            _t(q), _t(kp), _t(vp), _t(lens), layer=li, cap=cap,
            maxp_slot=maxp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_slot_attention_ignores_rows_past_its_cap_and_length():
    """Other values in every row past a slot's length, and in the pages past
    its cap, leave the twin's output as it was (the kernel's NaN case is a
    card test: the gather twin multiplies masked rows by 0)."""
    rng = np.random.default_rng(6)
    s, hq, hkv, dh, page, maxp, cap = 3, 4, 2, 64, 16, 4, 2
    kp = torch.from_numpy(rng.normal(size=(1, 1 + s * maxp, page, hkv, dh))
                          .astype(np.float32))
    vp = kp.flip(-1).contiguous()
    q = torch.from_numpy(rng.normal(size=(s, hq, dh)).astype(np.float32))
    lens = torch.tensor([1, 17, 40], dtype=torch.int32)
    want = PA.paged_decode_attention_dma_slot(q, kp, vp, lens, layer=0,
                                              cap=cap, maxp_slot=maxp)
    tables = PA.slot_tables(s, maxp, maxp)
    for si, n in enumerate(lens.tolist()):
        for j in range(maxp):
            start = min(max(n - j * page, 0), page)
            kp[0, tables[si, j], start:] = 1e4
            vp[0, tables[si, j], start:] = -1e4
    got = PA.paged_decode_attention_dma_slot(q, kp, vp, lens, layer=0,
                                             cap=cap, maxp_slot=maxp)
    assert torch.equal(got, want)
    assert PA.slot_tables(2, 3, 5, 1).tolist() == [[1, 2, 3], [6, 7, 8]]
