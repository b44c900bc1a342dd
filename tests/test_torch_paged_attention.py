"""The port's paged decode attention (cmw_rag_tpu_torch.ops.paged_attention)
on the CPU, where its wrappers run their plain twins, against the JAX
package: its gather goldens and its Pallas kernels in interpret mode.

Inputs are float32, made with numpy from a seed, at toy shapes (the JAX
package marks its own interpret-mode int8 run slow): pools of 2 layers,
distinct random pages per slot, ragged lengths across page boundaries.
Tolerance 2e-5 absolute for every attention output (float32 sums in
another order; the JAX package holds its kernels to its golden at the same
2e-5, 3e-5 for int8 pages); quantization, the scattered pools and the
worklist are held equal exactly. The plain model of the card kernel's
splits (``paged_decode_attention_split_plain``) over int8 pages and with
this step's row taken from k_new/v_new is held to JAX's int8 golden and
to JAX's scatter kernel in interpret mode at lengths on both sides of
every split and page boundary, at the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import paged_attention as J
from cmw_rag_tpu_torch.ops import paged_attention as PA

TOL = 2e-5
INT8_TOL = 3e-5
# S, Hq, Hkv, Dh, page, maxp, lens: GQA (2 query heads a KV head) and none
SHAPES = {"gqa": (4, 4, 2, 16, 16, 4, [1, 16, 17, 64]),
          "mha": (3, 4, 4, 32, 8, 4, [5, 8, 32])}


def _case(shape, seed, layers=2):
    """(port tensors, JAX arrays) of q, pools [L, P, page, Hkv, Dh], tables
    and lens."""
    s, hq, hkv, dh, page, maxp, lens = shape
    rng = np.random.default_rng(seed)
    pool = 2 + s * maxp
    a = dict(
        q=rng.standard_normal((s, hq, dh)).astype(np.float32),
        kp=rng.standard_normal((layers, pool, page, hkv, dh)).astype(np.float32),
        vp=rng.standard_normal((layers, pool, page, hkv, dh)).astype(np.float32),
        tables=rng.permutation(np.arange(1, 1 + s * maxp)).reshape(
            s, maxp).astype(np.int32),
        lens=np.asarray(lens, np.int32))
    return ({k: torch.from_numpy(v.copy()) for k, v in a.items()},
            {k: jnp.asarray(v) for k, v in a.items()})


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dma_twin_matches_jax_golden_and_kernel(shape):
    t, j = _case(SHAPES[shape], seed=1)
    for layer in (0, 1):
        got = PA.paged_decode_attention_dma(t["q"], t["kp"], t["vp"],
                                            t["tables"], t["lens"],
                                            layer=layer).numpy()
        gold = J.paged_decode_attention_xla(j["q"], j["kp"][layer],
                                            j["vp"][layer], j["tables"],
                                            j["lens"])
        ker = J.paged_decode_attention_dma(j["q"], j["kp"], j["vp"],
                                           j["tables"], j["lens"], layer=layer,
                                           interpret=True)
        np.testing.assert_allclose(got, np.asarray(gold), atol=TOL, rtol=0)
        np.testing.assert_allclose(got, np.asarray(ker), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scatter_twin_matches_jax_kernel_output_and_pools(shape):
    """The row of position lens - 1 is written (the engine's contract),
    in place, into the same pools the JAX kernel returns."""
    t, j = _case(SHAPES[shape], seed=2)
    s, _, hkv, dh, page, _, lens = SHAPES[shape]
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((s, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((s, hkv, dh)).astype(np.float32)
    pos = np.asarray(lens) - 1
    page_idx = np.take_along_axis(np.asarray(j["tables"]),
                                  (pos // page)[:, None], 1)[:, 0].astype(np.int32)
    off = (pos % page).astype(np.int32)
    kp, vp = t["kp"], t["vp"]
    out, k2, v2 = PA.paged_decode_attention_dma_scatter(
        t["q"], torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(page_idx), torch.from_numpy(off), kp, vp,
        t["tables"], t["lens"], layer=1)
    assert k2 is kp and v2 is vp
    jout, jk, jv = J.paged_decode_attention_dma_scatter(
        j["q"], jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(page_idx),
        jnp.asarray(off), j["kp"], j["vp"], j["tables"], j["lens"], layer=1,
        interpret=True)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jv))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    assert not np.array_equal(kp.numpy(), np.asarray(j["kp"]))  # it wrote


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kv_int8_twin_matches_jax_golden_and_kernel(shape):
    t, j = _case(SHAPES[shape], seed=4)
    kq, ks = PA.quantize_kv_page(t["kp"])
    vq, vs = PA.quantize_kv_page(t["vp"])
    jkq, jks = J.quantize_kv_page(j["kp"])
    jvq, jvs = J.quantize_kv_page(j["vp"])
    for layer in (0, 1):
        got = PA.paged_decode_attention_dma_kv_int8(
            t["q"], kq, ks, vq, vs, t["tables"], t["lens"], layer=layer).numpy()
        gold = J.paged_decode_attention_xla_kv_int8(
            j["q"], jkq[layer], jks[layer], jvq[layer], jvs[layer],
            j["tables"], j["lens"])
        np.testing.assert_allclose(got, np.asarray(gold), atol=INT8_TOL, rtol=0)
    ker = J.paged_decode_attention_dma_kv_int8(
        j["q"], jkq, jks, jvq, jvs, j["tables"], j["lens"], layer=1,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(ker), atol=INT8_TOL, rtol=0)


def test_aliases_match_their_jax_kernels():
    """``paged_decode_attention`` (one layer's pool) and
    ``paged_decode_attention_pooled`` against the two TPU schedules."""
    t, j = _case(SHAPES["gqa"], seed=5)
    one = PA.paged_decode_attention(t["q"], t["kp"][1], t["vp"][1],
                                    t["tables"], t["lens"]).numpy()
    pooled = PA.paged_decode_attention_pooled(t["q"], t["kp"], t["vp"],
                                              t["tables"], t["lens"],
                                              layer=1).numpy()
    jone = J.paged_decode_attention(j["q"], j["kp"][1], j["vp"][1],
                                    j["tables"], j["lens"], interpret=True)
    jpooled = J.paged_decode_attention_pooled(j["q"], j["kp"], j["vp"],
                                              j["tables"], j["lens"], layer=1,
                                              interpret=True)
    np.testing.assert_allclose(one, np.asarray(jone), atol=TOL, rtol=0)
    np.testing.assert_allclose(pooled, np.asarray(jpooled), atol=TOL, rtol=0)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 16, 2, 16)) * 3).astype(np.float32)
    q, s = PA.quantize_kv_page(torch.from_numpy(x))
    jq, js = J.quantize_kv_page(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.shape == (3, 5, 2)
    tok = x[0, :4, 3]                                    # [S, Hkv, Dh]
    scale = np.asarray(js)[0, :4] * 0.5                  # some rows clip
    got = PA.quantize_kv_token(torch.from_numpy(tok), torch.from_numpy(scale))
    want = J.quantize_kv_token(jnp.asarray(tok), jnp.asarray(scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.abs().max()) == 127


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_make_decode_worklist_matches_jax(chunk):
    rng = np.random.default_rng(8)
    tables = rng.permutation(np.arange(1, 17)).reshape(4, 4).astype(np.int32)
    lens = np.asarray([1, 17, 40, 64], np.int32)
    got = PA.make_decode_worklist(torch.from_numpy(tables),
                                  torch.from_numpy(lens), 16, chunk=chunk)
    want = J.make_decode_worklist(jnp.asarray(tables), jnp.asarray(lens), 16,
                                  chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="multiple"):
        PA.make_decode_worklist(torch.from_numpy(tables),
                                torch.from_numpy(lens), 16, chunk=3)


def test_deferred_routes_raise_naming_the_roadmap():
    """No paged route is deferred any more: the batched schedules (the
    scatter wrapper's ``batched=True`` and the batched wrapper) give what
    their unbatched wrappers give, and the slot-major wrapper the gather
    golden over the partitioned table."""
    t, _ = _case(SHAPES["gqa"], seed=9)
    s, _, hkv, dh = 4, 4, 2, 16
    rng = np.random.default_rng(9)
    new = torch.from_numpy(rng.standard_normal((s, hkv, dh)).astype(np.float32))
    idx = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    off = torch.zeros((s,), dtype=torch.int32)
    outs = []
    for batched in (False, True):
        kp, vp = t["kp"].clone(), t["vp"].clone()
        outs.append(PA.paged_decode_attention_dma_scatter(
            t["q"], new, new, idx, off, kp, vp, t["tables"], t["lens"],
            layer=0, batched=batched))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert torch.equal(
        PA.paged_decode_attention_dma_batched(t["q"], t["kp"], t["vp"],
                                              t["tables"], t["lens"], layer=1),
        PA.paged_decode_attention_dma(t["q"], t["kp"], t["vp"], t["tables"],
                                      t["lens"], layer=1))
    maxp = t["tables"].shape[1]
    lens = torch.clamp(t["lens"], max=2 * 16)
    got = PA.paged_decode_attention_dma_slot(t["q"], t["kp"], t["vp"], lens,
                                             layer=0, cap=2, maxp_slot=maxp)
    want = PA.paged_decode_attention_xla(
        t["q"], t["kp"][0], t["vp"][0], PA.slot_tables(s, 2, maxp), lens)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_batched_alias_matches_jax_batched_kernel(chunk):
    """The batched alias against the TPU's cross-slot kernel in interpret
    mode, over its flat worklist (a chunk that does not divide maxp too),
    as ``tests/test_engine.py:682-711`` holds it to the golden."""
    t, j = _case(SHAPES["gqa"], seed=11)
    wl = J.make_decode_worklist_flat(j["tables"], j["lens"], 16, chunk=chunk)
    for layer in (0, 1):
        got = PA.paged_decode_attention_dma_batched(
            t["q"], t["kp"], t["vp"], t["tables"], t["lens"], layer=layer,
            chunk=chunk).numpy()
        ker = J.paged_decode_attention_dma_batched(
            j["q"], j["kp"], j["vp"], j["tables"], j["lens"], layer=layer,
            interpret=True, worklist=wl, chunk=chunk)
        np.testing.assert_allclose(got, np.asarray(ker), atol=TOL, rtol=0)


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_make_decode_worklist_flat_matches_jax(chunk):
    rng = np.random.default_rng(12)
    tables = rng.permutation(np.arange(1, 17)).reshape(4, 4).astype(np.int32)
    lens = np.asarray([1, 17, 40, 64], np.int32)
    got = PA.make_decode_worklist_flat(torch.from_numpy(tables),
                                       torch.from_numpy(lens), 16, chunk=chunk)
    want = J.make_decode_worklist_flat(jnp.asarray(tables),
                                       jnp.asarray(lens), 16, chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrappers_refuse_a_bad_layer():
    t, _ = _case(SHAPES["gqa"], seed=10)
    with pytest.raises(ValueError, match="layer"):
        PA.paged_decode_attention_dma(t["q"], t["kp"], t["vp"], t["tables"],
                                      t["lens"], layer=2)
    assert PA.paged_decode_attention_dma.launches == 0  # twins never count


# the paged kernel's split model: page 16 cut into splits that divide it and
# splits it divides, lengths on both sides of every split and page boundary
SPLIT_PAGE = 16
SPLIT_LENS = [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 48, 49, 64]


def _split_case(seed):
    """(port tensors, JAX arrays) at Hq 4, Hkv 2, Dh 16, page 16, 4 pages a
    slot: a slot for each of ``SPLIT_LENS`` and an idle slot (null page 0,
    length 1); one layer."""
    s = len(SPLIT_LENS) + 1
    t, j = _case((s, 4, 2, 16, SPLIT_PAGE, 4, SPLIT_LENS + [1]), seed,
                 layers=1)
    t["tables"][-1] = 0
    j["tables"] = jnp.asarray(t["tables"].numpy())
    return t, j


@pytest.mark.parametrize("split", [8, 16, 32, 64])
def test_split_model_over_int8_pages_matches_jax_golden(split):
    """int8 pages with their page scales: the split model folds the scales
    as the kernel does (score times k_scale, p times v_scale weighing
    v_int8) and meets JAX's dequantizing golden within INT8_TOL."""
    t, j = _split_case(seed=20 + split)
    kq, ks = PA.quantize_kv_page(t["kp"])
    vq, vs = PA.quantize_kv_page(t["vp"])
    got = PA.paged_decode_attention_split_plain(
        t["q"], kq[0], vq[0], t["tables"], t["lens"], split,
        k_scale=ks[0], v_scale=vs[0])
    jkq, jks = J.quantize_kv_page(j["kp"])
    jvq, jvs = J.quantize_kv_page(j["vp"])
    want = J.paged_decode_attention_xla_kv_int8(
        j["q"], jkq[0], jks[0], jvq[0], jvs[0], j["tables"], j["lens"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_TOL,
                               rtol=0)


@pytest.mark.parametrize("split", [8, 16, 32, 64])
def test_split_model_with_the_fused_row_matches_jax_scatter_kernel(split):
    """The split model taking the row of position lens - 1 from k_new/v_new
    over the pools as they were (that row NaN there: it is never read from
    the pool) against JAX's scatter kernel in interpret mode, which writes
    the row first and attends over the written pools, at the active slots
    (the idle slot's output is sampled by nobody, and JAX's kernel gives it
    no meaning); every slot, the idle one too, against the twin over the
    written pools."""
    t, j = _split_case(seed=40 + split)
    s, hkv, dh = t["q"].shape[0], 2, 16
    rng = np.random.default_rng(41 + split)
    k_new = rng.standard_normal((s, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((s, hkv, dh)).astype(np.float32)
    pos = t["lens"].numpy() - 1
    page_idx = np.take_along_axis(t["tables"].numpy(),
                                  (pos // SPLIT_PAGE)[:, None], 1)[:, 0]
    off = pos % SPLIT_PAGE
    jout, jk, jv = J.paged_decode_attention_dma_scatter(
        j["q"], jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(page_idx.astype(np.int32)),
        jnp.asarray(off.astype(np.int32)), j["kp"], j["vp"], j["tables"],
        j["lens"], layer=0, interpret=True)
    kp, vp = t["kp"][0].clone(), t["vp"][0].clone()
    kp[page_idx, off] = float("nan")
    vp[page_idx, off] = float("nan")
    got = PA.paged_decode_attention_split_plain(
        t["q"], kp, vp, t["tables"], t["lens"], split,
        k_new=torch.from_numpy(k_new), v_new=torch.from_numpy(v_new))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[:-1].numpy(), np.asarray(jout)[:-1],
                               atol=TOL, rtol=0)
    twin = PA.paged_decode_attention_xla(
        t["q"], torch.from_numpy(np.array(jk[0])),
        torch.from_numpy(np.array(jv[0])), t["tables"], t["lens"])
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=TOL, rtol=0)
