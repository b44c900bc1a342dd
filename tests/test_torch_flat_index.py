"""The port's FlatIndex and TorchVectorStore (cmw_rag_tpu_torch.index)
against the JAX package's ``FlatIndex(use_pallas=False)`` (the ``topk_xla``
golden) and ``TPUVectorStore``, on the same vectors and ids.

Both normalise rows on add in float32 and round them to bf16 (or quantise
them to int8). The two frameworks sum the norm in another order, so a row
of arbitrary floats may round to a neighbouring bf16 value in a few
elements (about 3 in 100,000 here): ``test_rows_of_any_vectors_agree_to_one
rounding step`` bounds that. The search tests use rows whose norm is 1
exactly in float32 in any summation order (components n/64 with integer n
and sum of n^2 = 4096), so both store identical rows and the comparison
holds the search itself (their largest |n| is odd, so that no int8 quotient
``x / scale`` lies at a rounding tie, which the two may resolve apart): ids
equal, ties and tombstones included, scores to
1e-6 (float32 sums in another order); past the live rows both return the
scan's empty score and id -1, and past ``capacity`` score -inf and id -1. A
store saved by either package loads in the other and answers the same.
"""

import numpy as np
import pytest
import torch

from cmw_rag_tpu.index.flat import FlatIndex as JFlat
from cmw_rag_tpu.index.store import InMemoryStore
from cmw_rag_tpu.index.tpu_store import TPUVectorStore
from cmw_rag_tpu_torch.index.flat import FlatIndex
from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore

D = 32


def _four_squares(r):
    """(a, b, c, d) with a^2 + b^2 + c^2 + d^2 = r (Lagrange)."""
    for a in range(int(r ** 0.5), -1, -1):
        for b in range(min(a, int((r - a * a) ** 0.5)), -1, -1):
            for c in range(min(b, int((r - a * a - b * b) ** 0.5)), -1, -1):
                rest = r - a * a - b * b - c * c
                d = int(round(rest ** 0.5))
                if d * d == rest and d <= c:
                    return a, b, c, d
    raise AssertionError(r)


def _vecs(n, seed=0, d=D):
    """Unit rows with components n/64, exact in bf16 and in float32 norms,
    and an odd largest |n|."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, d), np.float32)
    for i in range(n):
        while True:
            head = rng.integers(-16, 17, d - 4)
            rest = 4096 - int((head ** 2).sum())
            if rest < 0:
                continue
            row = np.concatenate([head, _four_squares(rest)])
            if np.abs(row).max() % 2:
                break
        row = row * rng.choice([-1, 1], d)
        out[i] = rng.permutation(row) / 64.0
    assert np.array_equal(np.linalg.norm(out, axis=1), np.ones(n, np.float32))
    return out


def _random_unit(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, D)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pair(capacity=512, quantize=False):
    return (JFlat(dim=D, capacity=capacity, use_pallas=False,
                  quantize=quantize),
            FlatIndex(dim=D, capacity=capacity, quantize=quantize,
                      device="cpu"))


def _same(jidx, tidx, queries, k):
    js, ji = jidx.search(queries, k)
    ts, ti = tidx.search(queries, k)
    assert ts.shape == ji.shape == (len(queries), k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    return ts, ti


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("k", [1, 20, 129, 1000, 3000])
def test_search_matches_jax(quantize, k):
    v = _vecs(1200)
    v[700:705] = v[3]          # an exact-tie group of query 0
    jidx, tidx = _pair(capacity=2048, quantize=quantize)
    ext = np.arange(1200, dtype=np.int32)[::-1].copy()
    jidx.add(v, ext)
    tidx.add(v, ext)
    cap = jidx.capacity        # 2048 rounded to the tile: 4096 for int8
    assert tidx.capacity == cap
    jv, jids = jidx.to_host()
    tv, tids = tidx.to_host()
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tv, jv)
    q = _vecs(5, seed=1)
    q[0] = v[3]
    ts, ti = _same(jidx, tidx, q, k)
    if k >= 6:  # the tie group, in ascending external id
        assert ti[0, :6].tolist() == sorted(ext[[3, 700, 701, 702, 703, 704]])
    if k > 1200:  # empty slots, then past capacity
        assert (ti[:, 1200:] == -1).all()
        assert np.isneginf(ts[:, cap:]).all() and (k <= cap or not quantize)


@pytest.mark.parametrize("quantize", [False, True])
def test_delete_growth_and_duplicates_match_jax(quantize):
    jidx, tidx = _pair(capacity=128, quantize=quantize)
    v = _vecs(300, seed=2)
    for idx in (jidx, tidx):
        idx.add(v[:100])
        idx.add(v[100:300])            # grows 128 → 512 (tile 128 units)
        assert idx.delete([0, 5, 150, 999]) == 3
        with pytest.raises(ValueError, match="duplicate"):
            idx.add(v[:1], np.asarray([7], np.int32))
        with pytest.raises(ValueError, match="non-negative"):
            idx.add(v[:1], np.asarray([-2], np.int32))
    assert (tidx.capacity, tidx.n_live, tidx.n_slots, tidx.epoch) == \
        (jidx.capacity, jidx.n_live, jidx.n_slots, jidx.epoch)
    _, ti = _same(jidx, tidx, v[[0, 5, 150, 200]], 40)
    assert not np.isin(ti, [0, 5, 150]).any()
    # a deleted id may be added again
    for idx in (jidx, tidx):
        idx.add(v[:1], np.asarray([5], np.int32))
    _same(jidx, tidx, v[:3], 10)


@pytest.mark.parametrize("quantize", [False, True])
def test_rows_of_any_vectors_agree_to_one_rounding_step(quantize):
    v = _random_unit(1200, seed=9) * 3.0
    jidx, tidx = _pair(capacity=2048, quantize=quantize)
    jidx.add(v)
    tidx.add(v)
    jv, _ = jidx.to_host()
    tv, _ = tidx.to_host()
    if quantize:  # one int8 step of the row's scale (which may differ in
        # its last bit, moving every dequantized value of the row with it)
        step = np.abs(jv).max(axis=1, keepdims=True) / 127.0
    else:  # one bf16 step: 2^-7 of the value's binade, in a few elements
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jv), 1e-30))) - 7)
        assert (tv != jv).mean() < 1e-3
    assert (np.abs(tv - jv) <= step * 1.0001).all()


def test_matches_the_numpy_store_golden():
    """bf16 storage aside, the index ranks as the exact float32 store does
    (queries far from ties)."""
    v = _random_unit(400, seed=3)
    golden = InMemoryStore()
    golden.add([f"t{i}" for i in range(400)], [{}] * 400,
               [str(i) for i in range(400)], v)
    tidx = FlatIndex(dim=D, capacity=512, device="cpu")
    tidx.add(v)
    q = v[:6]
    _, ti = tidx.search(q, 1)
    want = [[int(d.id) for d in row[:1]] for row in golden.search(q, 1)]
    assert ti.tolist() == want


def test_snapshot_is_not_torn_by_a_later_add():
    """A reader's snapshot does not see rows added or deleted after it."""
    tidx = FlatIndex(dim=D, capacity=256, device="cpu")
    v = _vecs(20, seed=4)
    tidx.add(v[:10])
    snap = tidx._snap
    tidx.add(v[10:])
    tidx.delete([0])
    assert snap.n_slots == 10 and int((snap.ids >= 0).sum()) == 10
    assert int(snap.ids[0]) == 0 and int(snap.ids[10]) == -1
    assert tidx.epoch == snap.epoch + 2


def test_refuses_a_mesh_and_the_segmented_kind():
    """The sharded indexes are not ported: a mesh is refused by either kind
    (the segmented kind itself is ported, ``test_torch_segmented.py``)."""
    with pytest.raises(NotImplementedError):
        FlatIndex(dim=D, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        TorchVectorStore(dim=D, kind="segmented", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown index kind"):
        TorchVectorStore(dim=D, kind="hnsw", device="cpu")


def _fill(store, n=60, seed=5):
    v = _vecs(n, seed=seed)
    store.add(texts=[f"chunk {i}" for i in range(n)],
              metadatas=[{"kbId": str(4000 + i // 3), "stable_id": f"s{i}"}
                         for i in range(n)],
              ids=[f"c{i}" for i in range(n)], embeddings=v)
    store.delete_where({"kbId": "4001"})
    store.add(texts=["chunk 7 again"], metadatas=[{"kbId": "4002"}],
              ids=["c7"], embeddings=v[:1])     # upsert
    return v


def _docs(hits):
    return [[(d.id, d.text, d.metadata, round(d.score, 5)) for d in row]
            for row in hits]


@pytest.mark.parametrize("quantize", [False, True])
def test_store_matches_jax_store(quantize):
    js = TPUVectorStore(dim=D, use_pallas=False, quantize=quantize)
    ts = TorchVectorStore(dim=D, quantize=quantize, device="cpu")
    v = _fill(js)
    _fill(ts)
    assert ts.count() == js.count() == 57
    q = v[[0, 10, 30]]
    assert _docs(ts.search(q, 8)) == _docs(js.search(q, 8))
    assert ts.get_where({"kbId": "4002"}) == js.get_where({"kbId": "4002"})
    assert ts.get_any_doc_meta({"kbId": "4005"}) == \
        js.get_any_doc_meta({"kbId": "4005"})
    assert ts.get_by_id("c7").text == js.get_by_id("c7").text == "chunk 7 again"
    assert ts.get_by_id("c3") is None and js.get_by_id("c3") is None


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_round_trip_across_packages(direction, tmp_path):
    js = TPUVectorStore(dim=D, use_pallas=False)
    ts = TorchVectorStore(dim=D, device="cpu")
    v = _fill(js)
    _fill(ts)
    q = v[[1, 20, 40]]
    want = _docs(js.search(q, 10))
    if direction == "jax_to_port":
        js.save(tmp_path)
        loaded = TorchVectorStore.load(tmp_path, device="cpu")
    else:
        ts.save(tmp_path)
        loaded = TPUVectorStore.load(tmp_path, use_pallas=False)
    assert loaded.count() == 57
    assert _docs(loaded.search(q, 10)) == want
    loaded.add(["new"], [{"kbId": "9"}], ["c-new"], v[:1])  # ids continue
    assert loaded.get_by_id("c-new") is not None and loaded.count() == 58


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlatIndex(dim=D)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchVectorStore(dim=D)


@pytest.mark.parametrize("quantize", [False, True])
def test_from_host_and_snapshot_properties_match_jax(quantize):
    """``from_host`` rebuilds an index from a ``to_host`` dump (tombstones
    dropped) in both packages; ``vecs``, ``ids`` and ``scales`` expose the
    published snapshot as JAX's properties do. Rebuilt int8 rows are
    requantized from their dequantized floats: the int8 values are equal,
    the live rows' scales within 1e-6 relative (the norm is summed in
    another order; free slots hold scale 0 here, 1e-12 / 127 in JAX, and
    are never read)."""
    jidx, tidx = _pair(quantize=quantize)
    vecs = _vecs(40, seed=7)
    ids = np.arange(100, 140, dtype=np.int32)
    jidx.add(vecs, ids)
    tidx.add(vecs, ids)
    jidx.delete([103, 117])
    tidx.delete([103, 117])
    jv, ji = jidx.to_host()
    tv, ti = tidx.to_host()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    jnew = JFlat.from_host(jv, ji, use_pallas=False, quantize=quantize)
    tnew = FlatIndex.from_host(tv, ti, quantize=quantize, device="cpu")
    assert tnew.n_live == jnew.n_live == 38
    assert tnew.capacity == jnew.capacity
    np.testing.assert_array_equal(tnew.ids.numpy(), np.asarray(jnew.ids))
    np.testing.assert_array_equal(tnew.vecs.float().numpy(),
                                  np.asarray(jnew.vecs, np.float32))
    if quantize:
        n = tnew.n_slots
        assert tnew.scales.shape == jnew.scales.shape
        np.testing.assert_allclose(tnew.scales[:n].numpy(),
                                   np.asarray(jnew.scales)[:n], rtol=1e-6,
                                   atol=0)
    else:
        assert tnew.scales is None and jnew.scales is None
    assert tnew.vecs is tnew._snap.vecs and tnew.ids is tnew._snap.ids
    _same(jnew, tnew, _vecs(5, seed=8), 10)
