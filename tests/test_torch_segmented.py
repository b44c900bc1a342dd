"""The port's SegmentedIndex (cmw_rag_tpu_torch.index.shards) on the CPU:
the single-device cases of ``tests/test_shards.py`` (seal, quantized seal,
pending view, deletes across segments and in the pack window, compaction,
durability, the empty index, background seal and its recovery), the
manifest + npz form read and written by both packages, and the segmented
``TorchVectorStore``."""

import threading

import numpy as np
import pytest
import torch

from cmw_rag_tpu.index.shards import SegmentedIndex as JSeg
from cmw_rag_tpu_torch.index import shards as shards_mod
from cmw_rag_tpu_torch.index.shards import SegmentedIndex
from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore


def _vecs(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def make_index(**kw):
    kw.setdefault("dim", 16)
    kw.setdefault("block_n", 64)
    kw.setdefault("seal_threshold", 192)
    kw.setdefault("fresh_capacity", 256)
    kw.setdefault("nprobe", 64)
    kw.setdefault("device", "cpu")
    return SegmentedIndex(**kw)


class _Patch:
    """Swap ``IVFIndex.build`` (or ``_seal_pack``) for a wrapper while in
    the block."""

    def __init__(self, wrap, name="build"):
        self.wrap, self.name = wrap, name

    def __enter__(self):
        if self.name == "build":
            self.real = shards_mod.IVFIndex.build
            shards_mod.IVFIndex.build = staticmethod(self.wrap(self.real))
        else:
            self.real = shards_mod._seal_pack
            shards_mod._seal_pack = self.wrap(self.real)

    def __exit__(self, *exc):
        if self.name == "build":
            shards_mod.IVFIndex.build = self.real
        else:
            shards_mod._seal_pack = self.real


def test_seal_threshold_tile_rounding():
    assert make_index(seal_threshold=200).seal_threshold == 256
    assert make_index(block_n=1024, seal_threshold=100_000).seal_threshold \
        == 100_352
    assert JSeg(dim=16, block_n=64, seal_threshold=200,
                use_pallas=False).seal_threshold == 256


def test_seal_on_threshold():
    idx = make_index()
    idx.add(_vecs(150), np.arange(150, dtype=np.int32))
    assert not idx.sealed
    v2 = _vecs(100, seed=1)
    idx.add(v2, np.arange(150, 250, dtype=np.int32))
    assert len(idx.sealed) == 1
    assert idx.sealed[0].n_live == 192
    assert idx.fresh.n_live == 58
    assert idx.n_live == 250
    s, i = idx.search(v2[90], k=3)         # id 240, one of the carried rows
    assert i[0, 0] == 240 and s[0, 0] > 0.99


def test_quantized_seal_device_direct():
    idx = make_index(quantize=True)
    v = _vecs(250, seed=5)
    idx.add(v, np.arange(250, dtype=np.int32))
    assert len(idx.sealed) == 1
    assert idx.sealed[0].corpus.dtype == torch.int8
    assert idx.sealed[0].scales is not None
    assert idx.fresh.n_live == 58
    s, i = idx.search(v[10], k=3)          # sealed row
    assert i[0, 0] == 10 and s[0, 0] > 0.99
    s, i = idx.search(v[240], k=3)         # overflow row in the new tail
    assert i[0, 0] == 240 and s[0, 0] > 0.99


def test_pending_view_serves_rows_mid_seal():
    idx = make_index()
    v = _vecs(250, seed=7)
    seen = {}

    def spy(real):
        def build(*a, **kw):
            assert idx._pending is not None and not idx.sealed
            s, i = idx.search(v[5], k=3)
            seen["hit"] = (int(i[0, 0]), float(s[0, 0]))
            assert idx.n_live == 250
            idx.delete([5])
            seen["after"] = int(idx.search(v[5], k=3)[1][0, 0])
            return real(*a, **kw)
        return build

    with _Patch(spy):
        idx.add(v, np.arange(250, dtype=np.int32))
    assert seen["hit"][0] == 5 and seen["hit"][1] > 0.99
    assert seen["after"] != 5
    assert idx._pending is None
    assert 5 not in idx.search(v[5], k=5)[1][0]
    assert idx.n_live == 249


def test_search_spans_sealed_and_fresh():
    idx = make_index()
    v1 = _vecs(220, seed=0)
    idx.add(v1, np.arange(220, dtype=np.int32))
    v2 = _vecs(30, seed=2)
    idx.add(v2, np.arange(1000, 1030, dtype=np.int32))
    s, i = idx.search(v1[7], k=3)
    assert i[0, 0] == 7 and s[0, 0] > 0.99
    assert idx.search(v2[4], k=3)[1][0, 0] == 1004
    s, i = idx.search(np.stack([v1[7], v2[4], v1[100]]), k=3)   # a batch
    assert i[:, 0].tolist() == [7, 1004, 100]


def test_delete_across_segments():
    idx = make_index()
    v = _vecs(250)
    idx.add(v, np.arange(250, dtype=np.int32))
    idx.add(_vecs(10, seed=3), np.arange(500, 510, dtype=np.int32))
    assert idx.delete([7, 505]) == 2
    assert idx.delete([7]) == 0
    assert 7 not in idx.search(v[7], k=5)[1][0]
    assert idx.n_live == 258


def test_compact_drops_tombstones():
    for quantize in (False, True):
        idx = make_index(quantize=quantize)
        v = _vecs(250)
        idx.add(v, np.arange(250, dtype=np.int32))
        idx.add(_vecs(20, seed=4), np.arange(500, 520, dtype=np.int32))
        idx.delete(list(range(50)))
        idx.compact()
        assert len(idx.sealed) == 1 and idx.fresh.n_live == 0
        assert idx.n_live == 220
        assert idx.search(v[100], k=3)[1][0, 0] == 100
        assert idx.sealed[0].corpus.dtype == (torch.int8 if quantize
                                              else torch.bfloat16)
    idx = make_index()
    idx.add(_vecs(10), np.arange(10, dtype=np.int32))
    idx.delete(list(range(10)))
    idx.compact()                           # nothing live: empty index
    assert idx.sealed == [] and idx.n_live == 0


def test_queries_serve_during_compaction_and_seals():
    """A thread searching while the index compacts and seals in the
    background always finds its row (a lost swap would drop it)."""
    import sys

    idx = make_index(background_seal=True)
    v = _vecs(450)
    idx.add(v[:250], np.arange(250, dtype=np.int32))
    errors, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                i = idx.search(v[3], k=1)[1]
                if i[0, 0] != 3:
                    errors.append(f"wrong id {i[0, 0]}")
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=hammer)
    t.start()
    try:
        idx.compact()
        idx.add(v[250:450], np.arange(250, 450, dtype=np.int32))
        idx.compact()
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert not errors, errors[:3]
    assert idx.n_live == 450 and len(idx.sealed) == 1


def test_save_load_roundtrip(tmp_path):
    idx = make_index()
    v = _vecs(250)
    idx.add(v, np.arange(250, dtype=np.int32))
    idx.add(_vecs(15, seed=5), np.arange(500, 515, dtype=np.int32))
    idx.delete([0, 1])
    idx.save(tmp_path / "seg")
    loaded = SegmentedIndex.load(tmp_path / "seg", fresh_capacity=256,
                                 device="cpu")
    assert loaded.n_live == idx.n_live == 263
    assert idx.search(v[9], k=5)[1][0, 0] == loaded.search(v[9], k=5)[1][0, 0] == 9
    hv, hi = idx.to_host()
    lv, li = loaded.to_host()
    keep_h, keep_l = hi >= 0, li >= 0
    oh, ol = np.argsort(hi[keep_h]), np.argsort(li[keep_l])
    np.testing.assert_array_equal(hi[keep_h][oh], li[keep_l][ol])
    np.testing.assert_allclose(lv[keep_l][ol], hv[keep_h][oh], atol=4e-3)


@pytest.mark.parametrize("quantize", [False, True])
def test_either_package_loads_what_the_other_saved(tmp_path, quantize):
    v = _vecs(250)
    extra = _vecs(15, seed=5)
    jidx = JSeg(dim=16, block_n=64, seal_threshold=192, fresh_capacity=256,
                use_pallas=False, quantize=quantize)
    tidx = make_index(quantize=quantize)
    for idx in (jidx, tidx):
        idx.add(v, np.arange(250, dtype=np.int32))
        idx.add(extra, np.arange(500, 515, dtype=np.int32))
        idx.delete([0, 1, 504])
    jidx.save(tmp_path / "jax")
    tidx.save(tmp_path / "port")
    manifest = (tmp_path / "jax" / "manifest.json").read_text()
    assert manifest == (tmp_path / "port" / "manifest.json").read_text()
    into_port = SegmentedIndex.load(tmp_path / "jax", quantize=quantize,
                                    device="cpu")
    into_jax = JSeg.load(tmp_path / "port", use_pallas=False,
                         quantize=quantize)
    for idx in (into_port, into_jax):
        assert idx.n_live == 262 and len(idx.sealed) == 1
        _, i = idx.search(np.stack([v[9], extra[3], v[0]]), k=5)
        assert i[0, 0] == 9 and i[1, 0] == 503 and 0 not in i[2]
        hv, hi = idx.to_host()
        assert sorted(hi[hi >= 0].tolist()) == sorted(
            set(range(2, 250)) | {500, 501, 502, 503} | set(range(505, 515)))


def test_empty_index_search():
    idx = make_index()
    s, i = idx.search(_vecs(2), k=5)
    assert (i == -1).all() and np.isneginf(s).all() and i.shape == (2, 5)


def test_background_seal_serves_and_publishes():
    idx = make_index(background_seal=True)
    v = _vecs(420, seed=13)
    gate = threading.Event()

    def gated(real):
        def build(*a, **kw):
            gate.wait(timeout=10)
            return real(*a, **kw)
        return build

    with _Patch(gated):
        idx.add(v[:250], np.arange(250, dtype=np.int32))
        assert idx._pending is not None and not idx.sealed
        s, i = idx.search(v[5], k=3)
        assert i[0, 0] == 5 and s[0, 0] > 0.99
        idx.delete([5])
        gate.set()
        idx.wait_for_seal()
    assert len(idx.sealed) == 1 and idx._pending is None
    assert 5 not in idx.search(v[5], k=5)[1][0]
    idx.add(v[250:], np.arange(1000, 1170, dtype=np.int32))
    idx.seal()
    idx.wait_for_seal()
    assert idx.n_live == 419
    assert idx.search(v[300], k=3)[1][0, 0] == 1050


def _flaky(boom):
    def wrap(real):
        def build(*a, **kw):
            if boom["on"]:
                raise RuntimeError("transient device error")
            return real(*a, **kw)
        return build
    return wrap


def test_failed_background_build_recovers_on_next_seal():
    idx = make_index(background_seal=True)
    v = _vecs(420, seed=17)
    boom = {"on": True}
    with _Patch(_flaky(boom)):
        idx.add(v[:250], np.arange(250, dtype=np.int32))
        idx.wait_for_seal()
        assert not idx.sealed and idx._pending is not None
        s, i = idx.search(v[5], k=3)
        assert i[0, 0] == 5 and s[0, 0] > 0.99
        boom["on"] = False
        idx.add(v[250:], np.arange(1000, 1170, dtype=np.int32))
        idx.wait_for_seal()
    assert len(idx.sealed) == 2 and idx.n_live == 420
    assert idx.search(v[5], k=3)[1][0, 0] == 5


def test_delete_during_pack_window_reaches_segment_and_tail():
    idx = make_index()
    v = _vecs(250, seed=23)
    fired = {}

    def window(real):
        def pack(*a, **kw):
            out = real(*a, **kw)
            if not fired:
                assert idx._sealing and idx._pending is None
                fired["removed"] = idx.delete([7, 200])
            return out
        return pack

    with _Patch(window, name="_seal_pack"):
        idx.add(v, np.arange(250, dtype=np.int32))
    idx.wait_for_seal()
    assert fired["removed"] == 2
    assert not idx._sealing and idx._pending is None
    assert idx.n_live == 248
    assert 7 not in idx.search(v[7], k=10)[1][0]
    assert 200 not in idx.search(v[200], k=10)[1][0]


def test_save_after_dead_background_build_keeps_rows(tmp_path):
    idx = make_index(background_seal=True)
    v = _vecs(250, seed=29)
    boom = {"on": True}
    with _Patch(_flaky(boom)):
        idx.add(v, np.arange(250, dtype=np.int32))
        idx.wait_for_seal()
        assert idx._pending is not None
        boom["on"] = False
        idx.save(tmp_path)
    assert idx._pending is None
    idx2 = SegmentedIndex.load(tmp_path, device="cpu")
    assert idx2.n_live == 250
    assert idx2.search(v[5], k=3)[1][0, 0] == 5


def test_delete_counts_pending_rows_and_n_live():
    idx = make_index(background_seal=True)
    v = _vecs(250, seed=31)
    gate = threading.Event()

    def gated(real):
        def build(*a, **kw):
            gate.wait(timeout=10)
            return real(*a, **kw)
        return build

    with _Patch(gated):
        idx.add(v, np.arange(250, dtype=np.int32))
        assert idx._pending is not None
        n0 = idx.n_live
        assert idx.delete([5]) == 1
        assert idx.delete([5]) == 0
        assert idx.n_live == n0 - 1
        gate.set()
        idx.wait_for_seal()
    assert idx.n_live == n0 - 1
    assert 5 not in idx.search(v[5], k=5)[1][0]


def test_segmented_store_and_its_limits():
    store = TorchVectorStore(dim=16, kind="segmented", block_n=64,
                             seal_threshold=64, fresh_capacity=128,
                             device="cpu")
    v = _vecs(100)
    store.add([f"t{i}" for i in range(100)],
              [{"kbId": str(i // 10)} for i in range(100)],
              [f"c{i}" for i in range(100)], v)
    assert len(store.index.sealed) == 1 and store.count() == 100
    hits = store.search(v[[3, 90]], k=2)
    assert [h[0].id for h in hits] == ["c3", "c90"]
    assert store.delete_where({"kbId": "0"}) == 10
    assert all(d.id != "c3" for d in store.search(v[3], k=5)[0])
    with pytest.raises(NotImplementedError):
        make_index(mesh=object())
