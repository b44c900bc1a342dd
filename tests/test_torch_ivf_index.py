"""The port's IVFIndex (cmw_rag_tpu_torch.index.ivf) against the JAX
package's, on the CPU.

- A JAX index (``interpret=True``: one query takes its probed Pallas kernel,
  a batch its union kernel, in interpret mode) carried over as numpy arrays
  answers the same in the port: ids equal, scores to 1e-5 (float32 sums in
  another order). Rows and queries are random and rounded to bf16, so that
  no two scores tie (see ``test_torch_ivf_scan.py`` on the union kernel's
  tie rule).
- The port's own ``build``, handed the initial centroid rows JAX's k-means
  draws (``init_idx``), reproduces JAX's layout on separated clusters: ids
  equal, bf16 rows within one bf16 step (both normalise in float32, summing
  in another order), int8 rows within one step with scales to 1e-6
  relative, centroids to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.index.ivf import IVFIndex as JIVF
from cmw_rag_tpu.ops.topk import quantize_rows_int8 as jax_quantize
from cmw_rag_tpu_torch.index.ivf import IVFIndex, union_blocks
from cmw_rag_tpu_torch.ops.topk import (NEG_INF, quantize_rows_int8,
                                        topk_plain, topk_plain_int8)

D = 32


def _clustered(n_clusters=16, per=61, d=D, seed=0, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = [c + spread * rng.standard_normal((per, d)).astype(np.float32)
            for c in centers]
    rows = np.concatenate(rows)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def jax_init(n, nlist, seed):
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (nlist,),
                                      replace=n < nlist))


def _carried(j: JIVF) -> IVFIndex:
    scales = None if j.scales is None else np.asarray(j.scales)
    corpus = np.asarray(j.corpus) if scales is not None else np.asarray(
        j.corpus, np.float32)
    return IVFIndex(corpus, np.asarray(j.ids), np.asarray(j.block_centroids),
                    j.block_n, scales=scales, device="cpu")


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("qn", [1, 6])
def test_carried_index_answers_as_the_jax_index(quantize, qn):
    data = _bf16(_clustered(seed=1))
    j = JIVF.build(data, block_n=64, nlist=16, use_pallas=False,
                   interpret=True, quantize=quantize)
    t = _carried(j)
    assert t.n_blocks == j.n_blocks == 16 and t.n_live == j.n_live == 976
    rng = np.random.default_rng(2)
    q = _bf16(data[rng.choice(len(data), qn, replace=False)]
              + 0.1 * rng.standard_normal((qn, D)).astype(np.float32))
    for k, nprobe in ((10, 4), (3, 1), (40, 16)):
        js, ji = j.search(q, k, nprobe=nprobe)
        ts, ti = t.search(q, k, nprobe=nprobe)
        assert ts.dtype == np.float32 and ti.dtype == np.int32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_build_reproduces_the_jax_layout_given_its_init(quantize, seed):
    data = _clustered(seed=seed)                  # 976 rows: 48 pad rows
    j = JIVF.build(data, block_n=64, nlist=16, seed=seed, use_pallas=False,
                   quantize=quantize)
    t = IVFIndex.build(data, block_n=64, nlist=16, seed=seed, device="cpu",
                       quantize=quantize, init_idx=jax_init(976, 16, seed))
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    assert (t.ids.numpy()[-48:] == -1).all()
    np.testing.assert_allclose(t.block_centroids.numpy(),
                               np.asarray(j.block_centroids), rtol=0,
                               atol=1e-5)
    if quantize:
        d8 = t.corpus.numpy().astype(int) - np.asarray(j.corpus).astype(int)
        assert np.abs(d8).max() <= 1
        np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales),
                                   rtol=1e-6)
    else:
        tv, jv = t.corpus.float().numpy(), np.asarray(j.corpus, np.float32)
        step = np.ldexp(1.0, np.frexp(np.abs(jv))[1] - 8)
        assert (np.abs(tv - jv) <= step).all()
        assert (tv[-48:] == 0).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_build_quantized_reproduces_the_jax_layout_given_its_init(seed):
    data = _clustered(seed=seed)
    ids = np.arange(976, dtype=np.int32)[::-1].copy()
    j8, jsc = jax_quantize(jnp.asarray(data))
    t8, tsc = quantize_rows_int8(torch.from_numpy(data))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    j = JIVF.build_quantized(j8, jsc, jnp.asarray(ids), block_n=64, nlist=16,
                             seed=seed, use_pallas=False)
    t = IVFIndex.build_quantized(t8, tsc, ids, block_n=64, nlist=16,
                                 seed=seed, device="cpu",
                                 init_idx=jax_init(976, 16, seed))
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.corpus.numpy(), np.asarray(j.corpus))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_allclose(t.block_centroids.numpy(),
                               np.asarray(j.block_centroids), rtol=0,
                               atol=1e-5)


def test_build_quantized_matches_build():
    data = _clustered(per=128)
    ids = np.arange(len(data), dtype=np.int32)
    q8, sc = quantize_rows_int8(torch.from_numpy(data))
    a = IVFIndex.build(data, ids, block_n=128, nlist=16, quantize=True,
                       kmeans_train_rows=512, device="cpu")
    b = IVFIndex.build_quantized(q8, sc, ids, block_n=128, nlist=16,
                                 kmeans_train_rows=512, device="cpu")
    assert b.corpus.dtype == torch.int8 and b.scales is not None
    rng = np.random.default_rng(3)
    q = data[rng.choice(len(data), 8, replace=False)] \
        + 0.05 * rng.standard_normal((8, D)).astype(np.float32)
    sa, ia = a.search(q, k=10, nprobe=a.n_blocks)   # full probe: exact scans
    sb, ib = b.search(q, k=10, nprobe=b.n_blocks)
    np.testing.assert_array_equal(ia[:, 0], ib[:, 0])
    np.testing.assert_allclose(sa[:, 0], sb[:, 0], atol=2e-2)


@pytest.mark.parametrize("quantize", [False, True])
def test_recall_and_union_superset(quantize):
    data = _clustered(per=128)
    idx = IVFIndex.build(data, block_n=128, nlist=16, quantize=quantize,
                         device="cpu")
    rng = np.random.default_rng(3)
    q = data[rng.choice(len(data), 8, replace=False)] \
        + 0.05 * rng.standard_normal((8, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt = torch.from_numpy(q).bfloat16()
    if quantize:   # exact over the index's own rows
        _, exact = topk_plain_int8(idx.corpus, idx.scales, idx.ids, qt, 10)
    else:
        _, exact = topk_plain(idx.corpus, idx.ids, qt, 10)
    exact = exact.numpy()
    assert idx.recall_at_k(q, 10, 8, exact) >= 0.9
    assert idx.recall_at_k(q, 10, idx.n_blocks, exact) == 1.0
    _, union = idx.search(q, 10, nprobe=2, batch_probe=True)
    _, solo = idx.search(q, 10, nprobe=2, batch_probe=False)
    for u, s, e in zip(union, solo, exact):
        assert len(set(u) & set(e)) >= len(set(s) & set(e))


def test_delete_padding_and_empty_slots():
    data = _clustered(n_clusters=4, per=50)        # 200 rows → 256
    idx = IVFIndex.build(data, block_n=64, device="cpu")
    assert idx.corpus.shape == (256, D) and idx.n_blocks == 4
    s, i = idx.search(data[:3], k=5, nprobe=2)
    assert s.shape == (3, 5) and (i[i >= 0] < 200).all()
    n0 = idx.n_live
    old_ids = idx.ids
    assert idx.delete([0, 1, 2, 999]) == 3 and idx.n_live == n0 - 3
    assert idx.delete([0]) == 0
    assert int((old_ids >= 0).sum()) == 200          # readers keep theirs
    _, got = idx.search(data[0], k=5, nprobe=idx.n_blocks)
    assert 0 not in got[0]
    s, i = idx.search(data[:2], k=300, nprobe=idx.n_blocks)
    assert (i[:, 197:] == -1).all() and (s[:, 197:] == NEG_INF).all()


def test_probe_order_and_union_list():
    idx = IVFIndex.build(_clustered(n_clusters=4, per=64), block_n=64,
                         device="cpu")
    idx.block_centroids[2] = idx.block_centroids[1]   # an exact tie
    qt = idx.block_centroids[1:2].clone()
    assert idx.probe(qt, 2).tolist() == [[1, 2]]      # lower block first
    block_idx = torch.tensor([[5, 3, 9], [3, 7, 5]], dtype=torch.int32)
    union, n = union_blocks(block_idx)
    assert union.tolist() == [3, 5, 7, 9, 3, 3] and n.tolist() == [4]
    assert union.dtype == n.dtype == torch.int32


def test_refuses_a_mesh():
    with pytest.raises(NotImplementedError):
        IVFIndex.build(_clustered(n_clusters=2, per=64), block_n=64,
                       mesh=object(), device="cpu")
