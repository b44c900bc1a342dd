"""Plain twins of the scan top-k kernels (cmw_rag_tpu_torch.ops.topk) against
the JAX goldens (``topk_xla``, ``topk_xla_int8``) and the Pallas kernels in
interpret mode, on the same inputs. Ids must match exactly, ties and
tombstones included; scores to 1e-6 (float32 sums in another order). The
CUDA kernels themselves run only on the card (``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import topk as J
from cmw_rag_tpu_torch.ops import topk as T


def _case(n=384, d=32, q=6, seed=0, tombstones=40, dup_of=5, dups=10):
    """Unit rows with an exact-tie group (``dups`` copies of row ``dup_of``,
    which query 0 equals) and random tombstones, one inside the tie group."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[100 : 100 + dups] = c[dup_of]
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[0] = c[dup_of]
    ids = np.arange(n, dtype=np.int32)
    ids[rng.choice(n, tombstones, replace=False)] = -1
    ids[103] = -1
    ids[dup_of] = dup_of
    return c, ids, qs


def _bf16(x):
    """The array rounded to bf16, as (jax bf16, torch bf16)."""
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("k", [1, 10, 20])
@pytest.mark.parametrize("chunk_rows", [100, 65536])
def test_plain_bf16_matches_xla_and_pallas(k, chunk_rows):
    c, ids, qs = _case()
    jc, tc = _bf16(c)
    jq, tq = _bf16(qs)
    xs, xi = J.topk_xla(jc, jnp.asarray(ids), jq, k)
    ps, pi = J.topk_pallas(jc, jnp.asarray(ids), jq, k, tile_n=128,
                           interpret=True)
    ts, ti = T.topk_plain(tc, torch.from_numpy(ids), tq, k,
                          chunk_rows=chunk_rows)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(xs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-6, rtol=0)
    if k >= 10:  # the tie group surfaces in id order, tombstone 103 never
        assert ti[0, :9].tolist() == [5, 100, 101, 102, 104, 105, 106, 107,
                                      108]


@pytest.mark.parametrize("k", [1, 20])
def test_plain_int8_matches_xla_and_pallas(k):
    c, ids, qs = _case(seed=1)
    jq8, jsc = J.quantize_rows_int8(jnp.asarray(c))
    tq8, tsc = T.quantize_rows_int8(torch.from_numpy(c))
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    jq, tq = _bf16(qs)
    xs, xi = J.topk_xla_int8(jq8, jsc, jnp.asarray(ids), jq, k)
    ps, pi = J.topk_pallas_int8(jq8, jsc, jnp.asarray(ids), jq, k,
                                tile_n=128, interpret=True)
    ts, ti = T.topk_plain_int8(tq8, tsc, torch.from_numpy(ids), tq, k,
                               chunk_rows=100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_allclose(ts.numpy(), np.asarray(xs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-6, rtol=0)


def test_plain_fewer_valid_rows_than_k():
    """k above the number of live rows: the tail is (NEG_INF, -1), as the
    Pallas kernel fills it."""
    c, ids, qs = _case(n=128, tombstones=0)
    ids[5:] = -1
    jc, tc = _bf16(c)
    jq, tq = _bf16(qs)
    ps, pi = J.topk_pallas(jc, jnp.asarray(ids), jq, 10, tile_n=128,
                           interpret=True)
    ts, ti = T.topk_plain(tc, torch.from_numpy(ids), tq, 10, chunk_rows=50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    assert np.all(ti.numpy()[:, 5:] == -1)
    assert np.all(ts.numpy()[:, 5:] == np.float32(T.NEG_INF))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-6, rtol=0)


def test_plain_all_tombstoned():
    c, ids, qs = _case(n=128, tombstones=0)
    ids[:] = -1
    jc, tc = _bf16(c)
    jq, tq = _bf16(qs)
    _, xi = J.topk_xla(jc, jnp.asarray(ids), jq, 5)
    _, ti = T.topk_plain(tc, torch.from_numpy(ids), tq, 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))


def test_merge_topk_matches_jax():
    scores = np.asarray([[0.9, 0.1, 0.5, 0.7, 0.7], [0.2, 0.2, 0.2, 0.3, -1]],
                        np.float32)
    ids = np.asarray([[3, 7, -1, 2, 9], [4, 1, 8, -1, 6]], np.int32)
    js, ji = J.merge_topk(jnp.asarray(scores), jnp.asarray(ids), 4)
    ts, ti = T.merge_topk(torch.from_numpy(scores), torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("int8", [False, True])
def test_wrappers_take_the_plain_twin_for_cpu_tensors(int8):
    """On CPU tensors the kernel wrappers run the plain twin and count no
    launch; mixed devices raise before anything runs."""
    c, ids, qs = _case(seed=2)
    _, tc = _bf16(c)
    _, tq = _bf16(qs)
    tids = torch.from_numpy(ids)
    before = (T.topk_scan_bf16.launches, T.topk_scan_int8.launches)
    if int8:
        q8, sc = T.quantize_rows_int8(torch.from_numpy(c))
        got = T.topk_scan_int8(q8, sc, tids, tq, 7)
        want = T.topk_plain_int8(q8, sc, tids, tq, 7)
    else:
        got = T.topk_scan_bf16(tc, tids, tq, 7)
        want = T.topk_plain(tc, tids, tq, 7)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert (T.topk_scan_bf16.launches, T.topk_scan_int8.launches) == before
    with pytest.raises(ValueError, match="one device"):
        T.topk_scan_bf16(tc.to("meta"), tids, tq, 7)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [129, 300, 384, 500])
def test_plain_large_k_matches_xla_and_pallas(int8, k):
    """Any k: past 128 (the CUDA kernels' shared-memory limit), at the
    corpus size, and past it, where the tail is (NEG_INF, -1). The Pallas
    kernel (interpret mode) is held at k = 129 only: its merge rounds run
    once per k, which takes tens of seconds per case in interpret mode."""
    c, ids, qs = _case(seed=3)
    jq, tq = _bf16(qs)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    if int8:
        jc8, jsc = J.quantize_rows_int8(jnp.asarray(c))
        tc8, tsc = T.quantize_rows_int8(torch.from_numpy(c))
        xs, xi = J.topk_xla_int8(jc8, jsc, jids, jq, k)
        pallas = lambda: J.topk_pallas_int8(jc8, jsc, jids, jq, k,  # noqa: E731
                                            tile_n=128, interpret=True)
        ts, ti = T.topk_scan_int8(tc8, tsc, tids, tq, k)
    else:
        jc, tc = _bf16(c)
        xs, xi = J.topk_xla(jc, jids, jq, k)
        pallas = lambda: J.topk_pallas(jc, jids, jq, k, tile_n=128,  # noqa: E731
                                       interpret=True)
        ts, ti = T.topk_scan_bf16(tc, tids, tq, k)
    assert ti.shape == (qs.shape[0], k)
    n = min(k, c.shape[0])  # lax.sort gives at most N columns
    np.testing.assert_array_equal(ti.numpy()[:, :n], np.asarray(xi)[:, :n])
    np.testing.assert_allclose(ts.numpy()[:, :n], np.asarray(xs)[:, :n],
                               atol=1e-6, rtol=0)
    live = int((ids >= 0).sum())
    assert (ti.numpy()[:, live:] == -1).all()
    assert (ts.numpy()[:, live:] == np.float32(T.NEG_INF)).all()
    if k == 129:
        ps, pi = pallas()
        np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
        np.testing.assert_allclose(ts.numpy(), np.asarray(ps), atol=1e-6,
                                   rtol=0)

