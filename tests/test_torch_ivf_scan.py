"""The port's IVF scan wrappers (cmw_rag_tpu_torch.ops.ivf_scan) on the CPU,
where they run their plain twins, against the JAX package: its golden
``ivf_probed_scan_xla`` and its Pallas kernels in interpret mode.

Inputs: rows and queries whose components are n/64 (unit norm exactly,
exact in bf16), so that every score, a multiple of 1/4096, is exact in
float32 in any summation order: ids are held equal, ties included, and
scores to 1e-6. Such scores tie often, which is what the probed and golden
comparisons want. The TPU union kernel keeps out a row that exactly ties a
query's k-th score from a later block (it merges a block only when some
score strictly beats the k-th), so the union comparisons with that kernel
use generic rows (random, rounded to bf16; scores to 1e-5, ids wherever
neighbouring scores differ by more), and the exact order is held on the
tie-heavy rows against ``topk_xla`` over the union's rows, as the JAX
package's own tests hold its union kernel. ``test_union_tie_deviation``
plants such a tie and shows both results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import ivf_scan as J
from cmw_rag_tpu.ops.topk import quantize_rows_int8 as jax_quantize
from cmw_rag_tpu.ops.topk import topk_xla, topk_xla_int8
from cmw_rag_tpu_torch.ops import ivf_scan as V
from cmw_rag_tpu_torch.ops.topk import NEG_INF, quantize_rows_int8
from tests.test_torch_flat_index import _vecs

D = 32
BLOCK_N = 64
N_BLOCKS = 8


def _case(int8, exact=True, seed=0, qn=4):
    """(port arrays, JAX arrays) of a blocked corpus: ids a permutation
    with tombstones, row 70 duplicated at 100 (a tie inside block 1),
    query 0 equal to row 70."""
    n = N_BLOCKS * BLOCK_N
    if exact:
        rows, q = _vecs(n, seed=seed), _vecs(qn, seed=seed + 1)
    else:
        rng = np.random.default_rng(seed)
        rows = rng.standard_normal((n, D)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        q = rng.standard_normal((qn, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        rows = torch.from_numpy(rows).bfloat16().float().numpy()
        q = torch.from_numpy(q).bfloat16().float().numpy()
    rows[100] = rows[70]
    q[0] = rows[70]
    ids = np.random.default_rng(seed + 2).permutation(n).astype(np.int32)
    ids[[5, 66, 200, 300]] = -1
    t = dict(corpus=torch.from_numpy(rows).bfloat16(), scales=None,
             ids=torch.from_numpy(ids), q=torch.from_numpy(q).bfloat16())
    j = dict(corpus=jnp.asarray(rows, jnp.bfloat16), scales=None,
             ids=jnp.asarray(ids), q=jnp.asarray(q, jnp.bfloat16))
    if int8:
        t["corpus"], t["scales"] = quantize_rows_int8(torch.from_numpy(rows))
        j["corpus"], j["scales"] = jax_quantize(jnp.asarray(rows))
        np.testing.assert_array_equal(t["corpus"].numpy(),
                                      np.asarray(j["corpus"]))
        np.testing.assert_array_equal(t["scales"].numpy(),
                                      np.asarray(j["scales"]))
    return t, j


def _probes(qn=4, p=3, seed=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(N_BLOCKS, p, replace=False)
                     for _ in range(qn)]).astype(np.int32)


def _port(fn, t, table, k, n_unique=None):
    table = torch.from_numpy(table)
    extra = {} if n_unique is None else {
        "n_unique": torch.tensor([n_unique], dtype=torch.int32)}
    if t["scales"] is None:
        s, i = getattr(V, fn)(t["corpus"], t["ids"], t["q"], table, k,
                              BLOCK_N, **extra)
    else:
        s, i = getattr(V, fn + "_int8")(t["corpus"], t["scales"], t["ids"],
                                        t["q"], table, k, BLOCK_N, **extra)
    return s.numpy(), i.numpy()


def _jax(fn, j, table, k, n_unique=None):
    extra = {} if n_unique is None else {
        "n_unique": jnp.asarray([n_unique], jnp.int32)}
    if j["scales"] is None:
        s, i = getattr(J, fn)(j["corpus"], j["ids"], j["q"],
                              jnp.asarray(table), k, BLOCK_N, True, **extra)
    else:
        s, i = getattr(J, fn + "_int8")(j["corpus"], j["scales"], j["ids"],
                                        j["q"], jnp.asarray(table), k,
                                        BLOCK_N, True, **extra)
    return np.asarray(s), np.asarray(i)


def _golden(j, table, k):
    s, i = J.ivf_probed_scan_xla(j["corpus"], j["ids"], j["q"],
                                 jnp.asarray(table), k, BLOCK_N,
                                 scales=j["scales"])
    return np.asarray(s), np.asarray(i)


def _equal(got, want, atol=1e-6):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)


def _same_ranking(got, want, tol=1e-5):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)
    gap = np.abs(np.diff(ws, axis=1)) > tol
    clear = np.ones(wi.shape, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    np.testing.assert_array_equal(gi[clear], wi[clear])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [1, 5, 20, 130, 3 * BLOCK_N])
def test_probed_twin_matches_the_jax_golden(int8, k):
    """Ties in id order, tombstones, k > 128 and k past the live rows."""
    t, j = _case(int8)
    table = _probes()
    table[0, 0] = 1                       # query 0's tie group is probed
    got = _port("ivf_probed_scan", t, table, k)
    _equal(got, _golden(j, table, k))
    _equal(got, tuple(x.numpy() for x in V.ivf_probed_scan_golden(
        t["corpus"], t["ids"], t["q"], torch.from_numpy(table), k, BLOCK_N,
        scales=t["scales"])))
    assert got[1].shape == (4, k)
    if k >= 2:
        assert got[1][0, :2].tolist() == sorted(t["ids"][[70, 100]].tolist())
    if k == 3 * BLOCK_N:                  # tombstones among the rows: empty slots
        dead = got[1] < 0
        assert dead.any() and (got[0][dead] == NEG_INF).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [5, 20])
def test_probed_twin_matches_the_pallas_kernel(int8, k):
    t, j = _case(int8)
    table = _probes()
    table[0, 0] = 1
    table[2] = [4, 4, 6]                  # a repeated block: knocked out by id
    got = _port("ivf_probed_scan", t, table, k)
    _equal(got, _jax("ivf_probed_scan", j, table, k))
    assert len(set(got[1][2].tolist()) - {-1}) == k


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k,n_unique", [(5, 5), (20, None)])
def test_union_twin_matches_the_pallas_kernel(int8, k, n_unique):
    """A padded union list (``n_unique``) and, without it, a list that
    repeats blocks (each id comes back once)."""
    t, j = _case(int8, exact=False, seed=3, qn=6)
    table = (np.array([0, 2, 3, 5, 7, 0, 0, 0, 0, 0, 0, 0], np.int32)
             if n_unique else np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, 0],
                                       np.int32))
    got = _port("ivf_union_scan", t, table, k, n_unique)
    _same_ranking(got, _jax("ivf_union_scan", j, table, k, n_unique))
    for row in got[1]:
        assert len(set(row.tolist())) == k


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [1, 20, 130, 500])
def test_union_twin_is_exact_over_the_union_rows(int8, k):
    """Tie-heavy scores, k > 128 and k past the live rows: the union twin
    equals ``topk_xla`` over the rows of the listed blocks."""
    t, j = _case(int8)
    blocks = [1, 3, 4, 6]
    table = np.array(blocks + [3, 1, 1, 1], np.int32)   # repeats past n_unique
    got = _port("ivf_union_scan", t, table, k, n_unique=6)
    rows = np.concatenate([np.arange(b * BLOCK_N, (b + 1) * BLOCK_N)
                           for b in blocks])
    kk = min(k, len(rows))
    if j["scales"] is None:
        ws, wi = topk_xla(j["corpus"][rows], j["ids"][rows], j["q"], kk)
    else:
        ws, wi = topk_xla_int8(j["corpus"][rows], j["scales"][rows],
                               j["ids"][rows], j["q"], kk)
    ws, wi = np.asarray(ws), np.asarray(wi)
    if k > len(rows):
        ws = np.pad(ws, ((0, 0), (0, k - len(rows))), constant_values=NEG_INF)
        wi = np.pad(wi, ((0, 0), (0, k - len(rows))), constant_values=-1)
    wi = np.where(ws > NEG_INF / 2, wi, -1)
    _equal(got, (ws, wi))


def test_union_tie_deviation():
    """A row that exactly ties query 0's k-th score, with a smaller id, in
    a later block: the TPU union kernel keeps it out (it merges a block only
    when a score strictly beats the k-th); the port keeps the exact order."""
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((2 * BLOCK_N, D)).astype(np.float32)
    rows[:, 0] = -np.abs(rows[:, 0])                  # every other score < 0
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[0] = 0.0
    rows[0, :2] = [0.875, 0.484375]                   # score 0.875, id 10
    rows[1] = 0.0
    rows[1, :2] = [0.5, 0.875]                        # score 0.5, id 20
    rows[BLOCK_N + 3] = rows[1]                       # ties it, id 5
    ids = np.arange(100, 100 + 2 * BLOCK_N, dtype=np.int32)
    ids[[0, 1, BLOCK_N + 3]] = [10, 20, 5]
    q = np.zeros((1, D), np.float32)
    q[0, 0] = 1.0
    table = np.array([0, 1], np.int32)
    js, ji = J.ivf_union_scan(jnp.asarray(rows, jnp.bfloat16),
                              jnp.asarray(ids), jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(table), 2, BLOCK_N, True)
    ts, ti = V.ivf_union_scan(torch.from_numpy(rows).bfloat16(),
                              torch.from_numpy(ids),
                              torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(table), 2, BLOCK_N)
    assert np.asarray(ji).tolist() == [[10, 20]]      # the TPU kernel
    assert ti.tolist() == [[10, 5]]                   # the exact order
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ws, wi = topk_xla(jnp.asarray(rows, jnp.bfloat16), jnp.asarray(ids),
                      jnp.asarray(q, jnp.bfloat16), 2)
    assert np.asarray(wi).tolist() == ti.tolist()


def test_golden_copy_matches_the_jax_golden_with_a_repeated_block():
    for int8 in (False, True):
        t, j = _case(int8)
        table = np.array([[2, 2, 5], [0, 1, 7]], np.int32)
        t["q"], j["q"] = t["q"][:2], j["q"][:2]
        got = V.ivf_probed_scan_golden(t["corpus"], t["ids"], t["q"],
                                       torch.from_numpy(table), 30, BLOCK_N,
                                       scales=t["scales"])
        _equal(tuple(x.numpy() for x in got), _golden(j, table, 30))


def test_cpu_wrappers_take_the_twins_and_count_no_launch():
    t, _ = _case(False)
    before = (V.ivf_probed_scan.launches, V.ivf_union_scan.launches,
              V.ivf_probed_scan_int8.launches,
              V.ivf_union_scan_int8.launches)
    table = torch.from_numpy(_probes())
    got = V.ivf_probed_scan(t["corpus"], t["ids"], t["q"], table, 7, BLOCK_N)
    want = V.ivf_probed_plain(t["corpus"], t["ids"], t["q"], table, 7,
                              BLOCK_N)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    union = torch.tensor([1, 2, 2], dtype=torch.int32)
    got = V.ivf_union_scan(t["corpus"], t["ids"], t["q"], union, 7, BLOCK_N,
                           n_unique=torch.tensor([2], dtype=torch.int32))
    want = V.ivf_union_plain(t["corpus"], t["ids"], t["q"], union[:2], 7,
                             BLOCK_N)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    after = (V.ivf_probed_scan.launches, V.ivf_union_scan.launches,
             V.ivf_probed_scan_int8.launches, V.ivf_union_scan_int8.launches)
    assert after == before


@pytest.mark.parametrize("k", [5, 20])
def test_probed_dma_alias_matches_its_pallas_kernel(k):
    """``ivf_probed_scan_dma`` (the alias of ``ivf_probed_scan``) against
    the TPU's manual-DMA schedule in interpret mode, as
    ``tests/test_ivf.py:197-215`` runs it, and against the probed wrapper
    itself: the same function, ties and a repeated block included."""
    t, j = _case(False)
    table = _probes()
    table[2] = [4, 4, 6]
    got = _port("ivf_probed_scan_dma", t, table, k)
    _equal(got, _jax("ivf_probed_scan_dma", j, table, k))
    _equal(got, _port("ivf_probed_scan", t, table, k), atol=0)
    assert V.ivf_probed_scan_dma.launches == 0        # the twin counts none
