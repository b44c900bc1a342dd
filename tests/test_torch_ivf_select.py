"""The exact selection of ``csrc/select_k.cuh`` (the IVF union and probed
scans' second launch) as a plain torch model that follows the kernel's
passes, on the CPU: the order-preserving 64-bit keys, the digit
histograms summed over the CTAs' slices, the bucket of the k-th key (ties
at the k-th score broken by the id bits), the compaction, the slices
sorted on their own and each survivor placed by its index plus its count
in the other slices. The model runs over the candidates the scan writes
(every row of the table's first ``n_unique`` entries at its place in the
table; a repeated or out-of-range block's rows with id -1) and is held to
the port's twins (``ivf_union_plain``, ``ivf_probed_plain``,
``ops/topk._plain_scan``) and to JAX's ``topk_xla`` bit for bit, on rows
whose scores are exact in float32 (components n/64) and tie often. Also
the host's sizing of a launch (``ops/ivf_scan.launch_sizes``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops.topk import topk_xla
from cmw_rag_tpu_torch.ops import ivf_scan as V
from cmw_rag_tpu_torch.ops.topk import NEG_INF, PLAIN_CHUNK_ROWS, _plain_scan
from tests.test_torch_ivf_scan import BLOCK_N, N_BLOCKS, _case

BINS, PASSES, SORT_MAX = 2048, 6, 2048


def _halves(scores, ids):
    """The key's high half (the score's order-preserving image) and low
    half (0x7fffffff - id), each an int64 holding a uint32."""
    b = scores.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where(((b << 1) & 0xFFFFFFFF) == 0, torch.zeros_like(b), b)
    hi = torch.where(b >= 2 ** 31, (~b) & 0xFFFFFFFF, b | 2 ** 31)
    return hi, 0x7FFFFFFF - ids.long()


def _digit(hi, lo, p):
    shift = (21, 10, 0)[p % 3]
    return ((hi if p < 3 else lo) >> shift) & ((1 << (10 if p % 3 == 2
                                                       else 11)) - 1)


def _score_of(hi):
    b = torch.where(hi >= 2 ** 31, hi & 0x7FFFFFFF, (~hi) & 0xFFFFFFFF)
    return b.to(torch.int32).view(torch.float32)   # two's complement bits


def _select_one(s, i, k, ctas):
    """One query's selection, pass by pass as the kernel runs it."""
    m = s.numel()
    valid = (i >= 0) & (s > NEG_INF / 2)
    hi, lo = _halves(s, i.expand(m))
    cuts = [m * c // ctas for c in range(ctas + 1)]
    in_play, need, keff, digits = valid.clone(), k, None, []
    for p in range(PASSES):
        dig = _digit(hi, lo, p)
        hist = sum(torch.bincount(dig[a:b][in_play[a:b]], minlength=BINS)
                   for a, b in zip(cuts, cuts[1:]))   # each CTA's slice
        if p == 0:
            total = int(hist.sum())
            if total <= need:
                keff, digits = total, None
                break
            keff = need
        desc = hist.flip(0)
        above = torch.cumsum(desc, 0) - desc
        j = int(((above < need) & (need <= above + desc)).nonzero()[0])
        bucket = BINS - 1 - j
        need -= int(above[j])
        in_play &= dig == bucket
        digits.append(bucket)
        if need == int(desc[j]):
            break
    if digits is None:                      # every valid candidate survives
        keep = valid
    else:
        t_hi = t_lo = 0
        for p, dgt in enumerate(digits):
            shift = (21, 10, 0)[p % 3]
            if p < 3:
                t_hi |= dgt << shift
            else:
                t_lo |= dgt << shift
        keep = valid & ((hi > t_hi) | ((hi == t_hi) & (lo >= t_lo)))
    assert int(keep.sum()) == keff
    key = (hi[keep] - 2 ** 31) * 2 ** 32 + lo[keep]   # signed, same order
    key = key[torch.randperm(keff, generator=torch.Generator().manual_seed(
        keff))]                              # compaction order is arbitrary
    ch = 32
    while ch < SORT_MAX and ch * ctas < keff:
        ch *= 2
    slices = [torch.sort(key[a:a + ch], descending=True).values
              for a in range(0, keff, ch)]
    out_s = torch.full((k,), NEG_INF, dtype=torch.float32)
    out_i = torch.full((k,), -1, dtype=torch.int32)
    for j, sl in enumerate(slices):
        rank = torch.arange(sl.numel())
        for o, other in enumerate(slices):
            if o != j:    # keys above in the other slice (descending)
                rank += other.numel() - torch.searchsorted(
                    other.flip(0), sl, right=True)
        k_hi = torch.div(sl, 2 ** 32, rounding_mode="floor") + 2 ** 31
        out_s[rank] = _score_of(k_hi)
        out_i[rank] = (0x7FFFFFFF - (sl - (k_hi - 2 ** 31) * 2 ** 32)).to(
            torch.int32)
    return out_s, out_i


def select_model(scores, ids, k, ctas, m=None):
    """scores [Q, M] f32, ids [Q or 1, M] int32 (one row: shared), the
    first ``m`` candidates of each → (scores [Q, k], ids [Q, k])."""
    m = scores.shape[1] if m is None else min(m, scores.shape[1])
    outs = [_select_one(scores[q, :m], ids[min(q, ids.shape[0] - 1), :m], k,
                        ctas) for q in range(scores.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def scan_candidates(t, table, n_unique=None, block_n=BLOCK_N):
    """What the scan writes: scores [Q, width] and ids [rows, width] (one
    row for a union table, one a query for a probed one) at each row's
    place in the table; a repeated or out-of-range block's rows with id
    -1; entries past ``n_unique`` left as junk (the selection stops
    before them). → (scores, ids, candidates a query)."""
    corpus, scales, ids, q = t["corpus"], t["scales"], t["ids"], t["q"]
    rows_t, cols = table.shape
    width = cols * block_n
    used = cols if n_unique is None else n_unique
    gen = torch.Generator().manual_seed(9)
    cs = torch.randn((q.shape[0], width), generator=gen)
    ci = torch.randint(0, 10 ** 6, (rows_t, width), generator=gen,
                       dtype=torch.int32)
    for r in range(rows_t):
        qs = q if rows_t == 1 else q[r:r + 1]
        for e in range(used):
            blk = int(table[r, e])
            at = slice(e * block_n, (e + 1) * block_n)
            if not 0 <= blk < N_BLOCKS or blk in table[r, :e].tolist():
                ci[r, at] = -1
                continue
            rows = torch.arange(blk * block_n, (blk + 1) * block_n)
            s = qs.float() @ corpus[rows].float().T
            if scales is not None:
                s = s * scales[rows][None, :]
            if rows_t == 1:
                cs[:, at] = s
            else:
                cs[r, at] = s[0]
            ci[r, at] = ids[rows]
    return cs, ci, used * block_n


def _equal(got, want):
    assert torch.equal(got[1], want[1].to(torch.int32))
    assert torch.equal(got[0], want[0].float())


KS = [1, 20, 128, 129, 256, 1000]


@pytest.mark.parametrize("ctas", [2, 5, 16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", KS)
def test_model_over_union_candidates_equals_the_union_twin(k, int8, ctas):
    """A union table with a repeated block, an out-of-range one and junk
    past ``n_unique``: the model over the scan's candidates equals
    ``ivf_union_plain`` bit for bit (k 1000 is past the rows scanned)."""
    t, _ = _case(int8)
    table = torch.tensor([[1, 3, 1, 99, 6, 4, 2, 2]], dtype=torch.int32)
    cs, ci, m = scan_candidates(t, table, n_unique=6)
    got = select_model(cs, ci, k, ctas, m)
    want = V.ivf_union_plain(t["corpus"], t["ids"], t["q"], table[0], k,
                             BLOCK_N, torch.tensor([6], dtype=torch.int32),
                             scales=t["scales"])
    _equal(got, want)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [1, 20, 129, 300])
def test_model_over_probed_candidates_equals_the_probed_twin(k, int8):
    """Each query its own table row (ids a query), a block repeated in a
    row: the model equals ``ivf_probed_plain``."""
    t, _ = _case(int8)
    table = torch.tensor([[2, 5, 5, 7], [0, 1, 2, 3], [7, 6, 5, 4],
                          [3, 3, 3, 3]], dtype=torch.int32)
    cs, ci, _ = scan_candidates(t, table)
    got = select_model(cs, ci, k, 3)
    want = V.ivf_probed_plain(t["corpus"], t["ids"], t["q"], table, k,
                              BLOCK_N, scales=t["scales"])
    _equal(got, want)


@pytest.mark.parametrize("k", KS + [5000])
def test_model_equals_the_plain_scan_and_jax_with_ties(k):
    """Scores of few distinct values (thousands of exact ties at every
    k-th score, falling in every CTA's slice), tombstones, negative and
    zero scores of both signs: the model equals ``ops/topk._plain_scan``
    and JAX's ``topk_xla`` over the same candidates."""
    rng = np.random.default_rng(3)
    q, m = 3, 4000
    s = (rng.integers(-6, 7, (q, m)) / 8).astype(np.float32)
    s[s == 0] = np.where(rng.random((s == 0).sum()) < 0.5, -0.0, 0.0)
    ids = rng.permutation(m).astype(np.int32)
    ids[rng.choice(m, 300, replace=False)] = -1
    st, it = torch.from_numpy(s), torch.from_numpy(ids)
    got = select_model(st, it[None, :], k, 16)
    want = _plain_scan(lambda a, b: st[:, a:b], m, it, q, k, "cpu",
                       PLAIN_CHUNK_ROWS)
    _equal(got, want)
    # JAX's topk over one-hot rows: query j's score of row r is s[j, r]
    js, ji = topk_xla(jnp.eye(m, dtype=jnp.float32), jnp.asarray(ids),
                      jnp.asarray(s), min(k, m))
    js, ji = np.asarray(js), np.asarray(ji)
    live = got[1].numpy()[:, :min(k, m)] >= 0
    np.testing.assert_array_equal(got[1].numpy()[:, :min(k, m)][live],
                                  ji[live])
    np.testing.assert_array_equal(got[0].numpy()[:, :min(k, m)][live],
                                  js[live])


def test_model_with_no_entries_and_all_tombstones():
    """``n_unique`` 0, and entries whose every row is a tombstone: every
    slot (-3e38, -1)."""
    t, _ = _case(False)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    cs, ci, m = scan_candidates(t, table, n_unique=0)
    got = select_model(cs, ci, 20, 4, m)
    want = V.ivf_union_plain(t["corpus"], t["ids"], t["q"], table[0], 20,
                             BLOCK_N, torch.tensor([0], dtype=torch.int32))
    _equal(got, want)
    assert (got[1] == -1).all() and (got[0] == NEG_INF).all()
    cs, ci, m = scan_candidates(t, table)
    got = select_model(cs, torch.full_like(ci, -1), 20, 4, m)
    assert (got[1] == -1).all() and (got[0] == NEG_INF).all()


def test_keys_order_as_the_exact_order():
    """Key order is (score desc, id asc) order, -0 is +0, and a key gives
    its score and id back bit for bit."""
    s = torch.tensor([1.5, -0.0, 0.0, -2.0, 3e38, -1e-30, 1e-30, 0.0])
    i = torch.tensor([7, 3, 2, 1, 0, 5, 6, 9], dtype=torch.int32)
    hi, lo = _halves(s, i)
    key = (hi - 2 ** 31) * 2 ** 32 + lo
    order = torch.argsort(key, descending=True)
    want = sorted(range(8), key=lambda j: (-float(s[j]), int(i[j])))
    assert order.tolist() == want
    assert torch.equal(_score_of(hi), torch.where(s == 0, 0.0, s))
    assert torch.equal((0x7FFFFFFF - lo).to(torch.int32), i)


@pytest.mark.parametrize("nq,cols,per_query,k,sms,want", [
    # Q 8 union of phase 6: one group, a CTA a SM, 32 selection CTAs
    (8, 512, False, 20, 132, dict(qg=8, groups=1, n_ctas=132, sel_ctas=32,
                                  surv_stride=20)),
    (8, 512, False, 1000, 132, dict(groups=1, n_ctas=132, sel_ctas=32,
                                    surv_stride=1000)),
    # Q 32: four n8 tiles in one group; two selection CTAs a SM in all
    (32, 2048, False, 20, 132, dict(qg=32, groups=1, n_ctas=132,
                                    sel_ctas=8)),
    # 40 queries: one chunk, groups of 32 (the second of 8), half the SMs
    # each
    (40, 64, False, 5, 132, dict(qg=32, chunk=40, groups=2, n_ctas=66)),
    # 100 queries: chunks of 64 in turn (the second of 36), two groups each
    (100, 64, False, 20, 132, dict(qg=32, chunk=64, groups=2, n_ctas=66,
                                   sel_ctas=4)),
    # 12 queries: groups of 16
    (12, 64, False, 5, 132, dict(qg=16, groups=1, n_ctas=132)),
    # probed Q 1, nprobe 64: 256 items, 16 selection CTAs
    (1, 64, True, 20, 132, dict(qg=8, groups=1, n_ctas=132, sel_ctas=16)),
    # probed Q 8: a group a query
    (8, 64, True, 20, 132, dict(qg=8, groups=8, n_ctas=17, sel_ctas=16)),
    # probed Q 100: chunks of 64 queries, a group a query
    (100, 64, True, 20, 132, dict(qg=8, chunk=64, groups=64, n_ctas=3,
                                  sel_ctas=4)),
    # a small table: no more CTAs than items, at least 2 selection CTAs
    (1, 2, True, 5000, 132, dict(groups=1, n_ctas=8, sel_ctas=2,
                                 surv_stride=2048)),
])
def test_launch_sizes_from_the_table_width(nq, cols, per_query, k, sms, want):
    z = V.launch_sizes(nq, cols, 1024, k, per_query, sms)
    for key, v in want.items():
        assert z[key] == v, (key, z[key], v)
    width = cols * 1024
    chunk = min(nq, V.QUERY_CHUNK)
    assert z["ws_cols"] == cols and z["width"] == width
    assert z["chunk"] == chunk
    assert z["floats"] == chunk * width
    ids_words = (chunk if per_query else 1) * width
    assert z["clear_at"] == ids_words
    assert z["hist_words"] == chunk * PASSES * BINS
    assert z["surv_at"] % 2 == 0
    assert z["surv_at"] >= ids_words + chunk * (PASSES * BINS + 2)
    assert z["words"] == z["surv_at"] + 2 * chunk * min(k, width)
    # workspace bytes: 4 a word, the survivors 8 bytes each
    assert 4 * (z["floats"] + z["words"]) >= 4 * chunk * width + 8 * chunk * min(
        k, width)


def _workspace_bytes(z):
    return 4 * (z["floats"] + z["words"])


@pytest.mark.parametrize("nq", [8, 32, 64, 256, 1024])
@pytest.mark.parametrize("k", [20, 1000])
def test_launch_sizes_workspace_is_bounded_in_the_batch(nq, k):
    """The union route of phase 6's index (1,024 blocks of 1,024 rows,
    nprobe 64): the table is padded to Q x nprobe entries, but the
    workspace holds one chunk of 64 queries over at most n_blocks entries
    (``n_unique`` counts distinct blocks), so it stays under 270 MiB from
    Q 8 to Q 1024, where the whole batch's scores over the padded width
    would take 16 GiB at Q 256 and 256 GiB at Q 1024."""
    n_blocks, nprobe, sms = 1024, 64, 132
    z = V.launch_sizes(nq, nq * nprobe, 1024, k, False, sms, n_blocks)
    assert z["ws_cols"] == min(nq * nprobe, n_blocks)
    assert z["chunk"] == min(nq, 64)
    assert _workspace_bytes(z) <= 270 * 2 ** 20
    if nq >= 64:   # the largest the workspace gets, whatever the batch
        assert _workspace_bytes(z) == _workspace_bytes(V.launch_sizes(
            64, 64 * nprobe, 1024, k, False, sms, n_blocks))
    whole = 4 * nq * nq * nprobe * 1024
    assert nq < 256 or _workspace_bytes(z) * 32 < whole


def test_compare_trees_reads_the_ivf_and_segmented_phases():
    """``scripts/compare_trees.py`` times phases 6 and 7 of both trees and
    reads their kernel records (the scan's and the selection's times where
    a tree gives them, a parent's records without them), recall and the
    segmented store's overlap."""
    from cmw_rag_tpu_torch.scripts import compare_trees as CT

    assert {"ivf", "segmented"} <= set(CT.PHASES)
    rec = {"ms": 0.3, "plain_ms": 5.0, "library_ms": 1.1, "bound_ms": 0.25,
           "scan_ms": 0.27, "select_ms": 0.02, "shape": {}}
    old = {k: v for k, v in rec.items() if not k.endswith("_ms")
           or k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out = CT.summary({
        "ivf": {"kernels": {"ivf_union_scan/q8": rec,
                            "ivf_union_scan_int8/q8": old},
                "recall_at_10": {"bf16": {"64": {"union": 0.9}}}},
        "segmented": {"top20_overlap_with_flat": 0.95,
                      "planted_ranks": [0] * 8, "launches": {"x": 1},
                      "live_rows": 250000}})
    assert out["ivf_kernels"]["ivf_union_scan/q8"]["select_ms"] == 0.02
    assert "scan_ms" not in out["ivf_kernels"]["ivf_union_scan_int8/q8"]
    assert out["ivf_recall_at_10"]["bf16"]["64"]["union"] == 0.9
    assert out["segmented"]["top20_overlap_with_flat"] == 0.95


def test_compare_trees_times_union_batches_past_one_chunk():
    """``compare_trees.py --batch`` times the union scans of both trees at
    batches of several query chunks; its child program compiles and every
    case it names passes one chunk."""
    from cmw_rag_tpu_torch.scripts import compare_trees as CT

    assert min(q for q, _ in CT.BATCH_CASES) > V.QUERY_CHUNK
    assert {k for _, k in CT.BATCH_CASES} >= {20, 1000}
    compile(f"CASES = {CT.BATCH_CASES!r}\n" + CT._BATCH_CHILD, "batch",
            "exec")
