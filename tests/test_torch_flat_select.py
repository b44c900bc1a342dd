"""The exact flat scan on the card (``ops/ivf_scan.flat_scan``, behind
``ops/topk.topk_scan_bf16`` and ``topk_scan_int8``) as a plain model on
the CPU. The scan treats the corpus as one block of all its N rows: it
writes every row's score at the row's place in the workspace (a ragged
last 256-row tile stops at N; what lies past N is never read) and no ids,
so the selection of ``csrc/select_k.cuh`` (``select_model`` of
``test_torch_ivf_select``) reads the corpus's ids as one shared row. The
model over those candidates is held bit for bit to the port's twins
(``topk_plain``, ``topk_plain_int8``), to JAX's ``topk_xla`` /
``topk_xla_int8`` and to its Pallas kernels in interpret mode, on rows
whose scores are exact in float32 (components n/64) and tie often. Also
the host's sizing of a flat launch (``ops/ivf_scan.flat_sizes``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import topk as J
from cmw_rag_tpu_torch.ops import ivf_scan as V
from cmw_rag_tpu_torch.ops import topk as T
from tests.test_torch_flat_index import _vecs
from tests.test_torch_ivf_select import BINS, PASSES, select_model

N = 700            # two 256-row tiles and a ragged one of 188
D = 32
TILE = V.TILE_ROWS


def _case(int8, seed=0, qn=5, tie_in_row_order=False):
    """(port arrays, JAX arrays) of a flat corpus: ids a permutation with
    tombstones, row 70 copied to rows 300 and 650 (the last in the ragged
    tile; 300 a tombstone), query 0 equal to row 70; with
    ``tie_in_row_order`` the copies' ids ascend with their rows."""
    rows, q = _vecs(N, seed=seed, d=D), _vecs(qn, seed=seed + 1, d=D)
    rows[[300, 650]] = rows[70]
    q[0] = rows[70]
    ids = np.random.default_rng(seed + 2).permutation(N).astype(np.int32)
    if tie_in_row_order and ids[70] > ids[650]:
        ids[[70, 650]] = ids[[650, 70]]
    ids[[5, 66, 300, 512, 699]] = -1
    t = dict(corpus=torch.from_numpy(rows).bfloat16(), scales=None,
             ids=torch.from_numpy(ids), q=torch.from_numpy(q).bfloat16())
    j = dict(corpus=jnp.asarray(rows, jnp.bfloat16), scales=None,
             ids=jnp.asarray(ids), q=jnp.asarray(q, jnp.bfloat16))
    if int8:
        t["corpus"], t["scales"] = T.quantize_rows_int8(torch.from_numpy(rows))
        j["corpus"], j["scales"] = J.quantize_rows_int8(jnp.asarray(rows))
    return t, j


def flat_candidates(t):
    """What the flat scan writes: scores [Q, tiles x 256], each row's at
    its row (junk past N, which the selection never reads), and no ids:
    the selection's id row is the corpus's ids [1, N]. → (scores, ids, N)."""
    corpus, scales, q = t["corpus"], t["scales"], t["q"]
    width = -(-N // TILE) * TILE
    cs = torch.randn((q.shape[0], width), generator=torch.Generator()
                     .manual_seed(9))
    for r0 in range(0, N, TILE):               # tile by tile, as the CTAs
        rows = torch.arange(r0, min(r0 + TILE, N))
        s = q.float() @ corpus[rows].float().T
        cs[:, rows] = s if scales is None else s * scales[rows][None, :]
    return cs, t["ids"][None, :], N


def _twin(t, k):
    if t["scales"] is None:
        return T.topk_plain(t["corpus"], t["ids"], t["q"], k)
    return T.topk_plain_int8(t["corpus"], t["scales"], t["ids"], t["q"], k)


def _equal(got, want):
    assert torch.equal(got[1], want[1].to(torch.int32))
    assert torch.equal(got[0], want[0].float())


KS = [1, 20, 128, 129, 1000, 5000]   # 1000 and 5000 past N


@pytest.mark.parametrize("ctas", [2, 5, 16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", KS)
def test_model_over_flat_candidates_equals_the_twins(k, int8, ctas):
    """The selection over the flat scan's candidates (a shared id row with
    tombstones, a ragged last tile, junk past N) equals ``topk_plain`` /
    ``topk_plain_int8`` bit for bit; the tie group of row 70 (rows 70 and
    650 live) surfaces in id order; the tail past the live rows is empty."""
    t, _ = _case(int8)
    cs, ci, m = flat_candidates(t)
    got = select_model(cs, ci, k, ctas, m)
    _equal(got, _twin(t, k))
    ids = t["ids"]
    tie = sorted(int(ids[r]) for r in (70, 650))
    assert got[1][0, :min(k, 2)].tolist() == tie[:k]
    live = int((ids >= 0).sum())
    assert (got[1][:, live:] == -1).all()
    assert (got[0][:, live:] == T.NEG_INF).all()


def _jax(j, k, pallas):
    if pallas:
        if j["scales"] is None:
            return J.topk_pallas(j["corpus"], j["ids"], j["q"], k,
                                 tile_n=100, interpret=True)
        return J.topk_pallas_int8(j["corpus"], j["scales"], j["ids"], j["q"],
                                  k, tile_n=100, interpret=True)
    if j["scales"] is None:
        return J.topk_xla(j["corpus"], j["ids"], j["q"], k)
    return J.topk_xla_int8(j["corpus"], j["scales"], j["ids"], j["q"], k)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", KS)
def test_model_over_flat_candidates_equals_jax(k, int8):
    """The same against JAX's ``topk_xla`` / ``topk_xla_int8`` (their first
    min(k, N) columns) and, k up to 129, its Pallas kernels in interpret
    mode (tiles of 100 rows). The Pallas kernels merge a tile only when
    one of its scores strictly beats a query's k-th, so a row that exactly
    ties the k-th score with a smaller id in a later tile stays out there
    (``test_pallas_tie_deviation``): they are held on the case whose tie
    group's ids ascend with their rows."""
    t, j = _case(int8, seed=3)
    got = select_model(*flat_candidates(t)[:2], k, 4, N)
    kk = min(k, N)
    xs, xi = _jax(j, kk, pallas=False)
    np.testing.assert_array_equal(got[1].numpy()[:, :kk], np.asarray(xi))
    np.testing.assert_array_equal(got[0].numpy()[:, :kk], np.asarray(xs))
    if k > 129:
        return
    t, j = _case(int8, seed=3, tie_in_row_order=True)
    got = select_model(*flat_candidates(t)[:2], k, 4, N)
    ps, pi = _jax(j, k, pallas=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(pi))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ps))


def test_pallas_tie_deviation():
    """Query 0's top two rows tie exactly (rows 70 and 650), the smaller id
    in the later tile. At k 1 the Pallas kernel keeps row 70, the first
    tile's; the model, the twin and ``topk_xla`` keep the smaller id."""
    t, j = _case(False, seed=3)
    ids = t["ids"]
    assert int(ids[650]) < int(ids[70])
    got = select_model(*flat_candidates(t)[:2], 1, 4, N)
    assert int(got[1][0, 0]) == int(ids[650])
    assert int(_twin(t, 1)[1][0, 0]) == int(ids[650])
    assert int(np.asarray(_jax(j, 1, pallas=False)[1])[0, 0]) == int(ids[650])
    assert int(np.asarray(_jax(j, 1, pallas=True)[1])[0, 0]) == int(ids[70])


def test_model_with_every_row_tied():
    """Every row one vector: all scores tie exactly, the ids decide, and
    the k smallest live ids come out in ascending order."""
    t, _ = _case(False, seed=5)
    t["corpus"][:] = t["corpus"][0]
    cs, ci, m = flat_candidates(t)
    for k in (7, 129, 600):
        got = select_model(cs, ci, k, 5, m)
        live = torch.sort(t["ids"][t["ids"] >= 0]).values[:k]
        assert torch.equal(got[1], live[None, :].expand(cs.shape[0], -1)
                           .to(torch.int32))
        _equal(got, _twin(t, k))


@pytest.mark.parametrize("nq,n,k,want", [
    # the fused path: Q 8, 1M rows; one group, a CTA a SM, 32 selection CTAs
    (8, 1_000_000, 20, dict(qg=8, chunk=8, groups=1, n_ctas=132,
                            sel_ctas=32, surv_stride=20)),
    (8, 1_000_000, 1000, dict(groups=1, n_ctas=132, sel_ctas=32,
                              surv_stride=1000)),
    # Q 32 (8 queries x 4 segments): four n8 tiles in one group
    (32, 1_000_000, 20, dict(qg=32, chunk=32, groups=1, n_ctas=132,
                             sel_ctas=8)),
    # past 32 queries: groups of 64 in chunks of 128, a chunk's two groups
    # on the same tiles, each on half the SMs
    (33, 1_000_000, 20, dict(qg=64, chunk=33, groups=1, n_ctas=132,
                             sel_ctas=8)),
    (128, 1_000_000, 20, dict(qg=64, chunk=128, groups=2, n_ctas=66,
                              sel_ctas=2)),
    (300, 1_000_000, 20, dict(qg=64, chunk=128, groups=2, n_ctas=66)),
    # 12 queries: groups of 16
    (12, 1_000_000, 20, dict(qg=16, groups=1, n_ctas=132)),
    # a small corpus: no more CTAs than tiles, at least 2 selection CTAs,
    # survivors no more than the rows
    (5, 700, 5000, dict(groups=1, n_ctas=3, sel_ctas=2, surv_stride=700)),
])
def test_flat_sizes(nq, n, k, want):
    sms = 132
    z = V.flat_sizes(nq, n, k, sms)
    for key, v in want.items():
        assert z[key] == v, (key, z[key], v)
    chunk = min(nq, V.WIDE_CHUNK if nq > 32 else V.QUERY_CHUNK)
    assert z["chunk"] == chunk and z["ws_cols"] == 1 and z["width"] == n
    assert z["floats"] == chunk * n
    assert z["clear_at"] == 0                     # no ids in the workspace
    assert z["hist_words"] == chunk * PASSES * BINS
    assert z["surv_at"] % 2 == 0
    assert z["surv_at"] >= chunk * (PASSES * BINS + 2)
    assert z["words"] == z["surv_at"] + 2 * chunk * min(k, n)
    # the same as a union launch over a one-entry table, less its ids
    union = V.launch_sizes(nq, 1, n, k, False, sms, wide=True)
    assert {key: union[key] for key in ("qg", "groups", "n_ctas", "sel_ctas",
                                        "floats", "hist_words")} \
        == {key: z[key] for key in ("qg", "groups", "n_ctas", "sel_ctas",
                                    "floats", "hist_words")}
    assert union["words"] - z["words"] >= n - 1
    if nq <= 32:   # no cluster: the union route's own sizing
        assert V.launch_sizes(nq, 1, n, k, False, sms) == union


@pytest.mark.parametrize("k", [20, 1000])
def test_flat_workspace_does_not_grow_with_the_batch(k):
    """Over 1M rows the workspace is one chunk's scores and the
    selection's words, whatever the batch past one chunk of 128 queries
    (488 MiB of scores); at Q 8 it is 32 MB of scores."""
    def mib(nq):
        z = V.flat_sizes(nq, 1_000_000, k, 132)
        return 4 * (z["floats"] + z["words"]) / 2 ** 20

    chunk = V.WIDE_CHUNK
    assert 30.5 < mib(8) < 31
    assert 3.8 * chunk < mib(chunk) < 3.9 * chunk
    for nq in (chunk + 1, 200, 256, 1024, 4096):
        assert mib(nq) == mib(chunk)


@pytest.mark.parametrize("n,budget_mib", [
    (1_000_000, 100),            # 1M rows, a small card: chunks of 16
    (20_000_000, 4 * 1024),      # 20M rows: chunks of 8, 13 passes at Q 100
    (50_000_000, 4 * 1024),      # 50M: 4
    (400_000_000, 1024),         # more than a budget holds at one query
])
@pytest.mark.parametrize("nq", [8, 33, 100, 4096])
def test_flat_sizes_fits_a_memory_budget(n, budget_mib, nq):
    """With a budget the chunk is the largest power of two (below the
    unbudgeted chunk) whose workspace fits it, down to one query; the
    group is no wider than the chunk needs, and the workspace does not
    grow with the batch."""
    budget = budget_mib * 2 ** 20
    free = V.flat_sizes(nq, n, 20, 132)
    z = V.flat_sizes(nq, n, 20, 132, budget)
    nbytes = 4 * (z["floats"] + z["words"])
    if 4 * (free["floats"] + free["words"]) <= budget:
        assert z == free
    else:
        assert z["chunk"] & (z["chunk"] - 1) == 0 and z["chunk"] < free["chunk"]
        assert nbytes <= budget or z["chunk"] == 1
        wider = V.launch_sizes(nq, 1, n, 20, False, 132, write_ids=False,
                               wide=True, max_chunk=2 * z["chunk"])
        assert 4 * (wider["floats"] + wider["words"]) > budget
    assert z["floats"] == z["chunk"] * n and z["clear_at"] == 0
    assert z["qg"] in (8, 16, 32, V.WIDE_GROUP)
    assert z["qg"] == 8 or z["qg"] < 2 * z["chunk"]
    assert z["groups"] == -(-z["chunk"] // z["qg"])
    if z["chunk"] < nq:   # past one chunk the workspace stays as it is
        wider = V.flat_sizes(4 * nq, n, 20, 132, budget)
        assert {key: wider[key] for key in ("chunk", "floats", "words")} \
            == {key: z[key] for key in ("chunk", "floats", "words")}
    if n == 400_000_000:
        assert z["chunk"] == 1 and nbytes > budget


class _FakeCard:
    """The card as ``flat_launch_sizes`` reads it: 132 SMs, ``free`` bytes
    free, ``unused`` bytes cached by PyTorch and not allocated."""

    def __init__(self, monkeypatch, free, unused=0):
        self.asked = 0

        def mem_get_info(dev):
            self.asked += 1
            return free, 80 * 2 ** 30

        class Props:
            multi_processor_count = 132

        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: Props)
        monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
        monkeypatch.setattr(torch.cuda, "memory_reserved",
                            lambda dev: unused + 2 ** 30)
        monkeypatch.setattr(torch.cuda, "memory_allocated",
                            lambda dev: 2 ** 30)


def test_flat_launch_sizes_takes_a_share_of_the_free_memory(monkeypatch):
    """A flat call keeps its chunk where the stream's workspace already
    holds it and asks the card nothing; else its budget is
    ``FLAT_WORKSPACE_SHARE`` of what is free on the card or cached unused
    by PyTorch, beside the workspace already held."""
    monkeypatch.setattr(V, "_WORKSPACES", {})
    dev = torch.device("cpu")    # index None, as the key reads it
    n, nq = 20_000_000, 128
    card = _FakeCard(monkeypatch, free=6 * 2 ** 30, unused=2 * 2 ** 30)
    z = V.flat_launch_sizes(dev, 7, nq, n, 20)
    budget = int(V.FLAT_WORKSPACE_SHARE * 8 * 2 ** 30)
    assert card.asked == 1 and z == V.flat_sizes(nq, n, 20, 132, budget)
    assert z["chunk"] == 16 and 4 * (z["floats"] + z["words"]) <= budget
    # the workspace made for it is held: counted in, and the next call of
    # the same size asks nothing
    V._WORKSPACES[(None, 7)] = (torch.zeros(z["floats"]),
                                torch.zeros(z["words"], dtype=torch.int32))
    assert V.workspace_bytes(dev, 7) == 4 * (z["floats"] + z["words"])
    card = _FakeCard(monkeypatch, free=0)
    assert V.flat_launch_sizes(dev, 7, 16, n, 20) == V.flat_sizes(
        16, n, 20, 132)
    assert card.asked == 0
    # a wider call with nothing free keeps to the held workspace
    assert V.flat_launch_sizes(dev, 7, nq, n, 20)["chunk"] == 16
    assert card.asked == 1
    # it may grow by a quarter of what is free: chunks of 32 need 1.2 GiB
    # more than the held 1.2 GiB, more than a quarter of 4 GiB
    card = _FakeCard(monkeypatch, free=4 * 2 ** 30)
    assert V.flat_launch_sizes(dev, 7, nq, n, 20)["chunk"] == 16
    card = _FakeCard(monkeypatch, free=6 * 2 ** 30)
    assert V.flat_launch_sizes(dev, 7, nq, n, 20)["chunk"] == 32
    # another stream holds nothing; with the card near empty, the full
    # chunk (9.5 GiB of scores)
    card = _FakeCard(monkeypatch, free=60 * 2 ** 30)
    assert V.flat_launch_sizes(dev, 8, nq, n, 20)["chunk"] == V.WIDE_CHUNK


def test_scans_of_one_stream_run_in_turn(monkeypatch):
    """``_stream`` holds one lock a (device, stream): two host threads on
    one stream never launch inside each other's call; on two streams they
    may."""
    import threading
    import time

    streams = {}

    class Stream:
        def __init__(self, n):
            self.cuda_stream = n

    monkeypatch.setattr(V, "_LOCKS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: streams[threading.get_ident()])
    dev = torch.device("cpu")
    inside, most = [0], [0]

    def call(stream):
        streams[threading.get_ident()] = Stream(stream)
        for _ in range(20):
            with V._stream(dev) as st:
                assert st == stream
                inside[0] += 1
                most[0] = max(most[0], inside[0])
                time.sleep(0.0005)
                inside[0] -= 1

    def run(pair):
        ts = [threading.Thread(target=call, args=(s,)) for s in pair]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    run((3, 3))
    assert most[0] == 1
    assert set(V._LOCKS) == {(None, 3)}
    run((4, 5))
    assert set(V._LOCKS) == {(None, 3), (None, 4), (None, 5)}


def test_flat_scan_refuses_bad_inputs_before_any_launch():
    """The checks run before the library is built or loaded: an int8
    corpus needs D a multiple of 16 (its TMA boxes), a bf16 one 8; k at
    least 1; dtypes, shapes and the row count as stated."""
    t, _ = _case(True)
    c8, sc, ids = t["corpus"], t["scales"], t["ids"]
    q = t["q"]
    with pytest.raises(ValueError, match="multiple of 16"):
        V.flat_scan(torch.zeros((N, 40), dtype=torch.int8), sc, ids,
                    torch.zeros((5, 40), dtype=torch.bfloat16), 5)
    with pytest.raises(ValueError, match="multiple of 8"):
        V.flat_scan(torch.zeros((N, 36), dtype=torch.bfloat16), None, ids,
                    torch.zeros((5, 36), dtype=torch.bfloat16), 5)
    with pytest.raises(ValueError, match="at least 1"):
        V.flat_scan(c8, sc, ids, q, 0)
    with pytest.raises(TypeError):
        V.flat_scan(c8.float(), None, ids, q, 5)
    with pytest.raises(ValueError, match="shape"):
        V.flat_scan(c8, sc, ids[:100], q, 5)
    with pytest.raises(TypeError):
        V.flat_scan(c8, sc, ids, q.float(), 5)


def test_compare_trees_times_the_scan_and_pipeline_phases():
    """``scripts/compare_trees.py`` times phases 2 and 3 of both trees and
    reads the scan records (the scan's and the selection's times and the
    workspace where a tree gives them, a parent's records without them)
    and the pipeline's queries/s."""
    from cmw_rag_tpu_torch.scripts import compare_trees as CT

    assert {"scan", "pipeline"} <= set(CT.PHASES)
    rec = {"ms": 3.4, "plain_ms": 31.0, "library_ms": 4.7, "bound_ms": 3.06,
           "scan_ms": 3.3, "select_ms": 0.06, "workspace_mib": 30.9,
           "max_abs_err": 0.0, "shape": {}}
    old = {k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "shape")}
    out = CT.summary({
        "scan": {"topk_scan_bf16/main": rec, "topk_scan_int8/main": old},
        "pipeline": {"qps": {"bf16": 40.1, "int8": 52.3},
                     "launches": {"topk_scan_bf16": 41}}})
    assert out["scan_kernels"]["topk_scan_bf16/main"]["select_ms"] == 0.06
    assert out["scan_kernels"]["topk_scan_bf16/main"]["workspace_mib"] == 30.9
    assert "scan_ms" not in out["scan_kernels"]["topk_scan_int8/main"]
    assert "shape" not in out["scan_kernels"]["topk_scan_int8/main"]
    assert out["pipeline_qps"] == {"bf16": 40.1, "int8": 52.3}


def test_compare_trees_hashes_the_ivf_kernels_outputs():
    """``compare_trees.py --bits`` hashes the IVF kernels' outputs in both
    trees, probed and union, at one query and past a chunk; its child
    program compiles."""
    from cmw_rag_tpu_torch.scripts import compare_trees as CT

    assert {r for r, _, _ in CT.BITS_CASES} == {"probed", "union"}
    assert max(q for _, q, _ in CT.BITS_CASES) > V.QUERY_CHUNK
    assert min(q for _, q, _ in CT.BITS_CASES) == 1
    compile(f"CASES = {CT.BITS_CASES!r}\n" + CT._BITS_CHILD, "bits", "exec")


def test_compare_trees_times_flat_batches_past_phase_2():
    """``compare_trees.py --flat-batch`` times both trees' flat scans at
    batches phase 2 lacks, one past a chunk; its child program compiles,
    and it runs through the one runner of the extras."""
    import importlib.util
    from pathlib import Path

    from cmw_rag_tpu_torch.scripts import compare_trees as CT

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)     # importing runs nothing
    phase2 = {q for _, q, _, _ in smoke.SCAN_CASES}
    assert max(q for q, _ in CT.FLAT_CASES) > V.WIDE_CHUNK
    assert not {q for q, _ in CT.FLAT_CASES} & phase2
    assert CT.EXTRAS["flat_batch"] == (CT.FLAT_CASES, CT._FLAT_CHILD)
    assert set(CT.EXTRAS) == {"ivf_batch", "ivf_bits", "flat_batch",
                              "int8_mm"}
    for name, (cases, child) in CT.EXTRAS.items():
        assert "EXTRA_RESULT " in child
        compile(f"CASES = {cases!r}\n" + child, name, "exec")
