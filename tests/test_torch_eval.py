"""The port's judged eval (``cmw_rag_tpu_torch/eval/``, the eval script)
against the JAX package's on the same inputs.

- The metrics on seeded random rankings.
- The generated dataset, whole, equal to JAX's as JSON (fingerprint
  ``2b4c73b23aac7cf6``, 312 queries, 8,320 articles), and the other
  generators of ``corpus_gen`` (queries, training pairs, the corpus
  folder); ``load_dataset``/``save_dataset`` read by both packages.
- ``evaluate_retrieval`` on a slice of the dataset (96 articles, 24
  queries, 6 of them multi-family) with the bundled shipped embedder and
  the 4-member ensemble, float32 on both sides, chunks of 128 / 16 and
  sibling expansion 6 / 3: every per-query value, every aggregate and the
  ``chunk_level`` block within 1e-6 of JAX's.
- The script's ``main`` on the slice's dataset file (``--shipped
  --ablations --compare-rerankers``, ``--device cpu --fp32``): its rows
  against JAX's ``evaluate_retrieval`` on the same components; its
  refusals of a missing checkpoint.
- ``chip_smoke.py`` phase 12's pieces on the CPU: the committed JAX rows
  (``tests/eval_reference_jax.json``) are of this dataset, the gates pass
  on them and catch a shifted row, the scan check holds the k-th row only
  where the twin's next row is clear of it.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.config.registry import ModelRegistry
from cmw_rag_tpu.eval import corpus_gen as JG
from cmw_rag_tpu.eval import dataset as JD
from cmw_rag_tpu.eval import judged_queries as JQ
from cmw_rag_tpu.eval import metrics as JM
from cmw_rag_tpu.eval.runner import evaluate_retrieval as j_evaluate
from cmw_rag_tpu.retrieval import reranker as JR
from cmw_rag_tpu.retrieval.embedder import TPUEmbedder
from cmw_rag_tpu.retrieval.embedder import _bundled_checkpoint as j_emb_ckpt
from cmw_rag_tpu.retrieval.siblings import SiblingIndex as JSiblingIndex
from cmw_rag_tpu.scripts.eval_retrieval import _CachedEmbedder as JCached
from cmw_rag_tpu_torch.config import Settings
from cmw_rag_tpu_torch.eval import corpus_gen as TG
from cmw_rag_tpu_torch.eval import dataset as TD
from cmw_rag_tpu_torch.eval import judged_queries as TQ
from cmw_rag_tpu_torch.eval import metrics as TM
from cmw_rag_tpu_torch.eval.runner import evaluate_retrieval
from cmw_rag_tpu_torch.retrieval import reranker as TR
from cmw_rag_tpu_torch.retrieval.embedder import create_embedder
from cmw_rag_tpu_torch.retrieval.siblings import SiblingIndex
from cmw_rag_tpu_torch.scripts import eval_retrieval as script

FINGERPRINT = "2b4c73b23aac7cf6"
TOL = 1e-6
METRICS = ("recall", "ndcg", "mrr", "mrr_grade3", "judged_avg")
EVAL_KW = dict(k=10, pre_rerank_k=20, chunk_tokens=128, chunk_overlap=16,
               current_version="v6")
SHIPPED = Settings()


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("seed", range(8))
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    docs = [f"d{i}" for i in range(40)]
    for _ in range(50):
        retrieved = list(rng.choice(docs, int(rng.integers(0, 25))))
        judged = rng.choice(docs, int(rng.integers(0, 12)), replace=False)
        judgments = {d: float(rng.integers(0, 4)) for d in judged}
        relevant = [d for d, g in judgments.items() if g >= 2]
        k = int(rng.integers(1, 15))
        assert TM.recall_at_k(retrieved, relevant, k) == \
            JM.recall_at_k(retrieved, relevant, k)
        assert TM.ndcg_at_k(retrieved, judgments, k) == \
            JM.ndcg_at_k(retrieved, judgments, k)
        assert TM.judged_avg_score(retrieved, judgments, k) == \
            JM.judged_avg_score(retrieved, judgments, k)
        assert TM.mrr(retrieved, relevant) == JM.mrr(retrieved, relevant)


# ------------------------------------------------------------------ dataset

@pytest.fixture(scope="module")
def articles():
    return TG.generate_corpus()


@pytest.fixture(scope="module")
def dataset(articles):
    return TQ.build_judged_dataset(articles)


def test_generated_dataset_equal_jax(dataset):
    want = JQ.build_judged_dataset(JG.generate_corpus())
    assert json.dumps(dataset, ensure_ascii=False) == \
        json.dumps(want, ensure_ascii=False)
    assert TD.dataset_fingerprint(dataset) == \
        JD.dataset_fingerprint(want) == FINGERPRINT
    assert (len(dataset["queries"]), len(dataset["corpus"])) == (312, 8320)
    assert TG.CURRENT_VERSION == JG.CURRENT_VERSION == "v6"


@pytest.mark.parametrize("include_generated,include_multi",
                         [(False, False), (True, False), (False, True)])
def test_judged_dataset_options_equal_jax(articles, include_generated,
                                          include_multi):
    got = TQ.build_judged_dataset(articles, include_generated, include_multi)
    want = JQ.build_judged_dataset(JG.generate_corpus(), include_generated,
                                   include_multi)
    assert got == want


def _generated(mod, name):
    arts = mod.generate_corpus()
    if name == "eval_queries":
        return mod.generate_eval_queries()
    if name == "labeled_queries":
        return (mod.generate_labeled_queries(),
                mod.generate_labeled_queries(seed=3, wrap=True))
    if name == "training_pairs":
        return (mod.generate_training_pairs(arts[:600]),
                mod.generate_training_pairs(arts[:600], seed=2, block_size=32,
                                            cross_lingual_boost=2,
                                            cross_lingual_wrap=True))
    if name == "corpus_seed":
        return [vars(a) for a in mod.generate_corpus(seed=3)[::50]]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["eval_queries", "labeled_queries",
                                  "training_pairs", "corpus_seed"])
def test_corpus_generators_equal_jax(name):
    assert _generated(TG, name) == _generated(JG, name)


def test_write_corpus_equal_jax(tmp_path, articles):
    TG.write_corpus(articles[:40], tmp_path / "port")
    JG.write_corpus(JG.generate_corpus()[:40], tmp_path / "jax")
    got = {p.name: p.read_text("utf-8") for p in (tmp_path / "port").iterdir()}
    want = {p.name: p.read_text("utf-8") for p in (tmp_path / "jax").iterdir()}
    assert got == want and len(got) == 40


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_dataset_equal_jax(seed):
    got = TD.synthesize_dataset(per_topic_docs=3, seed=seed)
    assert got == JD.synthesize_dataset(per_topic_docs=3, seed=seed)
    assert TD.dataset_fingerprint(got) == JD.dataset_fingerprint(got)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataset_round_trip_read_by_both(tmp_path, dataset, writer):
    path = tmp_path / "ds.json"
    (TD if writer == "port" else JD).save_dataset(dataset, path)
    other = tmp_path / "other.json"
    (JD if writer == "port" else TD).save_dataset(dataset, other)
    assert path.read_bytes() == other.read_bytes()
    for mod in (TD, JD):
        loaded = mod.load_dataset(path)
        assert loaded == dataset
        assert TD.dataset_fingerprint(loaded) == FINGERPRINT


# -------------------------------------------------------- evaluate_retrieval

def eval_slice(dataset, n_queries=24, n_multi=6, n_corpus=96, seed=0):
    """24 queries (6 multi-family) drawn with ``seed``; the corpus is each
    of their families' v6 articles in both languages and its v5 article in
    Russian, filled up to ``n_corpus`` with articles of other families;
    judgments kept on that corpus."""
    rng = np.random.default_rng(seed)
    qs = dataset["queries"]
    multi = [i for i, q in enumerate(qs) if q["source"] == "multi"]
    single = [i for i, q in enumerate(qs) if q["source"] != "multi"]
    picked = sorted(rng.choice(multi, n_multi, replace=False).tolist()
                    + rng.choice(single, n_queries - n_multi,
                                 replace=False).tolist())
    fams = set()
    for i in picked:
        q = qs[i]
        fams.update(tuple(f) for f in q.get("families",
                                            [[q["topic"], q["facet"]]]))
    by_kb = {a.kb_id: a for a in TG.generate_corpus()}
    keep = {c["kb_id"] for c in dataset["corpus"]
            if (by_kb[c["kb_id"]].topic, by_kb[c["kb_id"]].facet) in fams
            and (by_kb[c["kb_id"]].version == "v6"
                 or (by_kb[c["kb_id"]].version == "v5"
                     and by_kb[c["kb_id"]].language == "ru"))}
    others = [c["kb_id"] for c in dataset["corpus"]
              if (by_kb[c["kb_id"]].topic, by_kb[c["kb_id"]].facet)
              not in fams]
    assert len(keep) < n_corpus
    keep.update(rng.choice(others, n_corpus - len(keep),
                           replace=False).tolist())
    corpus = [c for c in dataset["corpus"] if c["kb_id"] in keep]
    queries = []
    for i in picked:
        q = dict(qs[i])
        q["judgments"] = {kb: g for kb, g in q["judgments"].items()
                          if kb in keep}
        queries.append(q)
    return {"queries": queries, "corpus": corpus}


@pytest.fixture(scope="module")
def small(dataset):
    ds = eval_slice(dataset)
    assert len(ds["corpus"]) == 96 and len(ds["queries"]) == 24
    assert sum(q["source"] == "multi" for q in ds["queries"]) == 6
    return ds


def _sibs(mod, ds):
    idx = mod()
    for c in ds["corpus"]:
        idx.add(c["kb_id"], c["tags"])
    return idx


def _j_members(slugs):
    reg = ModelRegistry()
    return [JR.TPUReranker(reg.get_reranker(s),
                           checkpoint=JR._bundled_checkpoint(s),
                           dtype=jnp.float32) for s in slugs]


def _j_priors(rr):
    rr.current_version = "v6"
    rr.prior_version_weight = SHIPPED.prior_version_weight
    rr.prior_language_weight = SHIPPED.prior_language_weight
    return rr


@pytest.fixture(scope="module")
def jax_rows(small):
    """JAX's rows on the slice: the shipped pair, the solo LLM reranker
    and the lexical-only and dense-only floors, float32."""
    reg = ModelRegistry()
    spec = reg.get_embedding_model(SHIPPED.embedding_model)
    ckpt = j_emb_ckpt(spec.slug)
    emb = JCached(TPUEmbedder(spec, checkpoint=ckpt, dtype=jnp.float32))
    slugs = SHIPPED.reranker_model.split(",")
    ensemble = _j_priors(JR.EnsembleReranker(
        _j_members(slugs),
        weights=[SHIPPED.reranker_ce_weight] * len(slugs)))
    solo = _j_priors(_j_members(["qwen3-reranker-micro"])[0])
    solo.blend, solo.ce_weight = "z", SHIPPED.reranker_ce_weight
    sib = dict(sibling_index=_sibs(JSiblingIndex, small), sibling_slots=6,
               sibling_anchors=3)
    lex = TPUEmbedder(spec.model_copy(update={"lexical_weight": 1.0}),
                      dtype=jnp.float32)
    dense = TPUEmbedder(spec.model_copy(update={
        "lexical_dim": 0, "lexical_weight": 0.0,
        "dimensions": spec.d_model}), checkpoint=ckpt, dtype=jnp.float32)
    return {
        "shipped_stage1": j_evaluate(emb, small, **EVAL_KW),
        "shipped": j_evaluate(emb, small, reranker=ensemble, **sib,
                              **EVAL_KW),
        "llm_reranker_solo": j_evaluate(emb, small, reranker=solo, **sib,
                                        **EVAL_KW),
        "lexical_only": j_evaluate(lex, small, **EVAL_KW),
        "dense_only": j_evaluate(dense, small, **EVAL_KW),
    }


def assert_rows_close(got, want):
    assert got["n_queries"] == want["n_queries"] == 24
    assert (got["n_corpus"], got["n_chunks"]) == \
        (want["n_corpus"], want["n_chunks"])
    assert len(got["per_query"]) == len(want["per_query"])
    for g, w in zip(got["per_query"], want["per_query"]):
        assert (g["query"], g["language"], g["source"]) == \
            (w["query"], w["language"], w["source"])
        for m in METRICS:
            assert abs(g[m] - w[m]) <= TOL, (g["query"], m, g[m], w[m])
    for key, value in want.items():
        if isinstance(value, float):
            assert abs(got[key] - value) <= TOL, key
    for block in ("by_language", "by_source"):
        assert got[block].keys() == want[block].keys()
        for name, row in want[block].items():
            for m, v in row.items():
                assert abs(got[block][name][m] - v) <= TOL, (block, name, m)
    assert got["chunk_level"].keys() == want["chunk_level"].keys()
    for m, v in want["chunk_level"].items():
        if isinstance(v, float):
            assert abs(got["chunk_level"][m] - v) <= TOL, m


@pytest.fixture(scope="module")
def port_embedder():
    return script._CachedEmbedder(create_embedder(
        SHIPPED.embedding_model, device="cpu", dtype=torch.float32))


@pytest.mark.parametrize("row", ["shipped_stage1", "shipped"])
def test_evaluate_retrieval_matches_jax(small, jax_rows, port_embedder, row):
    emb = port_embedder
    kw = dict(EVAL_KW)
    if row == "shipped":
        rr = TR.create_reranker(Settings(current_product_version="v6"),
                                device="cpu", dtype=torch.float32)
        assert isinstance(rr, TR.EnsembleReranker) and len(rr.members) == 4
        kw.update(reranker=rr, sibling_index=_sibs(SiblingIndex, small),
                  sibling_slots=6, sibling_anchors=3)
    timings = {}
    got = evaluate_retrieval(emb, small, device="cpu", timings=timings, **kw)
    assert_rows_close(got, jax_rows[row])
    assert {"chunk", "embed", "index", "search", "host"} <= timings.keys()
    assert ("rerank" in timings) == (row == "shipped")


def test_eval_script_matches_jax(tmp_path, small, jax_rows):
    ds_path = tmp_path / "small.json"
    TD.save_dataset(small, ds_path)
    out = tmp_path / "out.json"
    assert script.main([
        "--dataset", str(ds_path), "--shipped", "--chunk-tokens", "128",
        "--ablations", "--compare-rerankers",
        "llm_reranker_solo=qwen3-reranker-micro", "--per-query",
        "--device", "cpu", "--fp32", "--out", str(out)]) == 0
    got = json.loads(out.read_text("utf-8"))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.json",
                                                          "small.json"]
    assert got["dataset"]["fingerprint"] == TD.dataset_fingerprint(small)
    assert got["model"] == "frida-hybrid" and "card" not in got
    assert got["shipped_config"]["current_version"] == "v6"
    assert (got["shipped_config"]["pre_rerank_k"],
            got["shipped_config"]["sibling_expand_slots"],
            got["shipped_config"]["sibling_expand_anchors"]) == (20, 6, 3)
    for row, want in jax_rows.items():
        assert_rows_close(got[row], want)
        assert got[row]["seconds"] > 0
        se = got[row]["bootstrap_se"]
        assert se.keys() == {"ndcg@10", "recall@10", "mrr", "mrr_grade3",
                             "judged_avg@10"}
        assert all(0 <= v < 0.2 for v in se.values()), se
    rnd = got["random"]
    assert rnd["n_chunks"] == got["shipped"]["n_chunks"]
    assert all(0.0 <= rnd[m] <= 1.0 for m in ("recall@10", "ndcg@10"))


def test_bootstrap_se_is_the_resampled_means_std():
    rng = np.random.default_rng(5)
    vals = rng.random(312)
    idx = np.random.default_rng(0).integers(0, 312, (1000, 312))
    assert script.bootstrap_se(vals) == pytest.approx(
        vals[idx].mean(axis=1).std(), rel=1e-12)
    # about the textbook sigma / sqrt(n)
    assert script.bootstrap_se(vals) == pytest.approx(
        vals.std() / np.sqrt(312), rel=0.1)
    assert script.bootstrap_se(np.ones(40)) == 0.0


def test_eval_script_refuses_missing_checkpoints(tmp_path, small,
                                                 monkeypatch):
    ds_path = tmp_path / "small.json"
    TD.save_dataset(small, ds_path)
    base = ["--dataset", str(ds_path), "--shipped", "--chunk-tokens", "128",
            "--device", "cpu", "--fp32"]
    monkeypatch.setitem(TR._BUNDLED_CHECKPOINTS, "cross-encoder-small",
                        "no_such_checkpoint.npz")
    with pytest.raises(SystemExit, match="no bundled checkpoint"):
        script.main(base + ["--compare-rerankers",
                            "ce_quad=cross-encoder-micro,cross-encoder-small"])
    monkeypatch.setitem(TR._BUNDLED_CHECKPOINTS, "qwen3-reranker-micro",
                        "no_such_checkpoint.npz")
    with pytest.raises(SystemExit, match="identity"):
        script.main(base)


# ------------------------------------------- chip_smoke.py phase 12's gates

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)     # importing runs nothing
    return mod


@pytest.fixture(scope="module")
def reference():
    return json.loads((ROOT / "tests" / "eval_reference_jax.json")
                      .read_text("utf-8"))


def test_jax_reference_is_of_this_dataset(dataset, reference, smoke):
    assert reference["dataset"]["fingerprint"] == FINGERPRINT
    assert reference["shipped_config"] == json.loads(
        (ROOT / "EVAL_latest.json").read_text("utf-8"))["shipped_config"]
    queries = [q["query"] for q in dataset["queries"]]
    for row in smoke.EVAL_ROWS:
        rows = reference[row]["per_query"]
        assert [q["query"] for q in rows] == queries
        assert reference[row]["n_chunks"] == smoke.EVAL_SIZES["chunks"]
        for agg, key in smoke.EVAL_METRICS:
            assert reference[row][agg] == pytest.approx(
                np.mean([q[key] for q in rows]), abs=1e-12)


def test_eval_gates_pass_on_the_reference_and_catch_a_shift(reference,
                                                            smoke):
    record = json.loads((ROOT / "EVAL_latest.json").read_text("utf-8"))
    gates = smoke.eval_gates(reference, record, reference)
    for row in smoke.EVAL_ROWS:
        assert gates[row]["equal_share"] == 1.0
        for agg, _ in smoke.EVAL_METRICS:
            g = gates[row][agg]
            assert g["paired_mean"] == 0.0 and g["record_ses"] < 2.0
            assert g["se"] == pytest.approx(script.bootstrap_se(
                [q[k] for q in reference[row]["per_query"]
                 for a, k in smoke.EVAL_METRICS if a == agg]))
    assert "jax" not in smoke.eval_gates(reference, record,
                                         None)["shipped"]["ndcg@10"]
    # one query in ten moved by 0.3 ndcg: the paired gate sees it, the
    # record's noise does not
    moved = json.loads(json.dumps(reference))
    for q in moved["shipped"]["per_query"][::10]:
        q["ndcg"] = min(1.0, q["ndcg"] + 0.3)
    moved["shipped"]["ndcg@10"] = float(np.mean(
        [q["ndcg"] for q in moved["shipped"]["per_query"]]))
    with pytest.raises(AssertionError, match="shipped ndcg: mean port - JAX"):
        smoke.eval_gates(moved, record, reference)
    smoke.eval_gates(moved, record, None)


def test_scan_check_holds_the_last_row_only_clear_of_the_next(smoke):
    want = (torch.tensor([[0.9, 0.5]]), torch.tensor([[1, 2]],
                                                     dtype=torch.int32))
    got = (want[0].clone(), torch.tensor([[1, 3]], dtype=torch.int32))
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(AssertionError, match="position 1: 3 against 2"):
        smoke.check_against_plain("scan", got, want, ids, [])
    # row 3 scored a hair under row 2 in the twin: either may be k-th
    assert smoke.check_against_plain(
        "scan", got, want, ids, [], beyond=torch.tensor([0.5 - 1e-7])) == 0
    with pytest.raises(AssertionError, match="ids differ"):
        smoke.check_against_plain("scan", got, want, ids, [],
                                  beyond=torch.tensor([0.4]))
