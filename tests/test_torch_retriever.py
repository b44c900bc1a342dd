"""The port's Retriever (cmw_rag_tpu_torch.retrieval.retriever) against the
JAX package's on the fixture knowledge base (``tests/fixtures``): the same
chunks (the JAX package's ingestion chunks both), a qwen3-arch embedder and
an LLM reranker with the same random weights (carried from the JAX trees),
the JAX ``TPUVectorStore(use_pallas=False)`` and the port's
``TorchVectorStore``. Float32 models on both sides: the same kb ids in the
same order, scores to 1e-4, the same article contents and the same trace.
The helpers the retriever needs (line-wise frontmatter, kbId digits, the
confidence summary) are held against theirs too.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.config.registry import EmbeddingModelSpec as JEmbSpec
from cmw_rag_tpu.config.registry import RerankerModelSpec as JRerankSpec
from cmw_rag_tpu.index.tpu_store import TPUVectorStore
from cmw_rag_tpu.ingest import documents as jdocs
from cmw_rag_tpu.ingest.documents import DocumentProcessor
from cmw_rag_tpu.ingest.indexer import Indexer
from cmw_rag_tpu.retrieval import confidence as jconf
from cmw_rag_tpu.retrieval import reranker as JR
from cmw_rag_tpu.retrieval.embedder import TPUEmbedder
from cmw_rag_tpu.retrieval.retriever import Retriever as JRetriever
from cmw_rag_tpu.tokenizer import get_tokenizer as j_tokenizer
from cmw_rag_tpu.utils import metadata as jmeta
from cmw_rag_tpu_torch.config import EmbeddingModelSpec, RerankerModelSpec
from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore
from cmw_rag_tpu_torch.ingest import documents as tdocs
from cmw_rag_tpu_torch.models.weights import params_from_jax
from cmw_rag_tpu_torch.retrieval import confidence as tconf
from cmw_rag_tpu_torch.retrieval import reranker as TR
from cmw_rag_tpu_torch.retrieval.embedder import TorchEmbedder
from cmw_rag_tpu_torch.retrieval.retriever import Retriever
from cmw_rag_tpu_torch.utils import metadata as tmeta

FIXTURES = Path(__file__).resolve().parent / "fixtures"
NARROW = dict(d_model=64, d_ff=128, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=16, vocab_size=0)
QUERIES = [
    "How do I configure an approval workflow template?",
    "инкрементальная переиндексация базы знаний",
    " ".join(["escalation rules for approval steps and roles"] * 12),
]
RETRIEVER_KW = dict(top_k_retrieve=6, pre_rerank_limit=10,
                    rerank_article_window=20, max_segments=4,
                    segment_tokens=32, segment_overlap=8)


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def kb():
    docs = DocumentProcessor("folder").process(FIXTURES)
    emb_fields = dict(slug="tiny-qwen3", arch="qwen3", dimensions=64,
                      max_tokens=512, pooling="last_token", normalize=True,
                      instruction_template="Instruct: {task}\nQuery: {query}",
                      default_task="find the passage", **NARROW)
    jemb = TPUEmbedder(JEmbSpec(**emb_fields), tokenizer=j_tokenizer(),
                       seed=0, dtype=jnp.float32)
    temb = TorchEmbedder(EmbeddingModelSpec(**emb_fields), device="cpu",
                         dtype=torch.float32, params=_carry(jemb.params))
    rr_fields = dict(slug="tiny-qwen3-rr", kind="llm_reranker", arch="qwen3",
                     max_tokens=512, template_system='Answer "yes" or "no".',
                     template_user="<Query>: {query}\n<Document>: {document}",
                     **NARROW)
    prior = dict(blend="z", ce_weight=0.35, current_version="v6",
                 prior_version_weight=0.4)
    jrr = JR.TPUReranker(JRerankSpec(**rr_fields), tokenizer=j_tokenizer(),
                         seed=1, dtype=jnp.float32, **prior)
    trr = TR.TorchReranker(RerankerModelSpec(**rr_fields), device="cpu",
                           dtype=torch.float32, params=_carry(jrr.params),
                           **prior)
    jstore = TPUVectorStore(dim=64, use_pallas=False)
    tstore = TorchVectorStore(dim=64, device="cpu")
    for emb, store in ((jemb, jstore), (temb, tstore)):
        stats = Indexer(emb, store, chunk_size=48,
                        chunk_overlap=8).index_documents(docs)
        assert stats["documents_indexed"] == 2 and stats["chunks_indexed"] > 6
    assert tstore.count() == jstore.count()
    return (jemb, jstore, jrr), (temb, tstore, trr)


def _summary(articles):
    return [(a.kb_id, a.title, a.content, a.article_url, a.normalized_rank,
             len(a.matched_chunks)) for a in articles]


@pytest.mark.parametrize("reranker", ["llm", "identity"])
@pytest.mark.parametrize("threshold", [0.5, -10.0])
def test_retrieve_matches_jax(kb, reranker, threshold):
    (jemb, jstore, jrr), (temb, tstore, trr) = kb
    if reranker == "identity":
        jrr, trr = JR.IdentityReranker(), TR.IdentityReranker()
    jret = JRetriever(jemb, jstore, jrr, rerank_score_threshold=threshold,
                      **RETRIEVER_KW)
    tret = Retriever(temb, tstore, trr, rerank_score_threshold=threshold,
                     **RETRIEVER_KW)
    n_articles = 0
    for q in QUERIES:
        want = jret.retrieve(q, top_k=2)
        got = tret.retrieve(q, top_k=2)
        assert _summary(got) == _summary(want)
        np.testing.assert_allclose([a.score for a in got],
                                   [a.score for a in want], rtol=0, atol=1e-4)
        jt, tt = dict(jret.last_trace), dict(tret.last_trace)
        jc, tc = jt.pop("confidence"), tt.pop("confidence")
        assert tt == jt
        assert tc.keys() == jc.keys()
        for key in tc:
            assert tc[key] == pytest.approx(jc[key], abs=1e-4), key
        n_articles += len(got)
    assert tret.last_trace["segments"] > 1  # the long query was segmented
    if threshold < 0:
        assert n_articles == 2 * len(QUERIES)


def test_retrieve_excludes_kb_ids_and_reads_the_article(kb):
    _, (temb, tstore, trr) = kb
    tret = Retriever(temb, tstore, trr, rerank_score_threshold=-10.0,
                     **RETRIEVER_KW)
    got = tret.retrieve(QUERIES[0], top_k=5, exclude_kb_ids={"4102"})
    assert [a.kb_id for a in got] == ["4101"]
    assert got[0].content.startswith("# Configuring approval workflows")
    assert "---" not in got[0].content and "Escalation rules" in got[0].content


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="decomposition"):
        Retriever(None, None, query_decomposition=True)
    # sibling expansion is ported (tests/test_torch_siblings.py)
    r = Retriever(None, None, sibling_index=object(), sibling_expand_slots=6,
                  sibling_expand_anchors=3, current_version="v6")
    assert (r.sibling_expand_slots, r.sibling_expand_anchors,
            r.current_version) == (6, 3, "v6")


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.md")))
def test_frontmatter_body_matches_jax(name):
    text = (FIXTURES / name).read_text(encoding="utf-8")
    jmeta_, jbody = jdocs.parse_frontmatter(text)
    tmeta_, tbody = tdocs.parse_frontmatter(text)
    assert tbody == jbody
    assert {k: str(v) for k, v in jmeta_.items() if k in ("kbId", "title")} \
        == {k: v for k, v in tmeta_.items() if k in ("kbId", "title")}
    broken = "---\ntitle: Настройка: учётные записи\nkbId: 77\n---\nBody\n"
    assert tdocs.parse_frontmatter(broken) == jdocs.parse_frontmatter(broken)
    assert tdocs.parse_frontmatter("no block") == jdocs.parse_frontmatter(
        "no block")


def test_kbid_and_confidence_helpers_match_jax():
    for kb in ("4578-toc", 4101, None, "toc", "kb 12 and 34"):
        assert tmeta.extract_numeric_kbid(kb) == jmeta.extract_numeric_kbid(kb)
    for scores in ([], [0.9, 0.2, 0.7], [0.1] * 7):
        assert tconf.compute_retrieval_confidence(scores, 0.5) == \
            jconf.compute_retrieval_confidence(scores, 0.5)
