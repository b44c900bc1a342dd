"""The port's sibling expansion (``cmw_rag_tpu_torch/retrieval/siblings.py``)
and the port's ``Retriever`` with it, against the JAX package's.

The index is built from the generated corpus's tags in both packages:
``split_tags``, ``sibling_key``, the families, ``ordered_siblings`` and
``expand_ranked_kb_ids`` on seeded ranked lists must be equal, and each
package must read the ``sibling_index.json`` the other writes. The
retriever runs on the corpus shape of ``tests/test_siblings.py`` (one
two-member family and an unrelated article, files on disk), the port's
over its own ``TorchVectorStore`` and the JAX one over its
``TPUVectorStore``: the same kb ids, contents, expansion marks and
``sibling_expansions``, scores within one bf16 step of a unit score.
"""

import json

import numpy as np
import pytest

from cmw_rag_tpu.eval.corpus_gen import generate_corpus as j_generate_corpus
from cmw_rag_tpu.index.tpu_store import TPUVectorStore
from cmw_rag_tpu.retrieval import siblings as J
from cmw_rag_tpu.retrieval.reranker import IdentityReranker as JIdentity
from cmw_rag_tpu.retrieval.retriever import Retriever as JRetriever
from cmw_rag_tpu_torch.eval.corpus_gen import generate_corpus
from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore
from cmw_rag_tpu_torch.retrieval import siblings as T
from cmw_rag_tpu_torch.retrieval.reranker import IdentityReranker
from cmw_rag_tpu_torch.retrieval.retriever import Retriever

#: one bf16 step at 1.0: the port's store keeps rows in bf16
SCORE_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def corpus():
    arts = generate_corpus()
    assert [(a.kb_id, a.tags) for a in arts] == \
        [(a.kb_id, a.tags) for a in j_generate_corpus()]
    return arts


@pytest.fixture(scope="module")
def indexes(corpus):
    t, j = T.SiblingIndex(), J.SiblingIndex()
    for a in corpus:
        t.add(a.kb_id, a.tags)
        j.add(a.kb_id, a.tags)
    return t, j


@pytest.mark.parametrize("tags", [
    ["v5", "RU", "Workflows", "Setup"], ["V5.1", "en-US", "", "  ", 42], [],
    ["workflows", "setup"], ["v5", "ru"], ["v5", "b", "a"],
    ["rus", "eng", "v10.2.3", "x"]])
def test_split_tags_and_key_equal_jax(tags):
    assert T.split_tags(tags) == J.split_tags(tags)
    assert T.sibling_key(tags) == J.sibling_key(tags)


def test_corpus_tags_parse_as_jax(corpus):
    for a in corpus:
        assert T.split_tags(a.tags) == J.split_tags(a.tags)
        assert T.sibling_key(a.tags) == J.sibling_key(a.tags)


def test_index_from_corpus_tags_equal_jax(corpus, indexes):
    t, j = indexes
    assert len(t) == len(j) == len(corpus)
    assert t.to_dict() == j.to_dict()
    for a in corpus[::97]:
        assert t.siblings_of(a.kb_id) == j.siblings_of(a.kb_id)
        assert t.info(a.kb_id) == j.info(a.kb_id)


@pytest.mark.parametrize("current_version", ["v6", "v4", ""])
@pytest.mark.parametrize("language", ["ru", "en", None])
def test_ordered_siblings_equal_jax(corpus, indexes, current_version,
                                    language):
    t, j = indexes
    rng = np.random.default_rng(7)
    for i in rng.choice(len(corpus), 64, replace=False):
        kb = corpus[int(i)].kb_id
        got = t.ordered_siblings(kb, current_version, language)
        assert got == j.ordered_siblings(kb, current_version, language)
        assert len(got) == 7  # 4 versions x 2 languages, less the article


@pytest.mark.parametrize("slots,anchors", [(6, 3), (6, 1), (2, 2), (9, 4),
                                           (0, 1)])
@pytest.mark.parametrize("top_k", [10, 4])
def test_expand_ranked_kb_ids_equal_jax(corpus, indexes, slots, anchors,
                                        top_k):
    t, j = indexes
    rng = np.random.default_rng(slots * 100 + anchors * 10 + top_k)
    ids = [a.kb_id for a in corpus]
    for case in range(40):
        n = int(rng.integers(0, 25))
        ranked = [ids[int(i)] for i in rng.integers(0, len(ids), n)]
        exclude = ({ids[int(i)] for i in rng.integers(0, len(ids), 30)}
                   if case % 2 else None)
        cur = ("v6", "v5", "")[case % 3]
        lang = ("ru", "en", None)[case % 3]
        got = T.expand_ranked_kb_ids(ranked, t, top_k, slots, anchors, cur,
                                     lang, exclude=exclude)
        assert got == J.expand_ranked_kb_ids(ranked, j, top_k, slots,
                                             anchors, cur, lang,
                                             exclude=exclude)
        assert len(got) == len(set(got)) <= top_k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_json_read_by_both(tmp_path, indexes, writer):
    t, j = indexes
    path = tmp_path / "sibling_index.json"
    (t if writer == "port" else j).save(path)
    other = tmp_path / "other.json"
    (j if writer == "port" else t).save(other)
    assert path.read_text("utf-8") == other.read_text("utf-8")
    for loaded in (T.SiblingIndex.load(path), J.SiblingIndex.load(path)):
        assert loaded.to_dict() == t.to_dict()
        assert loaded.ordered_siblings("4001", "v6", "ru") == \
            j.ordered_siblings("4001", "v6", "ru")
    assert json.loads(path.read_text("utf-8")) == t.to_dict()


def test_lifecycle_equal_jax():
    """Delete-then-add, tag changes and removals, step by step."""
    steps = [("add", "100", ["v5", "ru", "topic", "facet"]),
             ("add", "101", ["v5", "en", "topic", "facet"]),
             ("add", "102", ["v6", "ru", "topic", "facet"]),
             ("add", "200", ["v6", "ru", "other"]),
             ("add", "100", ["v5", "ru", "topic", "facet"]),
             ("add", "100", ["v5", "ru", "other"]),
             ("add", "101", ["v7", "en", "topic", "facet"]),
             ("add", "102", ["topic", "facet"]),
             ("remove", "200", None), ("remove", "200", None),
             ("remove", "999", None)]
    t, j = T.SiblingIndex(), J.SiblingIndex()
    for op, kb, tags in steps:
        if op == "add":
            t.add(kb, tags)
            j.add(kb, tags)
        else:
            assert t.remove(kb) == j.remove(kb)
        assert t.to_dict() == j.to_dict()
        assert len(t) == len(j)
        for probe in ("100", "101", "102", "200"):
            assert (probe in t) == (probe in j)
            assert t.siblings_of(probe) == j.siblings_of(probe)


# ------------------------------------------------------- retriever wiring

_DIRS = {"workflows": [1.0, 0.0, 0.0, 0.0], "indexing": [0.8, 0.6, 0.0, 0.0],
         "english": [0.0, 0.0, 1.0, 0.0]}


class DirectionalEmbedder:
    """``tests/test_siblings.py``'s embedder: queries land on the
    'workflows' axis; the EN sibling is orthogonal to it, so it can enter
    the results only by expansion."""

    dim = 4
    tokenizer = None

    def _embed(self, text):
        low = text.lower()
        for kw, v in _DIRS.items():
            if kw in low:
                return np.array(v, np.float32)
        return np.array([0.0, 0.0, 0.0, 1.0], np.float32)

    def embed_queries(self, texts, task=None):
        return np.stack([self._embed(t) for t in texts])

    def embed_documents(self, texts):
        return np.stack([self._embed(t) for t in texts])


ARTICLES = [
    ("4101", "Approval workflows", "v6,ru,workflows",
     "How to configure approval workflows.\n\nWorkflows step two."),
    ("4111", "Approval workflows EN", "v6,en,workflows",
     "English sibling of the approvals article.\n\nEnglish same topic."),
    ("4102", "Indexing guide", "v6,ru,indexing",
     "How indexing works.\n\nIndexing chunks and embeddings."),
]


def _fill(store, embedder, tmp_path):
    for kb, title, tags, body in ARTICLES:
        p = tmp_path / f"kb_{kb}.md"
        p.write_text(
            f"---\nkbId: {kb}\ntitle: {title}\ntags: {tags}\n---\n"
            f"# {title}\n\n{body}\n", encoding="utf-8")
        chunks = body.split("\n\n")
        store.add(
            texts=chunks,
            metadatas=[{"kbId": kb, "title": title, "source_file": str(p),
                        "stable_id": f"{kb}:{i}", "tags": tags}
                       for i in range(len(chunks))],
            ids=[f"{kb}:{i}" for i in range(len(chunks))],
            embeddings=embedder.embed_documents(chunks))


def _sibs(mod):
    sib = mod.SiblingIndex()
    for kb, _, tags, _ in ARTICLES:
        sib.add(kb, tags.split(","))
    return sib


CASES = {
    "expand": ("How to configure approval workflows.", 2, None, False),
    "stale": ("indexing chunks workflows approval", 2, None, True),
    "exclude": ("How to configure approval workflows.", 2, {"4111"}, False),
    "wide": ("How to configure approval workflows.", 3, None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("slots,anchors", [(1, 1), (2, 3)])
def test_retriever_with_siblings_matches_jax(tmp_path, case, slots, anchors):
    query, top_k, exclude, stale = CASES[case]
    emb = DirectionalEmbedder()
    tstore = TorchVectorStore(dim=4, device="cpu")
    jstore = TPUVectorStore(dim=4, use_pallas=False)
    _fill(tstore, emb, tmp_path)
    _fill(jstore, emb, tmp_path)
    if stale:  # in the sibling index, pruned from the store
        tstore.delete_where({"kbId": "4111"})
        jstore.delete_where({"kbId": "4111"})
    kw = dict(rerank_score_threshold=0.5, sibling_expand_slots=slots,
              sibling_expand_anchors=anchors, current_version="v6",
              url_template="https://kb.example/{kb_id}")
    tret = Retriever(emb, tstore, IdentityReranker(),
                     sibling_index=_sibs(T), **kw)
    jret = JRetriever(emb, jstore, JIdentity(), sibling_index=_sibs(J), **kw)
    got = tret.retrieve(query, top_k=top_k, exclude_kb_ids=exclude)
    want = jret.retrieve(query, top_k=top_k, exclude_kb_ids=exclude)
    assert [(a.kb_id, a.title, a.content, a.article_url,
             a.metadata.get("expansion"), a.normalized_rank,
             len(a.matched_chunks)) for a in got] == \
        [(a.kb_id, a.title, a.content, a.article_url,
          a.metadata.get("expansion"), a.normalized_rank,
          len(a.matched_chunks)) for a in want]
    np.testing.assert_allclose([a.score for a in got],
                               [a.score for a in want], atol=SCORE_TOL)
    tt, jt = dict(tret.last_trace), dict(jret.last_trace)
    tt.pop("confidence")
    jt.pop("confidence")
    assert tt == jt
    if case == "expand":
        assert tret.last_trace["sibling_expansions"] == 1
        assert "4111" in [a.kb_id for a in got]
    if case == "stale":
        assert len(got) == top_k and "4111" not in [a.kb_id for a in got]
