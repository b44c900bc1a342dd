"""The slice as a whole: the port's FusedPipeline returns the same ids as
cmw_rag_tpu.retrieval.fused.FusedPipeline for the same corpus, queries and
weights, with a bf16 and an int8 corpus. Towers run in float32 on both sides
so that near-ties rank the same; scores agree to 1e-4 (sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.config.registry import ModelRegistry
from cmw_rag_tpu.retrieval import embedder as JE
from cmw_rag_tpu.retrieval import fused as JF
from cmw_rag_tpu.retrieval import reranker as JR
from cmw_rag_tpu.tokenizer import get_tokenizer as j_tokenizer
from cmw_rag_tpu_torch import config as C
from cmw_rag_tpu_torch.models.weights import params_from_jax
from cmw_rag_tpu_torch.retrieval.embedder import TorchEmbedder, create_embedder
from cmw_rag_tpu_torch.retrieval.fused import FusedPipeline
from cmw_rag_tpu_torch.retrieval.reranker import (
    EnsembleReranker,
    TorchReranker,
    create_reranker,
)
from test_fused_pipeline import CORPUS, _ce_spec, _hybrid_word_spec, _llm_spec

QUERIES = ["workflow template export", "email backup settings",
           "настройка резервного копирования",
           " ".join(["database configuration steps"] * 200)]  # 2 segments


def _port(spec, cls):
    return cls(**spec.model_dump())


def _jax_params(m):
    return params_from_jax(jax.tree.map(np.asarray, m.params))


@pytest.fixture(scope="module")
def embedders():
    """A small hybrid tower (dense + unigram + word + bigram blocks, the
    shipping layout at narrow widths), random weights carried from JAX."""
    je = JE.TPUEmbedder(_hybrid_word_spec(), tokenizer=j_tokenizer(), seed=0,
                        dtype=jnp.float32)
    te = TorchEmbedder(_port(_hybrid_word_spec(), C.EmbeddingModelSpec),
                       params=_jax_params(je), dtype=torch.float32,
                       device="cpu")
    return je, te


def _rerankers(kind):
    members = {"none": [], "ce_raw": [(_ce_spec, 3)], "ce": [(_ce_spec, 3)],
               "llm": [(_llm_spec, 4)],
               "ensemble": [(_ce_spec, 3), (_llm_spec, 9)]}[kind]
    blend = "raw" if kind == "ce_raw" else "z"
    kw = dict(max_pair_tokens=512, blend=blend, ce_weight=0.6,
              vector_weight=0.75 if kind == "ce_raw" else 0.0)
    jm = [JR.TPUReranker(f(), tokenizer=j_tokenizer(), seed=s,
                         dtype=jnp.float32, **kw) for f, s in members]
    tm = [TorchReranker(_port(f(), C.RerankerModelSpec), params=_jax_params(m),
                        dtype=torch.float32, device="cpu", **kw)
          for (f, _), m in zip(members, jm)]
    if kind == "none":
        return None, None
    if kind == "ensemble":
        return (JR.EnsembleReranker(jm, weights=[0.55, 0.4]),
                EnsembleReranker(tm, weights=[0.55, 0.4]))
    return jm[0], tm[0]


def _assert_same(a, b):
    np.testing.assert_array_equal(b["ids"], a["ids"])
    valid = a["ids"] >= 0
    np.testing.assert_allclose(b["rerank_scores"][valid],
                               a["rerank_scores"][valid], atol=1e-4, rtol=0)
    np.testing.assert_allclose(b["vector_scores"][valid],
                               a["vector_scores"][valid], atol=1e-4, rtol=0)


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind", ["none", "ce_raw", "ce", "llm", "ensemble"])
def test_small_specs_match_jax_pipeline(embedders, kind, quantize):
    je, te = embedders
    jr, tr = _rerankers(kind)
    kw = dict(top_k_retrieve=6, pre_rerank_limit=12,
              rerank_keep=8 if jr is not None else None, top_k=4,
              max_chunk_tokens=48, rerank_microbatch=8, quantize=quantize)
    jp = JF.FusedPipeline(je, jr, use_pallas=False, **kw)
    jp.build(CORPUS)
    tp = FusedPipeline(te, tr, **kw)
    tp.build(CORPUS)
    if quantize:
        assert tp._vecs[0].dtype == torch.int8
        np.testing.assert_array_equal(tp._vecs[0].numpy(),
                                      np.asarray(jp._vecs[0]))
    _assert_same(jp.query(QUERIES), tp.query(QUERIES))


def test_fewer_candidates_than_cap(embedders):
    """cap > corpus: padding candidates come back as id −1."""
    je, te = embedders
    kw = dict(top_k_retrieve=8, pre_rerank_limit=64, top_k=40)
    jp = JF.FusedPipeline(je, None, use_pallas=False, **kw)
    jp.build(CORPUS[:16])
    tp = FusedPipeline(te, None, **kw)
    tp.build(CORPUS[:16])
    a, b = jp.query(["database"]), tp.query(["database"])
    np.testing.assert_array_equal(b["ids"], a["ids"])
    assert int((b["ids"] >= 0).sum()) == 8


def test_blend_scores_z_uses_sample_std(embedders):
    """The in-program z-blend divides by the n−1 std over valid columns."""
    _, te = embedders
    _, tr = _rerankers("ensemble")
    pipe = FusedPipeline(te, tr, top_k=2, rerank_keep=4, pre_rerank_limit=4)
    rng = np.random.default_rng(0)
    rr = rng.uniform(0.05, 0.95, (2, 1, 4)).astype(np.float32)
    kcs = rng.standard_normal((1, 4)).astype(np.float32)
    kvalid = np.asarray([[True, True, True, False]])
    got = pipe.blend_scores(torch.from_numpy(rr), torch.from_numpy(kcs),
                            torch.from_numpy(kvalid)).numpy()[0, :3]

    def z(x):
        x = x[0, :3].astype(np.float64)
        return (x - x.mean()) / x.std(ddof=1)

    want = z(kcs)
    for w, r in zip([0.55, 0.4], rr):
        want = want + w * z(np.log(r / (1 - r)))
    np.testing.assert_allclose(got, want, atol=1e-5)


BILINGUAL = [
    f"{'Статья' if i % 2 else 'Article'} {i}: {t} — "
    f"{'настройка и устранение неполадок' if i % 2 else 'configuration and troubleshooting'}"
    f" {t}, шаг {i % 7}."
    for i, t in enumerate(["база данных", "printer", "license",
                           "резервное копирование", "email", "workflow",
                           "archive", "export", "login", "dashboard"] * 5)]


@pytest.fixture(scope="module")
def shipping():
    """frida-hybrid and the 4-member shipping ensemble on their bundled
    checkpoints, float32, in both packages."""
    reg = ModelRegistry()
    slugs = C.Settings().reranker_model.split(",")
    je = JE.TPUEmbedder(reg.get_embedding_model("frida-hybrid"),
                        tokenizer=j_tokenizer(), dtype=jnp.float32,
                        checkpoint=JE._bundled_checkpoint("frida-hybrid"))
    jr = JR.EnsembleReranker(
        [JR.TPUReranker(reg.get_reranker(s), tokenizer=j_tokenizer(),
                        dtype=jnp.float32,
                        checkpoint=JR._bundled_checkpoint(s)) for s in slugs],
        weights=[C.Settings().reranker_ce_weight] * len(slugs))
    te = create_embedder(device="cpu", dtype=torch.float32)
    tr = create_reranker(device="cpu", dtype=torch.float32)
    return je, jr, te, tr


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_shipping_checkpoints_match_jax_pipeline(shipping, quantize):
    """The shipping retrieval shape (20 per segment, cap 60, rerank 20,
    top 10) over 50 bilingual chunks."""
    je, jr, te, tr = shipping
    kw = dict(top_k_retrieve=20, pre_rerank_limit=60, rerank_keep=20,
              top_k=10, max_chunk_tokens=64, rerank_microbatch=32,
              quantize=quantize)
    jp = JF.FusedPipeline(je, jr, use_pallas=False, **kw)
    jp.build(BILINGUAL)
    tp = FusedPipeline(te, tr, **kw)
    tp.build(BILINGUAL)
    qs = ["как настроить резервное копирование", "printer troubleshooting"]
    a, b = jp.query(qs), tp.query(qs)
    _assert_same(a, b)
    assert (b["ids"] >= 0).all()
