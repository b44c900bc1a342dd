"""The host rerank API of the port (cmw_rag_tpu_torch.retrieval.reranker)
against the JAX package's: ``apply_metadata_boosts``, ``IdentityReranker``,
``TorchReranker.rerank`` (raw and z blends, structural priors, boosts),
``EnsembleReranker.rerank`` with the shipping prior weight 0.4 and current
version "v6", and ``create_reranker``'s degrade-to-identity policy.

Float32 models on both sides with the bundled checkpoints; the same ids in
the same order, scores to 1e-4 (float32 sums in another order, amplified
by the z-normalisation of a few candidates).
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.config.registry import ModelRegistry
from cmw_rag_tpu.config.settings import Settings as JSettings
from cmw_rag_tpu.retrieval import reranker as J
from cmw_rag_tpu.tokenizer import get_tokenizer as j_tokenizer
from cmw_rag_tpu_torch.config import Settings, get_reranker
from cmw_rag_tpu_torch.retrieval import reranker as T

QUERY = "как настроить резервное копирование базы данных"
CANDS = [
    ("a", "Резервное копирование (v6): откройте Администрирование и задайте "
          "расписание.", {"kbId": "101", "tags": "backup, admin"}, 0.61),
    ("b", "Backup schedule (v5): open Administration and set the schedule.",
     {"kbId": "102", "has_code": True}, 0.58),
    ("c", "Шаблоны экспорта настраиваются в разделе Экспорт.",
     {"kbId": "103", "version": "v6", "section_index": 2}, 0.55),
    ("d", "The printer queue is configured from the Devices page.",
     {"kbId": "104"}, 0.50),
    ("e", "Резервные копии базы данных хранятся 30 дней (v6).",
     {"kbId": "105", "language": "ru"}, 0.57),
]
BOOSTS = {"has_code": 0.2, "tag:backup": 0.1, "section:2": 0.3}


def _cands(mod):
    return [mod.Candidate(id=i, text=t, metadata=dict(m), score=s)
            for i, t, m, s in CANDS]


def _same(got, want, atol=1e-4):
    assert [c.id for c in got] == [c.id for c in want]
    np.testing.assert_allclose([c.score for c in got],
                               [c.score for c in want], rtol=0, atol=atol)
    assert [c.metadata for c in got] == [c.metadata for c in want]


def _members(slug, **kw):
    jr = J.TPUReranker(ModelRegistry().get_reranker(slug),
                       tokenizer=j_tokenizer(), dtype=jnp.float32,
                       checkpoint=J._bundled_checkpoint(slug), **kw)
    tr = T.TorchReranker(get_reranker(slug), dtype=torch.float32,
                         checkpoint=T._bundled_checkpoint(slug), device="cpu",
                         **kw)
    return jr, tr


def test_apply_metadata_boosts_matches_jax():
    for _, _, meta, score in CANDS:
        assert T.apply_metadata_boosts(score, meta, BOOSTS) == \
            J.apply_metadata_boosts(score, meta, BOOSTS)
        assert T.apply_metadata_boosts(-score, meta, BOOSTS) == \
            J.apply_metadata_boosts(-score, meta, BOOSTS)


def test_identity_reranker_matches_jax():
    got = T.IdentityReranker(BOOSTS).rerank(QUERY, _cands(T), top_k=4)
    want = J.IdentityReranker(BOOSTS).rerank(QUERY, _cands(J), top_k=4)
    _same(got, want, atol=0)


@pytest.mark.parametrize("blend", ["raw", "z"])
def test_single_reranker_rerank_matches_jax(blend):
    kw = dict(blend=blend, vector_weight=4.0, ce_weight=0.35, boosts=BOOSTS,
              current_version="v6", prior_version_weight=0.4,
              prior_language_weight=0.2)
    jr, tr = _members("qwen3-reranker-micro", **kw)
    _same(tr.rerank(QUERY, _cands(T), top_k=4),
          jr.rerank(QUERY, _cands(J), top_k=4))
    one = _cands(T)[:1]  # one candidate: the raw blend, as in JAX
    _same(tr.rerank(QUERY, one, top_k=3), jr.rerank(QUERY, _cands(J)[:1], 3))
    assert tr.rerank(QUERY, [], top_k=3) == []


def test_ensemble_rerank_with_priors_matches_jax():
    slugs = ["cross-encoder-micro", "qwen3-reranker-micro"]
    pairs = [_members(s) for s in slugs]
    kw = dict(weights=[0.35, 0.35], boosts=BOOSTS, current_version="v6",
              prior_version_weight=0.4)
    jens = J.EnsembleReranker([p[0] for p in pairs], **kw)
    tens = T.EnsembleReranker([p[1] for p in pairs], **kw)
    got = tens.rerank(QUERY, _cands(T), top_k=5)
    _same(got, jens.rerank(QUERY, _cands(J), top_k=5))
    # the version prior adds 0.4 to the current-version candidates (a, c
    # and e: "(v6)" in the text or version="v6" in the metadata)
    tens.boosts = {}
    with_prior = {c.id: c.score for c in tens.rerank(QUERY, _cands(T), 5)}
    tens.prior_version_weight = 0.0
    without = {c.id: c.score for c in tens.rerank(QUERY, _cands(T), 5)}
    diff = {i: round(with_prior[i] - without[i], 5) for i in with_prior}
    assert diff == {"a": 0.4, "b": 0.0, "c": 0.4, "d": 0.0, "e": 0.4}


@pytest.mark.parametrize("slug", ["qwen3-reranker-0.6b", "no-such-reranker",
                                  "identity"])
def test_create_reranker_degrades_to_identity_like_jax(slug, caplog):
    """No weights for the slug (or no such slug): the identity reranker,
    with a warning, as the JAX factory does."""
    with caplog.at_level(logging.WARNING):
        got = T.create_reranker(Settings(reranker_model=slug), device="cpu")
        want = J.create_reranker(JSettings(reranker_model=slug),
                                 tokenizer=j_tokenizer())
    assert isinstance(got, T.IdentityReranker)
    assert isinstance(want, J.IdentityReranker)
    if slug != "identity":
        assert any("identity" in r.getMessage() for r in caplog.records
                   if r.name == T.__name__)
    _same(got.rerank(QUERY, _cands(T), 5), want.rerank(QUERY, _cands(J), 5),
          atol=0)


def test_create_reranker_single_slug_and_params():
    """One slug with a bundled checkpoint builds a TorchReranker with the
    settings' blend and priors; params= stand in for a checkpoint."""
    s = Settings(reranker_model="qwen3-reranker-micro",
                 current_product_version="v6")
    tr = T.create_reranker(s, device="cpu", dtype=torch.float32)
    jr = J.create_reranker(JSettings(reranker_model="qwen3-reranker-micro",
                                     current_product_version="v6"),
                           tokenizer=j_tokenizer())
    assert isinstance(tr, T.TorchReranker) and isinstance(jr, J.TPUReranker)
    for attr in ("blend", "ce_weight", "vector_weight", "current_version",
                 "prior_version_weight", "prior_language_weight"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    small = T.create_reranker(Settings(reranker_model="qwen3-reranker-0.6b"),
                              device="cpu", params=tr.params)
    assert isinstance(small, T.TorchReranker) and small.params is tr.params
    assert isinstance(T.create_reranker(Settings(
        reranker_model="cross-encoder-micro,no-such"), device="cpu"),
        T.IdentityReranker)


def test_create_reranker_does_not_hide_a_missing_card(monkeypatch):
    """Degrading to identity is for missing weights only: asking for the
    card where there is none raises, for an ensemble and for one model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for slug in (Settings().reranker_model, "qwen3-reranker-micro"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.create_reranker(Settings(reranker_model=slug))
