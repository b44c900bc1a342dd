"""PyTorch port of the rerankers (cmw_rag_tpu_torch.retrieval.reranker)
against the JAX package on the four shipping checkpoints, float32 on both
sides (scores to 1e-4: sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.config.registry import ModelRegistry
from cmw_rag_tpu.retrieval import reranker as J
from cmw_rag_tpu.tokenizer import get_tokenizer as j_tokenizer
from cmw_rag_tpu_torch.config import Settings, get_reranker
from cmw_rag_tpu_torch.retrieval import reranker as T

SHIPPING = Settings().reranker_model.split(",")
QUERY = "как настроить резервное копирование базы данных"
DOCS = [
    "Резервное копирование: откройте Администрирование → Базы данных и "
    "задайте расписание.",
    "The printer queue is configured from the Devices page.",
    "Backup schedule: open Administration → Databases and set the schedule.",
    "Шаблоны экспорта настраиваются в разделе Экспорт.",
    "Webhooks send a POST request on every record change.",
]


def _pair(slug):
    spec = ModelRegistry().get_reranker(slug)
    ckpt = J._bundled_checkpoint(slug)
    jr = J.TPUReranker(spec, tokenizer=j_tokenizer(), dtype=jnp.float32,
                       checkpoint=ckpt)
    tr = T.TorchReranker(get_reranker(slug), dtype=torch.float32,
                         checkpoint=T._bundled_checkpoint(slug), device="cpu")
    return jr, tr


@pytest.mark.parametrize("slug", SHIPPING)
def test_member_scores_match_jax(slug):
    jr, tr = _pair(slug)
    assert T._bundled_checkpoint(slug).endswith(J._BUNDLED_CHECKPOINTS[slug])
    want = jr.score_pairs(QUERY, DOCS)
    got = tr.score_pairs(QUERY, DOCS)
    assert got.shape == (len(DOCS),)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_zlogit_matches_jax():
    s = np.asarray([0.1, 0.9, 0.5, 1e-9, 1.0 - 1e-9], np.float32)
    np.testing.assert_array_equal(T._zlogit(s), J._zlogit(s))


def test_shipping_ensemble_matches_jax():
    """create_reranker builds the shipping 4-member z-logit ensemble; its
    host rerank (population std) orders candidates as the JAX one does."""
    tens = T.create_reranker(device="cpu", dtype=torch.float32)
    assert isinstance(tens, T.EnsembleReranker)
    assert [m.spec.slug for m in tens.members] == SHIPPING
    assert tens.weights == [Settings().reranker_ce_weight] * 4
    jens = J.EnsembleReranker(
        [J.TPUReranker(ModelRegistry().get_reranker(s),
                       tokenizer=j_tokenizer(), dtype=jnp.float32,
                       checkpoint=J._bundled_checkpoint(s)) for s in SHIPPING],
        weights=tens.weights)
    cands = [T.Candidate(id=i, text=d, score=0.5 - 0.05 * i)
             for i, d in enumerate(DOCS)]
    jc = [J.Candidate(id=c.id, text=c.text, score=c.score) for c in cands]
    got = tens.rerank(QUERY, cands, top_k=4)
    want = jens.rerank(QUERY, jc, top_k=4)
    assert [c.id for c in got] == [c.id for c in want]
    np.testing.assert_allclose([c.score for c in got],
                               [c.score for c in want], atol=1e-4)
    np.testing.assert_allclose(tens.score_pairs(QUERY, DOCS),
                               jens.score_pairs(QUERY, DOCS), atol=1e-4)


@pytest.mark.parametrize("slug", ["cross-encoder-micro", "qwen3-reranker-micro"])
def test_random_init_scores_are_seeded_probabilities(slug):
    """With no checkpoint, weights come from a seeded torch.Generator: the
    same seed gives the same scores, each strictly inside (0, 1)."""
    a = T.TorchReranker(get_reranker(slug), seed=3, device="cpu")
    b = T.TorchReranker(get_reranker(slug), seed=3, device="cpu")
    s = a.score_pairs(QUERY, DOCS)
    assert ((s > 0) & (s < 1)).all()
    np.testing.assert_array_equal(s, b.score_pairs(QUERY, DOCS))
