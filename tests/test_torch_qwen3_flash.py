"""The Qwen3 flash route of the port against the JAX package, with the JAX
flash kernel in interpret mode: the model forward (``use_flash=True``), and
the qwen3-arch embedder and the LLM reranker at the 1024-token bucket, where
both switch to flash (``flash_min_seq = 1024``, set on both sides: each
package keeps it at 0 off its accelerator).

Float32 weights and activations on both sides; tolerances are the JAX
package's flash-route tolerance (rtol 5e-3, atol 5e-4,
tests/test_flash_attention.py) for hidden states, and 5e-3 for unit vectors
and scores, which must also come out in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmw_rag_tpu.ops.flash_attention as JF
from cmw_rag_tpu.config.registry import EmbeddingModelSpec as JEmbSpec
from cmw_rag_tpu.config.registry import RerankerModelSpec as JRerankSpec
from cmw_rag_tpu.models import qwen3 as jqwen
from cmw_rag_tpu.retrieval.embedder import TPUEmbedder
from cmw_rag_tpu.retrieval.reranker import TPUReranker
from cmw_rag_tpu.tokenizer import get_tokenizer as j_tokenizer
from cmw_rag_tpu_torch.config import EmbeddingModelSpec, RerankerModelSpec
from cmw_rag_tpu_torch.models import qwen3 as tqwen
from cmw_rag_tpu_torch.models.weights import params_from_jax
from cmw_rag_tpu_torch.ops import flash_attention as TF
from cmw_rag_tpu_torch.retrieval.embedder import TorchEmbedder
from cmw_rag_tpu_torch.retrieval.reranker import TorchReranker

NARROW = dict(d_model=64, d_ff=128, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=16)
LONG_DOC = " ".join(["database configuration export backup schedule"] * 160)
DOCS = [LONG_DOC,
        LONG_DOC.replace("backup", "restore"),
        " ".join(["workflow approval escalation rule"] * 130)]


@pytest.fixture
def interpret_flash(monkeypatch):
    """Run the JAX flash kernel in interpret mode; record its calls, and the
    port's calls of its flash twin, as {"jax": [...], "port": [...]}."""
    calls = {"jax": [], "port": []}
    orig = JF.flash_attention_bhld
    twin = TF.flash_attention_plain

    def patched(q, k, v, m, **kw):
        calls["jax"].append(q.shape)
        kw["interpret"] = True
        return orig(q, k, v, m, **kw)

    def counted(q, *a, **kw):
        calls["port"].append(tuple(q.shape))
        return twin(q, *a, **kw)

    monkeypatch.setattr(JF, "flash_attention_bhld", patched)
    monkeypatch.setattr(TF, "flash_attention_plain", counted)
    return calls


def test_qwen3_flash_route_matches_jax():
    kw = dict(vocab_size=512, **NARROW)
    jcfg = jqwen.Qwen3Config(dtype=jnp.float32, **kw)
    tcfg = tqwen.Qwen3Config(dtype=torch.float32, **kw)
    jp = jqwen.init_qwen3(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 512, (2, 256)).astype(np.int32)
    mask = np.ones((2, 256), np.int32)
    mask[1, 200:] = 0
    want = jqwen.qwen3_hidden_states(jp, jcfg, jnp.asarray(ids),
                                     jnp.asarray(mask), use_flash=True,
                                     flash_block=64, flash_interpret=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    got = tqwen.qwen3_hidden_states(tp, tcfg, torch.from_numpy(ids),
                                    torch.from_numpy(mask), use_flash=True,
                                    flash_block=64)
    plain = tqwen.qwen3_hidden_states(tp, tcfg, torch.from_numpy(ids),
                                      torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got.numpy()[real], plain.numpy()[real],
                               rtol=5e-3, atol=5e-4)


def test_qwen3_embedder_at_the_1024_bucket_matches_jax(interpret_flash):
    fields = dict(slug="tiny-qwen3", arch="qwen3", dimensions=64,
                  max_tokens=8192, pooling="last_token", normalize=True,
                  instruction_template="Instruct: {task}\nQuery: {query}",
                  default_task="find the passage", vocab_size=0, **NARROW)
    jemb = TPUEmbedder(JEmbSpec(**fields), tokenizer=j_tokenizer(), seed=0,
                       dtype=jnp.float32)
    temb = TorchEmbedder(EmbeddingModelSpec(**fields), device="cpu",
                         dtype=torch.float32,
                         params=params_from_jax(jax.tree.map(np.asarray,
                                                             jemb.params)))
    assert temb.flash_min_seq == 0 and jemb.flash_min_seq == 0
    temb.flash_min_seq = jemb.flash_min_seq = 1024
    assert temb.tokenize_batch(DOCS)[0].shape[1] == 1024
    assert temb.uses_flash(1024) and not temb.uses_flash(512)
    want = jemb.embed_documents(DOCS)
    assert interpret_flash["jax"], "the JAX embedder took no flash route"
    got = temb.embed_documents(DOCS)
    # one call per layer, [B * H, 1024, Dh]
    assert interpret_flash["port"] == [(4 * 4, 1024, 16)] * 2
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    # queries get the instruction, documents are not formatted
    q = ["how to export the database configuration"]
    np.testing.assert_allclose(temb.embed_queries(q), jemb.embed_queries(q),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    sims_t = temb.embed_queries(q) @ got.T
    sims_j = jemb.embed_queries(q) @ want.T
    assert np.argsort(-sims_t[0]).tolist() == np.argsort(-sims_j[0]).tolist()


def test_llm_reranker_at_the_1024_bucket_matches_jax(interpret_flash):
    fields = dict(slug="tiny-qwen3-rr", kind="llm_reranker", arch="qwen3",
                  max_tokens=8192,
                  template_system='Answer "yes" or "no".',
                  template_user="<Query>: {query}\n<Document>: {document}",
                  default_instruction="", vocab_size=0, **NARROW)
    jr = TPUReranker(JRerankSpec(**fields), tokenizer=j_tokenizer(), seed=1,
                     dtype=jnp.float32)
    tr = TorchReranker(RerankerModelSpec(**fields), device="cpu",
                       dtype=torch.float32,
                       params=params_from_jax(jax.tree.map(np.asarray,
                                                           jr.params)))
    assert tr.flash_min_seq == 0 and jr.flash_min_seq == 0
    tr.flash_min_seq = jr.flash_min_seq = 1024
    query = "how to export the database configuration"
    ids, _ = tr._tokenize([tr.spec.format_pair(query, d) for d in DOCS])
    assert ids.shape[1] == 1024 and tr.uses_flash(1024)
    want = jr.score_pairs(query, DOCS)
    assert interpret_flash["jax"], "the JAX reranker took no flash route"
    got = tr.score_pairs(query, DOCS)
    assert interpret_flash["port"] == [(4 * 4, 1024, 16)] * 2
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    assert np.argsort(-got).tolist() == np.argsort(-want).tolist()
    tr.flash_min_seq = 0  # the plain route gives the same scores
    np.testing.assert_allclose(tr.score_pairs(query, DOCS), got, rtol=0,
                               atol=5e-3)


def test_flash_route_rule():
    """Flash from flash_min_seq on, for 512-aligned buckets only; off on the
    CPU by default; never for the T5 family."""
    spec = EmbeddingModelSpec(slug="t", arch="qwen3", dimensions=64,
                              max_tokens=8192, pooling="last_token", **NARROW)
    emb = TorchEmbedder(spec, device="cpu", dtype=torch.float32)
    assert not emb.uses_flash(4096)
    emb.flash_min_seq = 1024
    assert [emb.uses_flash(n) for n in (512, 1024, 1536, 2048, 8192)] == \
        [False, True, True, True, True]
    assert not emb.uses_flash(1000)
    t5 = TorchEmbedder(EmbeddingModelSpec(
        slug="t5", arch="t5_encoder", dimensions=64, max_tokens=512,
        pooling="mean", d_model=64, d_ff=128, num_layers=1, num_heads=2),
        device="cpu")
    t5.flash_min_seq = 1024
    assert not t5.uses_flash(1024)
    assert TF.total_launches() == 0  # nothing launched on the CPU
