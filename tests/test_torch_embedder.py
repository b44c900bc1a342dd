"""PyTorch port of the query-side host work and the embedder
(cmw_rag_tpu_torch.config, .tokenizer, .retrieval.{segments, wordhash,
embedder}) against the JAX package on the same texts and weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.config.registry import ModelRegistry
from cmw_rag_tpu.config.settings import Settings as JSettings
from cmw_rag_tpu.retrieval import embedder as J
from cmw_rag_tpu.retrieval import wordhash as jword
from cmw_rag_tpu.retrieval.retriever import split_query_segments as j_split
from cmw_rag_tpu.tokenizer import get_tokenizer as j_tokenizer
from cmw_rag_tpu_torch import config as C
from cmw_rag_tpu_torch.retrieval import embedder as T
from cmw_rag_tpu_torch.retrieval import wordhash as tword
from cmw_rag_tpu_torch.retrieval.segments import split_query_segments
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

TEXTS = [
    "Как настроить резервное копирование базы данных?",
    "How do I configure the printer queue on Windows 10?",
    "Ошибка 0x80070005 при экспорте шаблона — что делать?",
    "webhook: POST /api/v1/records {\"id\": 42}\n\tretry=3",
    "",
    "Переключение языка интерфейса: English ↔ русский, 'quoted' words",
]


def test_tokenizer_ids_equal_jax():
    tj, tt = j_tokenizer(), get_tokenizer()
    assert tt.n_vocab == tj.n_vocab
    for t in TEXTS + ["<|im_start|>user\nhi<|im_end|>"]:
        assert tt.encode(t) == tj.encode(t)
        assert tt.encode(t, allowed_special="all") == \
            tj.encode(t, allowed_special="all")
        assert tt.decode(tt.encode(t)) == tj.decode(tj.encode(t))


def test_split_query_segments_equal_jax():
    long_q = " ".join(TEXTS * 30)
    for q in (TEXTS[0], long_q):
        assert split_query_segments(q, get_tokenizer(), 4, 96, 16) == \
            j_split(q, j_tokenizer(), 4, 96, 16)


def test_specs_and_settings_equal_registry():
    reg = ModelRegistry()
    for slug, spec in C.EMBEDDING_MODELS.items():
        assert vars(spec) == reg.get_embedding_model(slug).model_dump()
    for slug, spec in C.RERANKERS.items():
        assert vars(spec) == reg.get_reranker(slug).model_dump()
    js = JSettings()
    for name, value in vars(C.Settings()).items():
        assert getattr(js, name) == value, name
    spec = C.get_embedding_model("FRIDA-hybrid")
    assert spec.format_query("q") == reg.get_embedding_model(
        "frida-hybrid").format_query("q")
    rr = C.get_reranker("qwen3-reranker-micro")
    assert rr.format_pair("q", "d") == reg.get_reranker(
        "qwen3-reranker-micro").format_pair("q", "d")


def test_word_hasher_equal_jax():
    np.testing.assert_array_equal(tword.WordHasher(96).vectors(TEXTS),
                                  jword.WordHasher(96).vectors(TEXTS))


def _rows(seed):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(1, 16388, size=n).tolist() for n in (1, 2, 7, 40, 64)]
    ids = np.zeros((len(rows), 64), np.int32)
    mask = np.zeros((len(rows), 64), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return rows, ids, mask


@pytest.mark.parametrize("dim", [1792, 1024, 2048])
def test_hash_buckets_and_signs_bit_exact(dim):
    """Both JAX forms: the host uint64 hash and the jit int32 split."""
    ids = np.arange(0, 32749, dtype=np.int64)
    b, s = T.hash_buckets_signs(torch.from_numpy(ids), dim)
    u = ids.astype(np.uint64)
    host_b = ((u * np.uint64(2654435761)) >> np.uint64(16)) % np.uint64(dim)
    host_s = np.where(((u * np.uint64(40503)) >> np.uint64(7)) & np.uint64(1),
                      1.0, -1.0)
    i32 = ids.astype(np.int32)
    a = i32 * J._HASH_HI
    jit_b = (a + ((i32 * J._HASH_LO) >> 16)) % dim
    np.testing.assert_array_equal(b.numpy(), host_b.astype(np.int64))
    np.testing.assert_array_equal(b.numpy(), jit_b)
    np.testing.assert_array_equal(s.numpy(), host_s)
    np.testing.assert_array_equal(s.numpy(), np.where((a >> 7) & 1, 1.0, -1.0))


# Block values agree to float32 rounding, not bit for bit: XLA's and
# PyTorch's float32 log1p differ in the last bit for ~0.3% of ids.
@pytest.mark.parametrize("skip", [0, 3])
def test_lexical_block_matches_jit(skip):
    rows, ids, mask = _rows(5)
    want = np.asarray(J.lexical_block_jit(jnp.asarray(ids), jnp.asarray(mask),
                                          dim=1792, vocab_size=16512,
                                          skip=skip))
    got = T.lexical_block(torch.from_numpy(ids), torch.from_numpy(mask),
                          dim=1792, vocab_size=16512, skip=skip).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if not skip:  # host form: same buckets and signs, float64 weights
        host = T.LexicalHasher(1792, 16512).vectors(rows)
        np.testing.assert_array_equal(
            host, J.LexicalHasher(1792, 16512).vectors(rows))
        np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("skip", [0, 2])
def test_bigram_block_matches_jit(skip):
    rows, ids, mask = _rows(11)
    want = np.asarray(J.bigram_block_jit(jnp.asarray(ids), jnp.asarray(mask),
                                         dim=1024, skip=skip))
    got = T.bigram_block(torch.from_numpy(ids), torch.from_numpy(mask),
                         dim=1024, skip=skip).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert T.bigram_ids(rows) == J.bigram_ids(rows)


@pytest.fixture(scope="module")
def frida_f32():
    """frida-hybrid on its bundled checkpoint, float32, in both packages."""
    spec = ModelRegistry().get_embedding_model("frida-hybrid")
    jemb = J.TPUEmbedder(spec, tokenizer=j_tokenizer(), dtype=jnp.float32,
                         checkpoint=J._bundled_checkpoint("frida-hybrid"))
    temb = T.create_embedder(device="cpu", dtype=torch.float32)
    return jemb, temb


def test_embedder_matches_jax_float32(frida_f32):
    jemb, temb = frida_f32
    texts = [t for t in TEXTS if t]
    ids_j, mask_j = jemb.tokenize_batch(texts)
    ids_t, mask_t = temb.tokenize_batch(texts)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    for fn in ("embed_queries", "embed_documents"):
        want = getattr(jemb, fn)(texts)
        got = getattr(temb, fn)(texts)
        assert got.shape == want.shape == (len(texts), 5120)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_embedder_bf16_close_to_jax():
    """bf16 towers (the shipping dtype): unit vectors agree to 2e-2 — the
    two frameworks round bf16 intermediates at different places; the hashed
    lexical blocks, 85% of the vector's weight, are exact."""
    spec = ModelRegistry().get_embedding_model("frida-hybrid")
    jemb = J.TPUEmbedder(spec, tokenizer=j_tokenizer(),
                         checkpoint=J._bundled_checkpoint("frida-hybrid"))
    temb = T.create_embedder(device="cpu")
    texts = [t for t in TEXTS if t]
    np.testing.assert_allclose(temb.embed_queries(texts),
                               jemb.embed_queries(texts), atol=2e-2, rtol=0)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.create_embedder()


def test_create_embedder_refuses_a_missing_checkpoint(monkeypatch):
    """No silent random tower: a slug whose checkpoint is absent raises."""
    monkeypatch.setattr(T, "_bundled_checkpoint", lambda slug: None)
    with pytest.raises(ValueError, match="no checkpoint"):
        T.create_embedder(device="cpu")


def test_embed_query_matches_jax(frida_f32):
    """``embed_query`` (the reference's Embedder protocol) is the first row
    of ``embed_queries``, as in JAX, and agrees with JAX's."""
    jemb, temb = frida_f32
    for text in [t for t in TEXTS if t][:3]:
        got = temb.embed_query(text)
        assert got.shape == (5120,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, temb.embed_queries([text])[0])
        np.testing.assert_allclose(got, jemb.embed_query(text), atol=1e-4,
                                   rtol=0)
