"""The long-context retrieval path, as ``chip_smoke.py`` drives it.

Models: ``qwen3-embedding-0.6b`` and ``qwen3-reranker-0.6b``
(``cmw_rag_tpu/config/models.yaml:102-117,155-173``) at full width and depth
(d 1024, 28 layers, 16 query and 8 KV heads of 128, vocabulary 151,680), bf16,
with random weights from seeded CPU generators: the repository has no
converted checkpoint of either, so this is a shape and agreement run, not a
quality one.

Corpus: a fixed list of the repository's markdown (``CORPUS_FILES``: the
design notes and analyses, the survey and the parity notes, the test
fixtures; files that change with the code's own records are left out, so
that two trees read identical rows), read as text by path, cut with the
port's tokenizer into windows of ``Settings.chunk_size`` (768) tokens
overlapping by ``chunk_overlap`` (75), the reference's production chunking
(``cmw_rag_tpu/config/settings.py:63-64``), one kbId and title per file. The
list gives about 85 such windows, so passes at staggered starting offsets
are taken until there are ``N_CHUNKS``. Every chunk and every
(query, chunk) pair lands in the 1024-token bucket, where both models take
the flash attention kernel on a card.

Retrieval: ``Retriever`` over a ``TorchVectorStore`` with the shipping
retrieval shape (``config.Settings``: top_k_retrieve 20, cap 60, rerank
window 20, threshold 0.5, top_k 10) and the reranker's z blend with the
version prior.
"""

from __future__ import annotations

from pathlib import Path

from cmw_rag_tpu_torch.config import Settings, get_embedding_model, get_reranker
from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore
from cmw_rag_tpu_torch.retrieval.embedder import TorchEmbedder
from cmw_rag_tpu_torch.retrieval.reranker import TorchReranker
from cmw_rag_tpu_torch.retrieval.retriever import Retriever

EMBEDDER = "qwen3-embedding-0.6b"
RERANKER = "qwen3-reranker-0.6b"
N_CHUNKS = 512
KB_BASE = 9000
QUERIES = [
    "How is the exact scan top-k kernel built and loaded on the card?",
    "What does the flash attention kernel replace and what bounds it?",
    "How are the reranker ensemble members blended into one score?",
    "Как настроить инкрементальную переиндексацию базы знаний?",
    "Which retrieval settings does the shipping configuration use?",
    "Which TPU kernels are still to be ported to Hopper?",
    "How does the judged evaluation compute ndcg@10 and recall?",
    "Где хранятся чекпоинты моделей и как их загрузить?",
]


CORPUS_FILES = (
    "docs/TESTING.md",
    "docs/architecture.md",
    "docs/deployment.md",
    "docs/analysis/20260818-decode-teardown.md",
    "docs/analysis/20260819-hybrid-retrieval.md",
    "docs/analysis/20260819-recall-structure.md",
    "docs/analysis/20260820-r5-operating-point.md",
    "SURVEY.md",
    "PAPER.md",
    "PARITY.md",
    "VERDICT.md",
    "tests/fixtures/kb_4101_workflows.md",
    "tests/fixtures/kb_4102_индексация.md",
)


def markdown_files(root: Path) -> list[Path]:
    """The corpus files, in ``CORPUS_FILES`` order."""
    return [root / name for name in CORPUS_FILES]


def window_chunks(root: Path, tokenizer, n_chunks: int = N_CHUNKS,
                  passes: int = 8):
    """→ (texts, metadatas, ids) of ``n_chunks`` token windows of the
    corpus files; pass p starts each file's windows at
    p·(size − overlap)/passes tokens."""
    size, overlap = Settings().chunk_size, Settings().chunk_overlap
    files = markdown_files(root)
    tokens = [tokenizer.encode(f.read_text(encoding="utf-8")) for f in files]
    stride = size - overlap
    texts, metas, ids = [], [], []
    for p in range(passes):
        for fi, (path, toks) in enumerate(zip(files, tokens)):
            for start in range(p * stride // passes, len(toks), stride):
                if len(texts) == n_chunks:
                    return texts, metas, ids
                cid = f"{path.relative_to(root)}:{p}:{start}"
                texts.append(tokenizer.decode(toks[start : start + size]))
                metas.append({"kbId": str(KB_BASE + fi), "title": path.name,
                              "source_file": str(path.relative_to(root)),
                              "stable_id": cid})
                ids.append(cid)
    if len(texts) < n_chunks:
        raise ValueError(f"{len(texts)} windows, fewer than {n_chunks}")
    return texts, metas, ids


def build_models(device, embedder_slug: str = EMBEDDER,
                 reranker_slug: str = RERANKER, seed: int = 0):
    """The embedder and the LLM reranker (bf16) with random weights drawn
    from seeded CPU generators, moved to ``device``."""
    settings = Settings(current_product_version="v6")
    emb = TorchEmbedder(get_embedding_model(embedder_slug), seed=seed,
                        device=device)
    rr = TorchReranker(
        get_reranker(reranker_slug), seed=seed + 1, device=device, blend=settings.reranker_blend,
        ce_weight=settings.reranker_ce_weight,
        vector_weight=settings.reranker_vector_weight,
        current_version=settings.current_product_version,
        prior_version_weight=settings.prior_version_weight,
        prior_language_weight=settings.prior_language_weight)
    return emb, rr


def build_store(embedder, texts, metas, ids, vectors) -> TorchVectorStore:
    """A flat store of the chunks and their vectors on the embedder's device."""
    store = TorchVectorStore(dim=embedder.dim, capacity=len(texts),
                             device=embedder.device)
    store.add(texts, metas, ids, vectors)
    return store


def retriever(embedder, store, reranker, root: Path) -> Retriever:
    s = Settings()
    return Retriever(
        embedder, store, reranker, corpus_dir=root,
        top_k_retrieve=s.top_k_retrieve, pre_rerank_limit=s.pre_rerank_limit,
        rerank_article_window=s.rerank_article_window,
        rerank_score_threshold=s.rerank_score_threshold,
        multiquery=s.multiquery_enabled, max_segments=s.max_query_segments,
        segment_tokens=s.query_segment_tokens,
        segment_overlap=s.query_segment_overlap,
        query_decomposition=s.llm_query_decomposition)
