"""Model specs and retrieval-shape settings of the ported query paths.

Plain dataclasses holding the values of ``cmw_rag_tpu/config/models.yaml``
(``frida-hybrid`` :50-69; ``qwen3-mini`` :86-101; ``qwen3-embedding-0.6b``
:102-117; ``identity``, ``qwen3-reranker-0.6b`` :153-173;
``qwen3-reranker-micro``, ``cross-encoder-micro``, ``cross-encoder-micro-r3``,
``cross-encoder-small-r3`` :193-273) and of ``config/settings.py:47-81,
164-166``. Field names and ``format_*`` methods match the
JAX package's spec classes (``config/registry.py``), so code written against
either reads the same. No yaml, no pydantic: the values are written out.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EmbeddingModelSpec:
    slug: str
    arch: str
    dimensions: int
    max_tokens: int
    pooling: str = "cls"                 # cls | last_token | mean
    normalize: bool = True
    query_prefix: str = ""
    document_prefix: str = ""
    instruction_template: str = ""
    default_task: str = ""
    supported: bool = True
    d_model: int = 0
    d_ff: int = 0
    num_layers: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    vocab_size: int = 0
    lexical_dim: int = 0
    lexical_weight: float = 0.0
    lexical_translit_dim: int = 0
    lexical_translit_weight: float = 0.0
    lexical_bigram_dim: int = 0
    lexical_bigram_weight: float = 0.0
    lexical_word_dim: int = 0
    lexical_word_weight: float = 0.0

    def format_query(self, query: str, task: str | None = None) -> str:
        if self.instruction_template:
            return self.instruction_template.format(
                task=task or self.default_task, query=query)
        return self.query_prefix + query

    def format_document(self, document: str) -> str:
        return self.document_prefix + document


@dataclass(frozen=True)
class RerankerModelSpec:
    slug: str
    kind: str                            # identity | cross_encoder | llm_reranker
    arch: str = ""
    max_tokens: int = 8192
    template_system: str = ""
    template_user: str = ""
    default_instruction: str = ""
    yes_token: str = "yes"
    no_token: str = "no"
    pooling: str = "cls"
    supported: bool = True
    d_model: int = 0
    d_ff: int = 0
    num_layers: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    vocab_size: int = 0

    def format_pair(self, query: str, document: str,
                    instruction: str | None = None) -> str:
        """ChatML pair for ``llm_reranker``; ``query\\ndocument`` otherwise."""
        if self.kind == "llm_reranker":
            user = self.template_user.format(
                instruction=instruction or self.default_instruction,
                query=query, document=document)
            return (
                f"<|im_start|>system\n{self.template_system}<|im_end|>\n"
                f"<|im_start|>user\n{user}<|im_end|>\n"
                f"<|im_start|>assistant\n<think>\n\n</think>\n\n"
            )
        return f"{query}\n{document}"


_MICRO_CE = dict(kind="cross_encoder", arch="t5_encoder", max_tokens=512,
                 pooling="mean", d_model=256, d_ff=768, num_layers=4,
                 num_heads=4, vocab_size=16512)
_SMALL_CE = dict(kind="cross_encoder", arch="t5_encoder", max_tokens=512,
                 pooling="mean", d_model=512, d_ff=1536, num_layers=8,
                 num_heads=8, vocab_size=16512)

_QWEN3_TASK = ("Given a web search query, retrieve relevant passages that "
               "answer the query")
_QWEN3_06B = dict(d_model=1024, d_ff=3072, num_layers=28, num_heads=16,
                  num_kv_heads=8, head_dim=128, vocab_size=151680)

EMBEDDING_MODELS: dict[str, EmbeddingModelSpec] = {
    "qwen3-mini": EmbeddingModelSpec(
        slug="qwen3-mini", arch="qwen3", dimensions=256, max_tokens=512,
        pooling="last_token", normalize=True,
        instruction_template="Instruct: {task}\nQuery: {query}",
        default_task=_QWEN3_TASK, d_model=256, d_ff=768, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=64, vocab_size=16512),
    "qwen3-embedding-0.6b": EmbeddingModelSpec(
        slug="qwen3-embedding-0.6b", arch="qwen3", dimensions=1024,
        max_tokens=8192, pooling="last_token", normalize=True,
        instruction_template="Instruct: {task}\nQuery: {query}",
        default_task=_QWEN3_TASK, **_QWEN3_06B),
    "frida-hybrid": EmbeddingModelSpec(
        slug="frida-hybrid", arch="t5_encoder", dimensions=5120,
        max_tokens=256, pooling="mean", normalize=True,
        query_prefix="search_query: ", document_prefix="search_document: ",
        d_model=256, d_ff=768, num_layers=4, num_heads=4, vocab_size=16512,
        lexical_dim=1792, lexical_weight=0.85,
        lexical_bigram_dim=1024, lexical_bigram_weight=0.3,
        lexical_word_dim=2048, lexical_word_weight=0.5),
}

RERANKERS: dict[str, RerankerModelSpec] = {
    "identity": RerankerModelSpec(slug="identity", kind="identity"),
    "qwen3-reranker-0.6b": RerankerModelSpec(
        slug="qwen3-reranker-0.6b", kind="llm_reranker", arch="qwen3",
        max_tokens=8192,
        template_system=(
            'Judge whether the Document meets the requirements based on the '
            'Query and the Instruct provided. Note that the answer can only '
            'be "yes" or "no".'),
        template_user=("<Instruct>: {instruction}\n<Query>: {query}\n"
                       "<Document>: {document}"),
        default_instruction=_QWEN3_TASK, yes_token="yes", no_token="no",
        **_QWEN3_06B),
    "qwen3-reranker-micro": RerankerModelSpec(
        slug="qwen3-reranker-micro", kind="llm_reranker", arch="qwen3",
        max_tokens=512,
        template_system=('Answer "yes" if the Document answers the Query, '
                         'else "no".'),
        template_user="Query: {query}\nDocument: {document}",
        default_instruction="", yes_token="yes", no_token="no",
        d_model=256, d_ff=768, num_layers=4, num_heads=4, num_kv_heads=2,
        head_dim=64, vocab_size=16512),
    "cross-encoder-micro": RerankerModelSpec(
        slug="cross-encoder-micro", **_MICRO_CE),
    "cross-encoder-micro-r3": RerankerModelSpec(
        slug="cross-encoder-micro-r3", **_MICRO_CE),
    "cross-encoder-small-r3": RerankerModelSpec(
        slug="cross-encoder-small-r3", **_SMALL_CE),
}


def get_embedding_model(slug: str) -> EmbeddingModelSpec:
    try:
        return EMBEDDING_MODELS[slug.lower()]
    except KeyError:
        raise KeyError(f"unknown embedding model: {slug!r} "
                       f"(have: {sorted(EMBEDDING_MODELS)})") from None


def get_reranker(slug: str) -> RerankerModelSpec:
    try:
        return RERANKERS[slug.lower()]
    except KeyError:
        raise KeyError(f"unknown reranker: {slug!r} "
                       f"(have: {sorted(RERANKERS)})") from None


@dataclass(frozen=True)
class Settings:
    """The shipping retrieval shape (``config/settings.py`` defaults)."""

    embedding_model: str = "frida-hybrid"
    reranker_model: str = ("cross-encoder-micro,cross-encoder-micro-r3,"
                           "cross-encoder-small-r3,qwen3-reranker-micro")
    chunk_size: int = 768
    chunk_overlap: int = 75
    top_k_retrieve: int = 20
    top_k: int = 10
    pre_rerank_limit: int = 60
    rerank_article_window: int = 20
    rerank_score_threshold: float = 0.5
    multiquery_enabled: bool = True
    max_query_segments: int = 4
    query_segment_tokens: int = 448
    query_segment_overlap: int = 64
    llm_query_decomposition: bool = False
    reranker_checkpoint: str = ""
    reranker_vector_weight: float = 4.0
    reranker_blend: str = "z"
    reranker_ce_weight: float = 0.35
    current_product_version: str = ""
    prior_version_weight: float = 0.4
    prior_language_weight: float = 0.0
