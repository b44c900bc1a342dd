"""The port's chunker (``cmw_rag_tpu_torch/ingest/chunker.py``) against the
JAX package's, each on its own package's default tokenizer.

A seeded sample of 200 generated articles (the judged eval's corpus) and
the fixture knowledge base (``tests/fixtures``, frontmatter included) are
cut at the eval's 128 / 16 and the shipping 768 / 75: ``split_text`` and
``split_text_with_context`` must give the same chunks, string for string;
every chunk of ``split_text`` holds at most ``chunk_size`` tokens.
"""

from pathlib import Path

import numpy as np
import pytest

from cmw_rag_tpu.ingest import chunker as J
from cmw_rag_tpu_torch.eval.corpus_gen import generate_corpus
from cmw_rag_tpu_torch.ingest import chunker as T
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SIZES = [(128, 16), (768, 75)]
N_SAMPLE, BATCH = 200, 25


@pytest.fixture(scope="module")
def sample():
    arts = generate_corpus()
    rng = np.random.default_rng(0)
    return [arts[int(i)].body
            for i in rng.choice(len(arts), N_SAMPLE, replace=False)]


@pytest.mark.parametrize("size,overlap", SIZES)
@pytest.mark.parametrize("batch", range(N_SAMPLE // BATCH))
def test_generated_articles_chunk_as_jax(sample, size, overlap, batch):
    tok = get_tokenizer()
    for text in sample[batch * BATCH:(batch + 1) * BATCH]:
        got = T.split_text_with_context(text, size, overlap)
        assert got == J.split_text_with_context(text, size, overlap)
        plain = T.split_text(text, size, overlap)
        assert plain == J.split_text(text, size, overlap)
        assert plain and all(tok.count(c) <= size for c in plain)


@pytest.mark.parametrize("size,overlap", SIZES)
@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.md")))
def test_fixture_files_chunk_as_jax(name, size, overlap):
    text = (FIXTURES / name).read_text(encoding="utf-8")
    assert T.split_text_with_context(text, size, overlap) == \
        J.split_text_with_context(text, size, overlap)
    assert T.split_text(text, size, overlap) == J.split_text(text, size,
                                                            overlap)


@pytest.mark.parametrize("text", [
    "", "   \n\n ", "word " * 700, "# Title\n\n" + "x" * 5000,
    "a\tb\t" * 400, "```\ncode\n```\n\n## Section\n\n" + "строка " * 500])
def test_edge_texts_chunk_as_jax(text):
    for size, overlap in SIZES + [(32, 4)]:
        assert T.split_text_with_context(text, size, overlap) == \
            J.split_text_with_context(text, size, overlap)


def test_overlap_refused_as_jax():
    with pytest.raises(ValueError):
        J.split_text("x", 16, 16)
    with pytest.raises(ValueError):
        T.split_text("x", 16, 16)
