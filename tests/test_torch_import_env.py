"""The card's machine has torch, numpy and the standard library, and no jax,
pydantic or yaml. This stands in for it: a subprocess whose import system
refuses jax, jaxlib, pydantic, yaml and cmw_rag_tpu imports every module of
cmw_rag_tpu_torch and chip_smoke, answers a query with a tiny CPU
FusedPipeline, and one through the Retriever over a TorchVectorStore with a
qwen3-arch embedder and LLM reranker on their flash route."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cmw_rag_tpu_torch"
REFUSED = ("jax", "jaxlib", "pydantic", "yaml", "cmw_rag_tpu")

CHILD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = {refused!r}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError("refused on the card's machine: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {root!r})
    import cmw_rag_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        cmw_rag_tpu_torch.__path__, "cmw_rag_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    import chip_smoke  # importing runs nothing

    import torch
    from cmw_rag_tpu_torch.config import EmbeddingModelSpec, RerankerModelSpec
    from cmw_rag_tpu_torch.retrieval.embedder import TorchEmbedder
    from cmw_rag_tpu_torch.retrieval.fused import FusedPipeline
    from cmw_rag_tpu_torch.retrieval.reranker import TorchReranker

    emb = TorchEmbedder(EmbeddingModelSpec(
        slug="tiny", arch="t5_encoder", dimensions=64 + 64 + 32 + 32,
        max_tokens=64, pooling="mean", query_prefix="search_query: ",
        document_prefix="search_document: ", d_model=64, d_ff=128,
        num_layers=2, num_heads=2, lexical_dim=64, lexical_weight=0.85,
        lexical_bigram_dim=32, lexical_bigram_weight=0.3,
        lexical_word_dim=32, lexical_word_weight=0.5), device="cpu")
    rr = TorchReranker(RerankerModelSpec(
        slug="tiny-ce", kind="cross_encoder", arch="t5_encoder",
        max_tokens=512, pooling="mean", d_model=64, d_ff=128, num_layers=2,
        num_heads=2), device="cpu", blend="z")
    pipe = FusedPipeline(emb, rr, top_k_retrieve=4, pre_rerank_limit=8,
                         rerank_keep=6, top_k=3, max_chunk_tokens=32,
                         rerank_microbatch=4)
    pipe.build(["backup the database nightly", "printer queue setup",
                "настройка резервного копирования", "export a template",
                "kanban board columns", "webhook retries"])
    out = pipe.query(["database backup", "принтер"])
    assert out["ids"].shape == (2, 3) and (out["ids"] >= 0).all(), out

    from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore
    from cmw_rag_tpu_torch.ops import flash_attention as FA
    from cmw_rag_tpu_torch.retrieval import retriever as R

    twin, flash_calls = FA.flash_attention_plain, []
    FA.flash_attention_plain = lambda *a, **k: (flash_calls.append(1),
                                                twin(*a, **k))[1]

    tiny = dict(d_model=32, d_ff=64, num_layers=1, num_heads=2,
                num_kv_heads=1, head_dim=16)
    qemb = TorchEmbedder(EmbeddingModelSpec(
        slug="tiny-q", arch="qwen3", dimensions=32, max_tokens=2048,
        pooling="last_token", instruction_template="Q: {{task}} {{query}}",
        default_task="find", **tiny), device="cpu")
    qrr = TorchReranker(RerankerModelSpec(
        slug="tiny-rr", kind="llm_reranker", arch="qwen3", max_tokens=2048,
        template_user="{{query}} {{document}}", **tiny), device="cpu", blend="z")
    qemb.flash_min_seq = qrr.flash_min_seq = 1024
    texts = [" ".join([w] * 600) for w in ("backup", "printer", "export")]
    store = TorchVectorStore(dim=32, device="cpu")
    store.add(texts, [{{"kbId": str(100 + i)}} for i in range(3)],
              ["c%d" % i for i in range(3)], qemb.embed_documents(texts))
    arts = R.Retriever(qemb, store, qrr, rerank_score_threshold=-10.0
                       ).retrieve("database backup", top_k=2)
    assert len(arts) == 2 and arts[0].score >= arts[1].score, arts
    assert len(flash_calls) == 2, flash_calls  # documents, then pairs
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print("ok", len(mods))
""")


def test_port_runs_without_jax_pydantic_yaml_or_the_jax_package():
    code = CHILD.format(refused=REFUSED, root=str(ROOT))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT / "tests"),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.split()[0] == "ok"
    assert int(res.stdout.split()[1]) >= 34  # every module was walked


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        text = path.read_text(encoding="utf-8")
        assert "import jax" not in text, path
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in REFUSED, (path, name)
            assert top in {"cmw_rag_tpu_torch", "torch", "numpy", "__future__"} \
                or top in sys.stdlib_module_names, (path, name)
