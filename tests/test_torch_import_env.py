"""The card's machine has torch, numpy and the standard library, and no jax,
pydantic or yaml. This stands in for it: a subprocess whose import system
refuses jax, jaxlib, pydantic, yaml and cmw_rag_tpu imports every module of
cmw_rag_tpu_torch and chip_smoke, answers a query with a tiny CPU
FusedPipeline, and one through the Retriever over a TorchVectorStore with a
qwen3-arch embedder and LLM reranker on their flash route, over a flat and
then a segmented (IVF) store, and serves a JSON and an SSE chat through the
local LLM transport over the paged engine's loop (kernel route, the twins
on the CPU), then an int8-KV engine with chunked prefill, then an
int8-weight engine on the decoder-layer megakernel's twin, then trains a
tiny qwen3 embedder on its flash route (both directions on the twins) and
runs ``scripts/train_embedder.py`` end to end on a two-pair dataset, then
generates the judged eval's dataset and runs ``evaluate_retrieval`` (chunks,
rerank, sibling expansion) and ``scripts/eval_retrieval.py`` on a slice of
it."""

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

    seg = TorchVectorStore(dim=32, kind="segmented", block_n=2,
                           seal_threshold=2, device="cpu")
    seg.add(texts, [{{"kbId": str(100 + i)}} for i in range(3)],
            ["c%d" % i for i in range(3)], qemb.embed_documents(texts))
    assert len(seg.index.sealed) == 1 and seg.index.fresh.n_live == 1
    arts = R.Retriever(qemb, seg, qrr, rerank_score_threshold=-10.0
                       ).retrieve("database backup", top_k=2)
    assert len(arts) == 2 and arts[0].score >= arts[1].score, arts
    import json
    from cmw_rag_tpu_torch.config import GuardModelSpec
    from cmw_rag_tpu_torch.llm.local_transport import create_local_llm_transport

    llm = create_local_llm_transport(
        spec=GuardModelSpec(slug="tiny-lm", arch="qwen3", d_model=32,
                            d_ff=64, num_layers=1, num_heads=2,
                            num_kv_heads=1, head_dim=16),
        max_len=128, page_size=16, dtype=torch.float32,
        continuous_batching=True, use_kernel=True, device="cpu")
    try:
        for stream in (False, True):
            resp = llm.transport("u", json.dumps({{
                "messages": [{{"role": "user", "content": "привет"}}],
                "max_tokens": 4, "stream": stream}}).encode(), {{}}, 10.0,
                stream)
            raw = b"".join(resp) if stream else resp.read()
            if stream:
                assert raw.rstrip().endswith(b"data: [DONE]"), raw
            else:
                assert json.loads(raw)["usage"]["completion_tokens"] > 0, raw
    finally:
        llm.engine_loop.stop()
    eng = llm.engine_loop.engine
    assert eng.use_kernel and eng.scatter_fused and eng.decode_steps > 0
    from cmw_rag_tpu_torch.models.engine import PagedLLMEngine
    int8 = PagedLLMEngine(llm.params, llm.cfg, eng.tokenizer, max_slots=2,
                          page_size=16, max_ctx=128, kv_dtype="int8",
                          prefill_chunk=32, use_kernel=True, device="cpu")
    assert int8.generate(["привет", "hello"], max_new_tokens=3)
    w8 = PagedLLMEngine(llm.params, llm.cfg, eng.tokenizer, max_slots=2,
                        page_size=16, max_ctx=128, weights="int8",
                        use_kernel=True, device="cpu")
    assert w8.layer_fused and w8.attn_slot
    assert w8.generate(["привет", "hello"], max_new_tokens=3)

    import contextlib, io, os, tempfile
    import numpy as np
    from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
    from cmw_rag_tpu_torch.scripts import train_embedder
    from cmw_rag_tpu_torch.training import ContrastiveTrainer
    trainer = ContrastiveTrainer(
        Qwen3Config(vocab_size=16512, d_model=32, d_ff=64, num_layers=1,
                    num_heads=2, num_kv_heads=1, head_dim=16,
                    dtype=torch.float32),
        learning_rate=1e-3, max_tokens=64, pooling="last_token",
        arch="qwen3", use_flash=True, flash_block=32, device="cpu")
    flash_calls.clear()
    pairs = [("backup", "backup the database nightly"),
             ("printer", "printer queue setup")]
    losses = trainer.train(pairs, batch_size=2, epochs=2)
    assert len(losses) == 2 and np.isfinite(losses).all(), losses
    assert len(flash_calls) == 4, flash_calls  # 2 steps x 2 towers x 1 layer
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds.json")
        with open(ds, "w", encoding="utf-8") as f:
            json.dump({{"corpus": [{{"kb_id": str(i), "title": "t",
                                   "content": d}}
                                  for i, (_, d) in enumerate(pairs)],
                       "queries": [{{"query": q, "judgments": {{str(i): 2}}}}
                                   for i, (q, _) in enumerate(pairs)]}}, f)
        out = os.path.join(tmp, "ckpt.npz")
        with contextlib.redirect_stdout(io.StringIO()) as said:
            assert train_embedder.main([
                "--dataset", ds, "--model", "qwen3-mini", "--use-flash",
                "--max-tokens", "64", "--batch-size", "2", "--epochs", "1",
                "--fp32", "--device", "cpu", "--out", out]) == 0
        assert "checkpoint saved" in said.getvalue()
        assert os.path.getsize(out) > 0

    from cmw_rag_tpu_torch.eval.corpus_gen import generate_corpus
    from cmw_rag_tpu_torch.eval.dataset import dataset_fingerprint, save_dataset
    from cmw_rag_tpu_torch.eval.judged_queries import build_judged_dataset
    from cmw_rag_tpu_torch.eval.runner import evaluate_retrieval
    from cmw_rag_tpu_torch.retrieval.siblings import SiblingIndex
    from cmw_rag_tpu_torch.scripts import eval_retrieval
    ds = build_judged_dataset(generate_corpus())
    assert dataset_fingerprint(ds) == "2b4c73b23aac7cf6"
    small = {{"queries": ds["queries"][:4], "corpus": ds["corpus"][:40]}}
    sib = SiblingIndex()
    for c in small["corpus"]:
        sib.add(c["kb_id"], c["tags"])
    res = evaluate_retrieval(emb, small, reranker=rr, pre_rerank_k=6,
                             chunk_tokens=64, sibling_index=sib,
                             sibling_slots=2, sibling_anchors=2,
                             current_version="v6", device="cpu")
    assert res["n_queries"] == 4 and res["n_chunks"] > 40, res
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.json")
        save_dataset(small, path)
        out = os.path.join(tmp, "eval.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert eval_retrieval.main([
                "--dataset", path, "--model", "frida-mini", "--k", "5",
                "--device", "cpu", "--out", out]) == 0
        with open(out, encoding="utf-8") as f:
            assert json.load(f)["random"]["n_queries"] == 4
        assert sorted(os.listdir(tmp)) == ["eval.json", "small.json"]

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
