"""The IVF retrieval path at full size on the card, as ``chip_smoke.py``
drives it (phases 6 and 7).

``clustered_corpus``: 1,000,000 rows of 1024 (the width of
``qwen3-embedding-0.6b``; a 1M-chunk index is ``BASELINE.json`` config 4),
made on the card from a seeded ``torch.Generator``: 4,096 random unit
centres and per-row Gaussian noise, normalised and rounded to bf16. 8 rows
are copied to 2 other slots each (exact ties), and 1% of the other rows are
tombstones (id -1). Queries are rows of the corpus with noise added, the
first 8 being the copied rows themselves. ``IVFIndex.build`` with
``block_n`` 1024 and the default ``nlist`` (n // block_n) lays it out.

``SegmentedPath``: the shipping ``frida-hybrid`` embedder (5120-d) and the
4-member rerank ensemble on their bundled checkpoints, and a ``Retriever``
over ``TorchVectorStore(kind="segmented")`` with the ``SegmentedIndex``
defaults (``block_n`` 1024, ``seal_threshold`` 100,000 rounded up to
100,352, ``fresh_capacity`` 8192, ``nprobe`` 64, synchronous seals), the
store the serving app builds for ``index_kind = "ivf"``. Its rows, 250,000
added in batches of 8,192: the checkout's markdown (``long_context``'s
``CORPUS_FILES``) in 192-token chunks at the front, the 8 planted texts of
``shipping.PLANTED_TEXTS`` at ``PLANTED_POS`` (three in each sealed segment,
two in the tail), and seeded random unit filler rows around them. The same
rows also go into an exact ``FlatIndex``, the yardstick of the IVF stage.
"""

from __future__ import annotations

import numpy as np
import torch

N_ROWS = 1_000_000
DIM = 1024
N_CENTRES = 4096
NOISE = 0.03              # per component: noise norm ~1, cosine to centre ~0.7
BLOCK_N = 1024
NPROBE = 64
N_QUERIES = 32

SEG_ROWS = 250_000
SEG_BATCH = 8192
SEG_CHUNK_TOKENS = 192
#: global row positions of the planted texts: three in each of the two
#: sealed segments (rows < 100,352 and < 200,704), two in the tail
PLANTED_POS = [1_000, 40_000, 90_000, 110_000, 150_000, 199_000, 220_000,
               249_000]
PLANTED_KB = 9100
FILLER_KB = "9999"


def clustered_corpus(seed: int = 2024):
    """→ (rows [N, D] bf16, ids [N] int32 with tombstones, queries
    [N_QUERIES, D] bf16, the 8 tie groups as lists of ids), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn((N_CENTRES, DIM), generator=gen, device="cuda")
    centres /= centres.norm(dim=1, keepdim=True)
    of = torch.randint(0, N_CENTRES, (N_ROWS,), generator=gen, device="cuda")
    rows = torch.empty((N_ROWS, DIM), dtype=torch.bfloat16, device="cuda")
    step = N_ROWS // 8
    for a in range(0, N_ROWS, step):
        x = centres[of[a : a + step]] + NOISE * torch.randn(
            (min(step, N_ROWS - a), DIM), generator=gen, device="cuda")
        rows[a : a + step] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    ids = torch.arange(N_ROWS, dtype=torch.int32, device="cuda")
    ids[torch.rand((N_ROWS,), generator=gen, device="cuda") < 0.01] = -1
    picks = torch.randperm(N_ROWS, generator=gen, device="cuda")[:24].tolist()
    groups = []
    for j in range(8):
        src, copies = picks[3 * j], picks[3 * j + 1 : 3 * j + 3]
        rows[copies] = rows[src].clone()
        group = [src] + copies
        ids[group] = torch.tensor(group, dtype=torch.int32, device="cuda")
        groups.append(sorted(group))
    at = torch.randint(0, N_ROWS, (N_QUERIES,), generator=gen, device="cuda")
    q = rows[at].float() + NOISE * torch.randn((N_QUERIES, DIM), generator=gen,
                                               device="cuda")
    q[:8] = rows[[picks[3 * j] for j in range(8)]].float()
    q /= q.norm(dim=1, keepdim=True)
    return rows, ids, q.to(torch.bfloat16), groups


def markdown_chunks(root, tokenizer):
    """(texts, metadatas) of the corpus files in consecutive windows of
    ``SEG_CHUNK_TOKENS`` tokens, one kbId per file."""
    from cmw_rag_tpu_torch.scripts.long_context import KB_BASE, markdown_files

    texts, metas = [], []
    for fi, path in enumerate(markdown_files(root)):
        toks = tokenizer.encode(path.read_text(encoding="utf-8"))
        for a in range(0, len(toks), SEG_CHUNK_TOKENS):
            texts.append(tokenizer.decode(toks[a : a + SEG_CHUNK_TOKENS]))
            metas.append({"kbId": str(KB_BASE + fi), "title": path.name,
                          "source_file": str(path.relative_to(root)),
                          "stable_id": f"md:{fi}:{a}"})
    return texts, metas


class SegmentedPath:
    """The models, the segmented store, the exact flat yardstick and the
    row bookkeeping of phase 7."""

    def __init__(self, root):
        from cmw_rag_tpu_torch.retrieval.embedder import create_embedder
        from cmw_rag_tpu_torch.retrieval.reranker import create_reranker
        from cmw_rag_tpu_torch.scripts.shipping import PLANTED_TEXTS

        self.root = root
        self.embedder = create_embedder("frida-hybrid", device="cuda")
        self.reranker = create_reranker(device="cuda")
        self.planted = list(PLANTED_TEXTS)
        self.md_texts, self.md_metas = markdown_chunks(root,
                                                       self.embedder.tokenizer)
        self.dim = self.embedder.dim

    def sid(self, pos: int) -> str:
        return f"row{pos}"

    def planted_sid(self, j: int) -> str:
        return self.sid(PLANTED_POS[j])

    def build(self, seed: int = 77):
        """Add ``SEG_ROWS`` rows in batches of ``SEG_BATCH`` to a segmented
        store and to an exact ``FlatIndex``; → (store, flat)."""
        from cmw_rag_tpu_torch.index.flat import FlatIndex
        from cmw_rag_tpu_torch.index.tpu_store import TorchVectorStore

        if len(self.md_texts) >= PLANTED_POS[0]:
            raise ValueError(f"{len(self.md_texts)} markdown chunks overlap "
                             f"the first planted row {PLANTED_POS[0]}")
        real_texts = self.md_texts + self.planted
        real_vecs = self.embedder.embed_documents(real_texts)
        at = {i: i for i in range(len(self.md_texts))}
        at.update({p: len(self.md_texts) + j
                   for j, p in enumerate(PLANTED_POS)})
        store = TorchVectorStore(dim=self.dim, kind="segmented",
                                 device="cuda")
        flat = FlatIndex(dim=self.dim, capacity=SEG_ROWS, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for a in range(0, SEG_ROWS, SEG_BATCH):
            b = min(a + SEG_BATCH, SEG_ROWS)
            x = torch.randn((b - a, self.dim), generator=gen, device="cuda")
            vecs = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
            texts, metas = [], []
            for pos in range(a, b):
                j = at.get(pos)
                if j is None:
                    texts.append(f"filler row {pos}")
                    metas.append({"kbId": FILLER_KB, "stable_id": self.sid(pos)})
                    continue
                vecs[pos - a] = real_vecs[j]
                texts.append(real_texts[j])
                if j < len(self.md_texts):
                    metas.append(dict(self.md_metas[j], stable_id=self.sid(pos)))
                else:
                    k = j - len(self.md_texts)
                    metas.append({"kbId": str(PLANTED_KB + k),
                                  "title": f"planted {k}",
                                  "stable_id": self.sid(pos)})
            sids = [self.sid(pos) for pos in range(a, b)]
            store.add(texts, metas, sids, vecs)
            flat.add(vecs, np.asarray([store._int_by_sid[s] for s in sids],
                                      np.int32))
        return store, flat

    def retriever(self, store):
        from cmw_rag_tpu_torch.scripts.long_context import retriever

        return retriever(self.embedder, store, self.reranker, self.root)
