"""The shipping query path at full size on the card, as ``chip_smoke.py`` and
``profile_query.py`` drive it.

The configuration is the shipping one (``cmw_rag_tpu/config/settings.py``
:47,58-59,69-72): ``frida-hybrid`` (5120-d) and the 4-member rerank ensemble
on their bundled checkpoints, top_k_retrieve 20, cap 60, rerank 20, top 10,
192-token chunks, rerank microbatch 32. The corpus is 1,000,000 random unit
rows with random chunk tokens, made on the card a slice at a time (one
float32 draw would be a 20 GB transient), in which 8 bilingual chunk texts
are planted at known slots, so that each of them, used as a query, has a
known answer.
"""

from __future__ import annotations

import subprocess

import torch

N_ROWS = 1_000_000
DIM = 5120
CHUNK_TOKENS = 192
PIPELINE_KW = dict(top_k_retrieve=20, pre_rerank_limit=60, rerank_keep=20,
                   top_k=10, max_chunk_tokens=CHUNK_TOKENS,
                   rerank_microbatch=32)
# batches of 8 queries timed for a rate: about 6 s at 50 queries/s
TIMED_BATCHES = 40

PLANTED_TEXTS = [
    "Резервное копирование базы данных: откройте раздел «Администрирование», "
    "выберите «Базы данных» и задайте расписание ежедневных копий.",
    "To export a process template, open the workflow designer, choose Export "
    "and save the archive; import it on the target platform the same way.",
    "Ошибка авторизации LDAP: проверьте строку подключения, учётную запись "
    "службы и сертификат сервера каталогов.",
    "Webhooks send a POST request with the record JSON to the configured URL "
    "on every create, update or delete event.",
    "Чтобы настроить печать отчётов, установите драйвер принтера на сервере "
    "приложений и укажите его в параметрах шаблона.",
    "The Kanban board groups records by status; drag a card between columns "
    "to change its state and trigger the linked workflow.",
    "Миграция на новую версию платформы: остановите службу, сделайте копию "
    "базы данных и запустите мастер обновления.",
    "Dashboard widgets read from saved queries; set the refresh interval and "
    "the user roles allowed to see each widget.",
]
PLANTED_SLOTS = [17, 123_457, 250_001, 499_999, 500_000, 777_777, 900_001,
                 N_ROWS - 1]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def fill_unit_rows(n: int, d: int, gen: torch.Generator,
                   slices: int = 16) -> torch.Tensor:
    """[n, d] bf16 unit rows made on the card, a slice at a time."""
    out = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    step = -(-n // slices)
    for a in range(0, n, step):
        b = min(a + step, n)
        rows = torch.randn((b - a, d), generator=gen, device="cuda")
        out[a:b] = (rows / rows.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return out


def quantize_slices(rows: torch.Tensor, slices: int = 16):
    """(int8 rows, f32 scales) of a bf16 corpus, a slice at a time."""
    from cmw_rag_tpu_torch.ops.topk import quantize_rows_int8

    n = rows.shape[0]
    q8 = torch.empty(rows.shape, dtype=torch.int8, device=rows.device)
    scales = torch.empty((n,), dtype=torch.float32, device=rows.device)
    step = -(-n // slices)
    for a in range(0, n, step):
        q8[a : a + step], scales[a : a + step] = quantize_rows_int8(
            rows[a : a + step])
    return q8, scales


class ShippingPath:
    """The models and the corpus's chunk tokens, loaded once; ``pipeline``
    makes the corpus rows and a ``FusedPipeline`` over them."""

    def __init__(self):
        from cmw_rag_tpu_torch.retrieval.embedder import create_embedder
        from cmw_rag_tpu_torch.retrieval.reranker import create_reranker

        self.embedder = emb = create_embedder("frida-hybrid", device="cuda")
        self.reranker = create_reranker(device="cuda")
        if emb.dim != DIM:
            raise AssertionError(f"frida-hybrid dim {emb.dim} != {DIM}")
        self.planted = torch.from_numpy(
            emb.embed_documents(PLANTED_TEXTS)).cuda()
        lc = CHUNK_TOKENS
        gen = torch.Generator(device="cuda").manual_seed(99)
        self.toks = torch.randint(1, emb.tokenizer.n_vocab, (N_ROWS, lc),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
        self.lens = torch.full((N_ROWS,), lc, dtype=torch.int32, device="cuda")
        for slot, text in zip(PLANTED_SLOTS, PLANTED_TEXTS):
            e = emb.tokenizer.encode(text)[:lc]
            self.toks[slot] = 0
            self.toks[slot, : len(e)] = torch.tensor(e, dtype=torch.int32)
            self.lens[slot] = len(e)
        self.ext_ids = torch.arange(N_ROWS, dtype=torch.int32, device="cuda")

    def pipeline(self, quantize: bool):
        """A ``FusedPipeline`` over fresh random rows with the planted texts'
        unit vectors at their slots; int8 rows when ``quantize``."""
        from cmw_rag_tpu_torch.retrieval.fused import FusedPipeline

        rows = fill_unit_rows(N_ROWS, DIM, torch.Generator(
            device="cuda").manual_seed(7))
        p = self.planted
        rows[torch.tensor(PLANTED_SLOTS, device="cuda")] = (
            p / p.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        if quantize:  # the int8 corpus replaces the bf16 rows
            rows = quantize_slices(rows)
        pipe = FusedPipeline(self.embedder, self.reranker, quantize=quantize,
                             **PIPELINE_KW)
        pipe.set_corpus_arrays(rows, self.ext_ids, self.toks, self.lens)
        return pipe
