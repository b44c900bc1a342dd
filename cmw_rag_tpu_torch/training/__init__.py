"""Training (port of ``cmw_rag_tpu/training``): the bi-encoder's contrastive
trainer. The reranker and guard trainers are not ported yet
(``ROADMAP.md`` Queue 1 item 7)."""

from cmw_rag_tpu_torch.training.contrastive import (
    ContrastiveTrainer,
    info_nce_loss,
    make_train_step,
)

__all__ = ["ContrastiveTrainer", "info_nce_loss", "make_train_step"]
