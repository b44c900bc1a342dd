from cmw_rag_tpu_torch.eval.metrics import judged_avg_score, ndcg_at_k, recall_at_k

__all__ = ["recall_at_k", "ndcg_at_k", "judged_avg_score"]
