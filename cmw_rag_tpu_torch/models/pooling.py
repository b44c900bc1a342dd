"""Sentence-embedding pooling + L2 norm (port of ``cmw_rag_tpu/models/pooling.py``)."""

from __future__ import annotations

import torch


def pool_hidden(hidden: torch.Tensor, attention_mask: torch.Tensor,
                method: str = "cls", normalize: bool = True) -> torch.Tensor:
    """hidden: [B, L, D]; attention_mask: [B, L] (1 = real) → [B, D] float32."""
    h = hidden.float()
    m = attention_mask.float()
    if method == "cls":
        pooled = h[:, 0, :]
    elif method == "last_token":
        last = (attention_mask.sum(dim=1) - 1).clamp(min=0).long()
        pooled = h[torch.arange(h.shape[0], device=h.device), last]
    elif method == "mean":
        pooled = (h * m[:, :, None]).sum(dim=1) / m.sum(
            dim=1, keepdim=True).clamp(min=1.0)
    else:
        raise ValueError(f"unknown pooling: {method!r}")
    if normalize:
        pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return pooled
