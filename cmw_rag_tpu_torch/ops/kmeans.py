"""Spherical k-means, the IVF coarse quantiser's trainer (port of
``cmw_rag_tpu/ops/kmeans.py:20-74``).

Each of ``iters`` steps assigns every row to its most similar centroid (a
float32 ``matmul`` and ``argmax`` over chunks of rows, so the [N, nlist]
similarity matrix is never whole), sums the rows of each cluster
(``index_add_``), divides by ``max(count, 1)`` and normalises; an empty
cluster keeps its previous centroid. A last pass assigns every row to the
final centroids. This is plain tensor code in the JAX package too (XLA, not
a Pallas kernel).

Initialisation differs: JAX draws the initial centroids with
``jax.random.choice(PRNGKey(seed), n, (nlist,), replace=n < nlist)``, a
stream PyTorch cannot reproduce. Here the indices come from a
``torch.Generator`` seeded with ``seed``, so a build with the same seed
clusters differently in the two packages. ``init_idx`` hands the indices in
explicitly, so that a test can give both the same draw.
"""

from __future__ import annotations

from typing import Optional

import torch


def _assign(corpus: torch.Tensor, centroids: torch.Tensor, chunk: int):
    """Index of the most similar centroid of every row (first on ties)."""
    out = torch.empty((corpus.shape[0],), dtype=torch.int64,
                      device=corpus.device)
    for a in range(0, corpus.shape[0], chunk):
        rows = corpus[a : a + chunk].float()
        out[a : a + chunk] = torch.argmax(rows @ centroids.T, dim=1)
    return out


def init_indices(n: int, nlist: int, seed: int, device) -> torch.Tensor:
    """``nlist`` row indices drawn from a generator seeded with ``seed``:
    without replacement unless ``n < nlist``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if n < nlist:
        idx = torch.randint(0, n, (nlist,), generator=gen)
    else:
        idx = torch.randperm(n, generator=gen)[:nlist]
    return idx.to(device)


def kmeans_fit(corpus: torch.Tensor, nlist: int, iters: int = 10,
               chunk: int = 65536, seed: int = 0,
               init_idx: Optional[torch.Tensor] = None):
    """Unit-normalised rows [N, D] (any float dtype) → (centroids [nlist, D]
    float32 unit-normalised, assign [N] int32)."""
    n, d = corpus.shape
    chunk = min(chunk, n)
    if init_idx is None:
        init_idx = init_indices(n, nlist, seed, corpus.device)
    init_idx = torch.as_tensor(init_idx, dtype=torch.int64,
                               device=corpus.device)
    centroids = corpus[init_idx].float()
    for _ in range(iters):
        sums = torch.zeros((nlist, d), dtype=torch.float32,
                           device=corpus.device)
        counts = torch.zeros((nlist,), dtype=torch.float32,
                             device=corpus.device)
        for a in range(0, n, chunk):
            rows = corpus[a : a + chunk].float()
            assign = torch.argmax(rows @ centroids.T, dim=1)
            sums.index_add_(0, assign, rows)
            counts.index_add_(0, assign, torch.ones_like(assign,
                                                         dtype=torch.float32))
        new = sums / counts.clamp(min=1.0)[:, None]
        new = new / new.norm(dim=1, keepdim=True).clamp(min=1e-12)
        centroids = torch.where((counts > 0)[:, None], new, centroids)
    return centroids, _assign(corpus, centroids, chunk).to(torch.int32)
