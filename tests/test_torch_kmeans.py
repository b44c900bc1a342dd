"""The port's spherical k-means (cmw_rag_tpu_torch.ops.kmeans) against the
JAX package's ``kmeans_fit`` on the same rows and the same initial draw.

JAX draws its initial centroids with ``jax.random.choice``, which PyTorch
cannot reproduce; the port takes the indices JAX draws through
``init_idx``. From there both run the same float32 steps: centroids agree
to 1e-5 (sums taken in another order) and, on separated clusters (no row
near two centroids), the assignments are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops.kmeans import kmeans_fit as jax_kmeans
from cmw_rag_tpu_torch.ops.kmeans import init_indices, kmeans_fit


def _clustered(n_clusters=8, per=64, d=32, seed=0, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = []
    for c in centers:
        pts = c + spread * rng.standard_normal((per, d)).astype(np.float32)
        rows.append(pts / np.linalg.norm(pts, axis=1, keepdims=True))
    return np.concatenate(rows)


def jax_init(n, nlist, seed):
    """The initial centroid rows JAX's ``kmeans_fit`` draws."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                       (nlist,), replace=n < nlist))


@pytest.mark.parametrize("nlist,iters,seed,chunk", [
    (8, 10, 0, 65536), (16, 5, 3, 65536), (8, 10, 1, 100), (12, 0, 2, 65536)])
def test_kmeans_matches_jax_given_its_init(nlist, iters, seed, chunk):
    data = _clustered(n_clusters=8, per=61, seed=seed)     # 488 rows
    jc, ja = jax_kmeans(jnp.asarray(data), nlist=nlist, iters=iters,
                        chunk=chunk, seed=seed)
    tc, ta = kmeans_fit(torch.from_numpy(data), nlist=nlist, iters=iters,
                        chunk=chunk, init_idx=jax_init(len(data), nlist, seed))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.dtype == torch.int32 and tc.dtype == torch.float32


def test_kmeans_recovers_clusters():
    data = _clustered()
    cents, assign = kmeans_fit(torch.from_numpy(data), nlist=8, iters=15)
    assign = assign.numpy()
    purity = sum(np.bincount(assign[g * 64 : (g + 1) * 64], minlength=8).max()
                 for g in range(8))
    assert purity / len(data) > 0.9
    np.testing.assert_allclose(cents.norm(dim=1).numpy(), 1.0, atol=1e-4)


def test_kmeans_empty_cluster_keeps_its_centroid():
    data = np.ones((16, 8), np.float32) / np.sqrt(8)     # all identical
    cents, assign = kmeans_fit(torch.from_numpy(data), nlist=4, iters=3)
    assert torch.isfinite(cents).all()
    assert (assign == assign[0]).all()
    # three clusters stay empty: their centroids are the initial rows
    np.testing.assert_allclose(cents.numpy(), data[:4], atol=1e-6)
    jc, ja = jax_kmeans(jnp.asarray(data), nlist=4, iters=3)
    np.testing.assert_allclose(cents.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))


def test_default_init_is_seeded_and_draws_like_jax():
    """Distinct rows unless there are fewer rows than centroids; the same
    seed draws the same rows (but not JAX's rows)."""
    a = init_indices(100, 10, seed=5, device="cpu")
    assert torch.equal(a, init_indices(100, 10, seed=5, device="cpu"))
    assert len(set(a.tolist())) == 10 and (a < 100).all()
    b = init_indices(4, 10, seed=5, device="cpu")
    assert b.shape == (10,) and (b < 4).all()
    data = torch.from_numpy(_clustered())
    c1, a1 = kmeans_fit(data, nlist=8, seed=7)
    c2, a2 = kmeans_fit(data, nlist=8, seed=7)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
