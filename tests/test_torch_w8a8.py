"""The port's W8A8 matmul (cmw_rag_tpu_torch.ops.int8_matmul:
``quantize_activations``, ``int8_matmul_w8a8``) on the CPU against the JAX
package's (``cmw_rag_tpu/ops/int8_matmul.py:105-171``).

- ``quantize_activations`` is held bit for bit to JAX's, called as the JAX
  source reads (a division by 127 and by the row scale, round half to
  even), in float32 and bf16.
- The golden ``int8_matmul_w8a8_xla`` is held bit for bit to JAX's golden:
  the int8 x int8 sums are exact in both, and the two scales multiply in
  the same order.
- The wrapper's CPU route (the twin of the CUDA kernel: ``float(acc) ·
  scale[n]`` in the kernel body, ``· x_scale[m]`` after it) against the JAX
  Pallas kernel in interpret mode. Under ``jit`` XLA turns the ``/ 127.0``
  of the activation scale into a product with the float32 reciprocal,
  which moves that scale by one float32 step on some rows and can move an
  int8 activation by one where ``x / scale`` lands within a step of a half.
  So the activations may differ by one in at most 0.1% of places, and each
  output within 4 float32 steps (relative 5e-7; bf16 outputs one bf16
  step, 8e-3) plus, for each differing activation of its row, that row's
  scale times 127 times the column's scale (the most one step of an
  activation can move it). Called as the JAX source reads, without XLA's
  rewrite, the twin's order is exact (``test_twin_keeps_the_kernel_order``:
  JAX's kernel body and epilogue, eagerly).
- The activation scale is an IEEE division by 127 on every device (the
  CUDA kernel's), and the CUDA kernel's host-side sizing: the split of the
  contraction and the blocks at phase 10's shapes, the fragments of an m
  tile and the workspace of a split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import int8_matmul as J
from cmw_rag_tpu_torch.ops import int8_matmul as T

SHAPES = {"qkv": (4, 256, 512), "down": (16, 384, 128), "head": (3, 128, 640)}


def _case(name, dtype="float32", seed=0):
    m, k, n = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[1, :] *= 1e-3                       # a row with a small scale
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    wq, ws = J.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jx, wq, ws), (tx, torch.from_numpy(np.array(wq)),
                          torch.from_numpy(np.array(ws)))


def _np(a):
    return np.asarray(a.float() if a.dtype == torch.bfloat16 else a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_is_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    x[2] = 0.0                                   # an all-zero row: 1e-8
    x[3, :4] = [127.0, 0.5, 1.5, -2.5]           # exact halves after / scale
    jq, js = J.quantize_activations(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = T.quantize_activations(torch.from_numpy(x).to(
        getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_golden_is_bit_equal_to_jax(name):
    (jx, wq, ws), (tx, twq, tws) = _case(name)
    np.testing.assert_array_equal(
        T.int8_matmul_w8a8_xla(tx, twq, tws).numpy(),
        np.asarray(J.int8_matmul_w8a8_xla(jx, wq, ws)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_twin_matches_jax_kernel(name, dtype):
    (jx, wq, ws), (tx, twq, tws) = _case(name, dtype)
    got = T.int8_matmul_w8a8(tx, twq, tws)          # CPU: the twin
    tq, tsx = T.quantize_activations(tx)
    jq = np.asarray(jax.jit(J.quantize_activations)(jx)[0]).astype(np.int64)
    flips = np.abs(tq.numpy().astype(np.int64) - jq)
    assert flips.max() <= 1 and flips.mean() <= 1e-3
    moved = (flips.sum(axis=1)[:, None] * tsx.numpy()[:, None] * 127.0
             * np.asarray(ws)[None, :])
    rtol = 5e-7 if dtype == "float32" else 8e-3
    for want in (J.int8_matmul_w8a8(jx, wq, ws, block_n=128, interpret=True),
                 J.int8_matmul_w8a8_xla(jx, wq, ws)):
        assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
        want = np.asarray(want, np.float32)
        err = np.abs(_np(got) - want)
        assert (err <= rtol * np.abs(want) + moved).all(), err.max()


def test_twin_keeps_the_kernel_order():
    """JAX's kernel body and its epilogue, run eagerly (the source's
    arithmetic without XLA's rewrite), give the twin bit for bit."""
    (jx, wq, ws), (tx, twq, tws) = _case("qkv")
    xq, sx = J.quantize_activations(jx)
    acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    body = acc.astype(jnp.float32) * ws[None, :]        # _w8a8_kernel :126
    want = np.asarray(body * sx[:, None])               # :171
    np.testing.assert_array_equal(T.int8_matmul_w8a8_plain(tx, twq, tws)
                                  .numpy(), want)


def test_sums_are_exact_at_the_largest_contraction():
    """3,072 products of ±127 (the down projection of qwen3guard-0.6b):
    float64 holds every int32 sum exactly, so the twin's accumulator is the
    integer one."""
    k = 3072
    xq = torch.full((2, k), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    w = torch.full((k, 16), 127, dtype=torch.int8)
    acc = T._w8a8_acc(xq, w)
    exact = (xq.long() @ w.long()).float()
    assert torch.equal(acc, exact) and acc[0, 0].item() == k * 127 * 127


def test_quantize_activations_divides_by_127():
    """The activation scale is an IEEE float32 division by 127, as the JAX
    source reads and as the CUDA kernel computes it, not a product with the
    float32 reciprocal (which PyTorch's CUDA division by a Python number
    is): on rows where the two differ, the twin's scale is numpy's
    float32 quotient."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((512, 64)).astype(np.float32) * 3.0
    absmax = np.abs(x).max(axis=1)
    quotient = absmax / np.float32(127.0)
    product = absmax * (np.float32(1.0) / np.float32(127.0))
    assert (quotient != product).any()          # the case exists
    _, scale = T.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(scale.numpy(), quotient)


@pytest.mark.parametrize("m,k,n,want", [
    (4, 1024, 4096, 4),       # fused QKV at 4 slots: 32 tiles x 4 splits
    (4, 2048, 1024, 16),      # wo: 8 tiles, 32 stages
    (4, 1024, 6144, 8),       # gate-up: 48 tiles
    (4, 3072, 1024, 16),      # down: 8 tiles, 48 stages
    (4, 1024, 151680, 1),     # the head: 1,185 tiles, no split
    (16, 1024, 4096, 4),      # 16 slots: the same tiles
    (33, 128, 512, 2),        # two m tiles
    (1, 64, 16, 1)])          # one stage
def test_w8a8_plan_splits_and_blocks(m, k, n, want):
    """The W8A8 kernel's work sizing for 132 SMs of 4 resident blocks: the
    split at phase 10's shapes, every split a whole number of 64-row stages
    and the blocks never more than the items or the card holds."""
    ks, grid = T.w8a8_plan(m, k, n, 132, 4)
    assert ks == want
    tiles = -(-m // (8 * T.w8a8_frags(m))) * -(-n // T.W8A8_COLS)
    assert 1 <= ks <= k // T.W8A8_STAGE_ROWS
    assert grid == min(tiles * ks, 132 * 4)


@pytest.mark.parametrize("m,frags", [(1, 1), (8, 1), (9, 2), (16, 2),
                                     (17, 4), (32, 4), (33, 4), (200, 4)])
def test_w8a8_frags_and_workspace(m, frags):
    """Fragments of 8 rows an m tile takes, and the workspace a split
    needs: one 8F x 128 int32 partial tile a split and tile, one counter a
    tile, nothing with one split."""
    assert T.w8a8_frags(m) == frags
    assert T.w8a8_workspace(m, 1040, 1) == (0, 0)
    tiles = -(-m // (8 * frags)) * 9               # 1040 columns: 9 tiles
    assert T.w8a8_workspace(m, 1040, 3) == (tiles * 3 * 8 * frags * 128,
                                            tiles)
