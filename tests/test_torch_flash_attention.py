"""The port's flash attention (cmw_rag_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernels in interpret mode, on the same inputs.

On the CPU the wrappers run the plain twin, ``flash_attention_plain``, which
repeats the TPU kernel's arithmetic (online softmax over key blocks, -1e30
masking, causal block skip, probabilities rounded to v's dtype before the
value product). Float32 inputs: rtol 2e-3, atol 2e-4, the JAX package's own
flash tolerance (tests/test_flash_attention.py); the two agree far closer,
the difference being float32 sums in another order. bf16 inputs: the output
is bf16, so one rounding step of the output (2^-8 relative) is allowed, and
the LSE, float32 on both sides, to 1e-5. Masks are ragged right padding, so
every query row sees at least one real key, except in the cases at the card
kernel's blocks (``TILES``), whose masks also start past the first tile or
have no real key at all.

The CUDA kernel itself is held against the twin on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import flash_attention as JF
from cmw_rag_tpu_torch.ops import flash_attention as TF

BH, H, L, D, BLOCK = 4, 2, 128, 32, 32


def _case(seed=0, bh=BH, h=H, l=L, d=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, l, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((bh // h, l), np.int32)
    for b in range(1, bh // h):
        mask[b, rng.integers(l // 4, l):] = 0
    return q, k, v, mask


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    """x rounded to bf16, as (jax bf16, torch bf16)."""
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, _t(np.asarray(jx.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_twin_matches_jax_fa_forward(causal):
    q, k, v, mask = _case()
    jo, jl = JF._fa_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask)[:, None, :], H, causal, BLOCK,
                            BLOCK, True)
    to, tl = TF.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), H,
                                      causal, BLOCK, BLOCK)
    assert tl.shape == (BH, L, 1) and tl.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_kernel(causal):
    q, k, v, mask = _case(seed=1)
    want = JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), H, causal, BLOCK, BLOCK, True)
    got = TF.flash_attention(_t(q), _t(k), _t(v), _t(mask), H, causal,
                             BLOCK, BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_inputs_match_jax_fa_forward(causal):
    q, k, v, mask = _case(seed=2)
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    jo, jl = JF._fa_forward(jq, jk, jv, jnp.asarray(mask)[:, None, :], H,
                            causal, BLOCK, BLOCK, True)
    to, tl = TF.flash_attention_fwd(tq, tk, tv, _t(mask), H, causal, BLOCK,
                                    BLOCK)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bhld_adapter_matches_jax(causal):
    rng = np.random.default_rng(3)
    b, l, h, dh = 2, 128, 4, 16
    q, k, v = (rng.standard_normal((b, l, h, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, l), np.int32)
    mask[1, 80:] = 0
    want = JF.flash_attention_bhld(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(mask),
                                   causal=causal, block_q=64, block_k=64,
                                   interpret=True)
    got = TF.flash_attention_bhld(_t(q), _t(k), _t(v), _t(mask),
                                  causal=causal, block_q=64, block_k=64)
    assert got.shape == (b, l, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-4)


def test_block_size_does_not_change_the_function():
    """The kernel tiles by 64, the twin by its block: the result is the
    same function (rows that see a real key are block-independent)."""
    q, k, v, mask = _case(seed=4)
    a = TF.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), H, True, 32,
                                 32)
    b = TF.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), H, True, 64,
                                 128)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_rejects_length_not_a_multiple_of_the_block():
    q, k, v, mask = _case(l=100)
    with pytest.raises(ValueError, match="multiple"):
        TF.flash_attention_fwd(_t(q), _t(k), _t(v), _t(mask), H, False, 64,
                               64)
    with pytest.raises(ValueError, match="multiple"):
        JF._fa_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask)[:, None, :], H, False, 64, 64, True)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    q, k, v, mask = _case(seed=5)
    before = TF.total_launches()
    o, lse = TF.flash_attention_fwd(_t(q), _t(k), _t(v), _t(mask), H, True,
                                    BLOCK, BLOCK)
    want = TF.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask), H, True,
                                    BLOCK, BLOCK)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert TF.total_launches() == before


def _tile_case(d, seed):
    """bf16 q, k, v [8, 384, d] (B 4, H 2, three of the kernel's 128-row
    tiles) and masks: every key real; an end inside the second tile;
    leading zeros past tile 0 and an end inside the third; no real key."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((8, 384, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((4, 384), np.int32)
    mask[1, 200:] = 0
    mask[2, :150] = 0
    mask[2, 300:] = 0
    mask[3] = 0
    return _bf16(q), _bf16(k), _bf16(v), mask


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lse", [True, False])
def test_twin_at_kernel_tiles_matches_jax(d, causal, lse):
    """The twin over the card kernel's blocks (``TILES``: 128 query rows,
    64-key softmax blocks) against the TPU kernel run with the same blocks:
    ``_fa_forward`` (with the LSE)
    and ``flash_attention``, at L of three tiles, with masks whose rows end
    inside a tile, start past tile 0 or have no real key (p = 1 over every
    processed key in both). The function the card kernel must reproduce."""
    (jq, tq), (jk, tk), (jv, tv), mask = _tile_case(d, seed=10 + d + causal)
    h, (bq, bk) = 2, TF.TILES
    if lse:
        jo, jl = JF._fa_forward(jq, jk, jv, jnp.asarray(mask)[:, None, :], h,
                                causal, bq, bk, True)
        to, tl = TF.flash_attention_fwd(tq, tk, tv, _t(mask), h, causal, bq,
                                        bk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
    else:
        jo = JF.flash_attention(jq, jk, jv, jnp.asarray(mask), h, causal, bq,
                                bk, True)
        to = TF.flash_attention(tq, tk, tv, _t(mask), h, causal, bq, bk)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


def test_causal_first_row_attends_to_itself_only():
    q, k, v, mask = _case(seed=6)
    o = TF.flash_attention(_t(q), _t(k), _t(v), _t(mask), H, True, BLOCK,
                           BLOCK)
    np.testing.assert_allclose(o[:, 0].numpy(), v[:, 0], rtol=1e-6, atol=1e-6)

