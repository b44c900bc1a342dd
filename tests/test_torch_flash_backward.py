"""The port's flash attention backward (cmw_rag_tpu_torch.ops.flash_attention)
against ``jax.vjp`` of the JAX package's ``flash_attention_trainable`` with
its Pallas kernels in interpret mode, on the same inputs.

On the CPU ``FlashAttentionTrainable`` runs the plain twins in both
directions: the backward twin keeps the TPU backward's rounding points
(``delta`` from float32 dO and O, p from the forward's log-sum-exp, ds
rounded to K's and Q's dtypes for dQ and dK, p kept in float32 for dV).
Float32 inputs: within 1e-5 (absolute and relative; float32 sums in another
order). bf16 inputs: the gradients are bf16, so one rounding step at the
reference's magnitude is allowed (two float32 sums a hair apart may round
one step apart), plus ``BF16_ABS`` = 1e-6 where a sum cancels to near zero:
terms of up to ~1e-2 summed in another order leave float32 residues of a
few 1e-7 there (a dQ element of -2.0e-7 in JAX came out +2.0e-7, from JAX's
own o and lse). Masks are ragged right padding.

The CUDA kernels are held against the twin on the card
(``chip_smoke.py`` phase 11 and ``tests/test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import flash_attention as JF
from cmw_rag_tpu_torch.ops import flash_attention as TF

BH, H, L, D, BLOCK = 4, 2, 64, 32, 32
BF16_ABS = 1e-6


def _case(seed, bf16=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((BH, L, D)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((BH // H, L), np.int32)
    mask[1, rng.integers(L // 4, L - 1):] = 0
    if bf16:  # round once, so both sides see the same values
        q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                                  .astype(jnp.float32)) for x in (q, k, v, do))
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, dtype, block=BLOCK):
    cast = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" \
        else jnp.asarray
    fn = lambda a, b, c: JF.flash_attention_trainable(  # noqa: E731
        a, b, c, jnp.asarray(mask), H, causal, block, block, True)
    o, vjp = jax.vjp(fn, cast(q), cast(k), cast(v))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(cast(do))], o


def _torch(x, dtype):
    t = torch.from_numpy(np.array(x))
    return t.bfloat16() if dtype == "bf16" else t


def _port_grads(q, k, v, do, mask, causal, dtype, block=BLOCK):
    qt, kt, vt = (_torch(x, dtype).requires_grad_() for x in (q, k, v))
    o = TF.flash_attention_trainable(qt, kt, vt, torch.from_numpy(mask), H,
                                     causal, block, block)
    grads = torch.autograd.grad(o, (qt, kt, vt), _torch(do, dtype))
    return [g.float().numpy() for g in grads], o


def _one_bf16_step(x):
    x = np.abs(x.astype(np.float32))
    return np.where(x == 0, 0.0, np.ldexp(1.0, np.frexp(x)[1] - 8))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_matches_jax_grad_in_interpret_mode(causal, dtype):
    q, k, v, do, mask = _case(1 + causal, bf16=dtype == "bf16")
    want, jo = _jax_grads(q, k, v, do, mask, causal, dtype)
    got, to = _port_grads(q, k, v, do, mask, causal, dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            excess = np.abs(g - w) - _one_bf16_step(w)
            assert excess.max() <= BF16_ABS, (name, excess.max())
    assert to.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_twin_at_blocks_of_16_and_64_matches_jax(causal):
    """Other block sizes: the same function (the causal skip only drops
    blocks whose p is 0)."""
    q, k, v, do, mask = _case(3)
    for block in (16, 64):
        want, _ = _jax_grads(q, k, v, do, mask, causal, "f32", block)
        got, _ = _port_grads(q, k, v, do, mask, causal, "f32", block)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_plain_twin_equals_the_function_backward_and_keeps_dtypes():
    q, k, v, do, mask = _case(4, bf16=True)
    tq, tk, tv, tdo = (_torch(x, "bf16") for x in (q, k, v, do))
    tm = torch.from_numpy(mask)
    o, lse = TF.flash_attention_fwd(tq, tk, tv, tm, H, True, BLOCK, BLOCK)
    dq, dk, dv = TF.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse, tdo, H,
                                              True, BLOCK, BLOCK)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    got, _ = _port_grads(q, k, v, do, mask, True, "bf16")
    for a, b in zip((dq, dk, dv), got):
        np.testing.assert_array_equal(a.float().numpy(), b)


def test_fully_masked_row_gets_p_one_not_nan():
    """A batch row with no real key: the forward's lse is -1e30 + log(n),
    which is -1e30 in float32, so exp(s - lse) is 1 on every key of the
    blocks run, as in JAX; never NaN."""
    q, k, v, do, mask = _case(5)
    mask[0] = 0
    want, _ = _jax_grads(q, k, v, do, mask, True, "f32")
    got, _ = _port_grads(q, k, v, do, mask, True, "f32")
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_cpu_backward_counts_no_launch():
    q, k, v, do, mask = _case(6)
    TF.reset_launches()
    _port_grads(q, k, v, do, mask, True, "f32")
    assert (TF.flash_attention_bwd_dq.launches,
            TF.flash_attention_bwd_dkv.launches, TF.total_launches()) == (0, 0, 0)


def test_bhld_adapter_gradients_match_jax():
    """The model adapter ([B, L, H, Dh] layout) is differentiable through
    the same function, as JAX's."""
    rng = np.random.default_rng(7)
    b, l, h, dh = 2, 64, 2, 16
    q, k, v, do = (rng.standard_normal((b, l, h, dh)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((b, l), np.int32)
    mask[1, 40:] = 0
    fn = lambda a, c, e: JF.flash_attention_bhld(  # noqa: E731
        a, c, e, jnp.asarray(mask), causal=True, block_q=32, block_k=32,
        interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = TF.flash_attention_bhld(*ts, torch.from_numpy(mask), causal=True,
                                  block_q=32, block_k=32)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_backward_wrappers_reject_what_the_kernel_does_not_take():
    """The kernel checks run before any launch: f32 or a ragged length
    raise on a CUDA-bound call; here the check itself is exercised."""
    q = torch.zeros((4, 64, 48), dtype=torch.bfloat16)
    mask = torch.ones((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        TF._check(q, q, q, mask, 2, 64, do=q)
    q = torch.zeros((4, 96, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        TF._check(q, q, q, torch.ones((2, 96), dtype=torch.int32), 2, 64,
                  do=q)
    with pytest.raises(TypeError, match="do"):
        TF._check(q, q, q, torch.ones((2, 96), dtype=torch.int32), 2, 32,
                  do=q.float())
