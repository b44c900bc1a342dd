"""The port's fused int8 decode MLP (cmw_rag_tpu_torch.ops.fused_mlp) on the
CPU against the JAX package's (cmw_rag_tpu.ops.fused_mlp), at the shapes of
``tests/test_engine.py::test_fused_mlp_kernel_matches_golden``.

The wrapper's CPU route, the twin of the CUDA kernel, keeps the TPU kernel's
rounding points (attn, y and h rounded to bf16), so it meets the JAX Pallas
kernel in interpret mode within 1e-4 (float32 sums in another order; where
that moves a bf16 rounding of y or h one step, an output moves by ~1e-5) and
the float32 golden at the JAX test's rtol/atol 2e-2. The port's golden
meets JAX's within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.ops import fused_mlp as J
from cmw_rag_tpu.ops.int8_matmul import quantize_weight
from cmw_rag_tpu_torch.ops import fused_mlp as T


def _case(s, d=256, a=512, f=768, seed=2):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(s, d)), jnp.float32)
    attn = jnp.asarray(rng.normal(size=(s, a)) * 0.1, jnp.float32)
    wo = quantize_weight(jnp.asarray(rng.normal(size=(a, d)) * 0.05,
                                     jnp.float32))
    gu = quantize_weight(jnp.asarray(rng.normal(size=(d, 2 * f)) * 0.05,
                                     jnp.float32))
    dn = quantize_weight(jnp.asarray(rng.normal(size=(f, d)) * 0.05,
                                     jnp.float32))
    fnw = jnp.asarray(rng.normal(size=(d,)) * 0.1 + 1.0, jnp.float32)
    args = (x, attn, *wo, fnw, *gu, *dn)
    return args, [torch.from_numpy(np.array(t)) for t in args]


@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("block_f", [256, 768])
def test_fused_mlp_matches_jax_kernel_and_golden(s, block_f):
    args, targs = _case(s)
    got = T.fused_mlp_int8(*targs, block_f=block_f)
    assert got.dtype == torch.float32 and got.shape == (s, 256)
    kern = np.asarray(J.fused_mlp_int8(*args, block_f=block_f,
                                       interpret=True))
    gold = np.asarray(J.fused_mlp_int8_xla(*args))
    np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), gold, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(T.fused_mlp_int8_xla(*targs).numpy(), gold,
                               rtol=0, atol=1e-5)


def test_fused_mlp_bf16_residual_keeps_its_dtype():
    """A bf16 residual (the card's) comes back bf16, from the same float32
    arithmetic as the twin over the same inputs."""
    _, targs = _case(4, seed=5)
    x16 = targs[0].bfloat16()
    got = T.fused_mlp_int8(x16, targs[1].bfloat16(), *targs[2:])
    want = T.fused_mlp_int8_plain(x16.float(), targs[1].bfloat16(),
                                  *targs[2:]).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_twin_rounds_where_the_kernel_rounds():
    """attn, y and h are rounded to bf16 and x1 and the sums stay float32,
    so the twin is not the float32 golden, but within its tolerance."""
    _, targs = _case(4, seed=7)
    twin = T.fused_mlp_int8_plain(*targs)
    gold = T.fused_mlp_int8_xla(*targs)
    assert not torch.equal(twin, gold)
    assert (twin - gold).abs().max() < 2e-2
