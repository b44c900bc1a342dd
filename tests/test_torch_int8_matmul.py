"""The port's int8 weight path (cmw_rag_tpu_torch.ops.int8_matmul,
cmw_rag_tpu_torch.models.quantize) on the CPU against the JAX package's.

- ``quantize_weight`` and ``quantize_qwen3_params`` are held bit for bit to
  JAX's from the same float32 (and bf16) weights: both round half to even,
  so any difference is an operation order.
- The wrapper's CPU route, the twin of the CUDA kernel, against the JAX
  Pallas kernel in interpret mode at 1e-5 relative (both round x to bf16
  and sum exact bf16 x int8 products in float32, in another order), and
  against the float32 golden at the JAX tests' 2e-2 (the bf16 rounding of
  x).
- The build's hash follows the headers a kernel source includes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.models.qwen3 import Qwen3Config as JConfig
from cmw_rag_tpu.models.qwen3 import init_qwen3 as jax_init
from cmw_rag_tpu.models.quantize import dequantize_layer as jax_dequantize
from cmw_rag_tpu.models.quantize import quantize_qwen3_params as jax_quantize
from cmw_rag_tpu.ops import int8_matmul as J
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
from cmw_rag_tpu_torch.models.quantize import (dequantize_layer,
                                               quantize_qwen3_params)
from cmw_rag_tpu_torch.models.weights import params_from_jax, tree_leaves
from cmw_rag_tpu_torch.ops import cuda_build
from cmw_rag_tpu_torch.ops import int8_matmul as T

DIMS = dict(vocab_size=1000, d_model=64, d_ff=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16)


def _np(a):
    return np.asarray(a.float() if a.dtype == torch.bfloat16 else a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_is_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(96, 160)).astype(np.float32) * 0.05
    w[:, 3] = 0.0                                  # an all-zero column
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq, js = J.quantize_weight(jw)
    tq, ts = T.quantize_weight(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_weight_rounds_half_to_even_like_jax():
    """Columns whose max is 127 make w / scale land on exact halves."""
    w = np.array([[127.0, 127.0], [0.5, 1.5], [2.5, -0.5], [-2.5, 3.5]],
                 np.float32)
    jq, _ = J.quantize_weight(jnp.asarray(w))
    tq, _ = T.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[1:, 0].tolist() == [0, 2, -2]


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (4, 256, 512), (9, 128, 384),
                                   (33, 64, 256)])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax_kernel_and_golden(m, k, n, xdtype):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, ws = J.quantize_weight(jnp.asarray(
        rng.normal(size=(k, n)).astype(np.float32) * 0.05))
    jx = jnp.asarray(x, getattr(jnp, xdtype))
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    twq, tws = torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(ws))
    got = T.int8_matmul(tx, twq, tws)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    kern = np.asarray(J.int8_matmul(jx, wq, ws, interpret=True), np.float32)
    gold = np.asarray(J.int8_matmul_xla(jx, wq, ws), np.float32)
    if xdtype == "float32":
        np.testing.assert_allclose(_np(got), kern, rtol=1e-5, atol=1e-5)
    else:   # both round the same float32 sums to bf16
        np.testing.assert_allclose(_np(got), kern, rtol=2 ** -8, atol=1e-5)
    np.testing.assert_allclose(_np(got), gold, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(T.int8_matmul_xla(tx, twq, tws)), gold,
                               rtol=1e-5, atol=1e-5)


def test_int8_matmul_plain_rounds_x_to_bf16():
    x = torch.tensor([[1.0 + 2 ** -10]])
    wq = torch.ones((1, 1), dtype=torch.int8)
    one = torch.ones((1,))
    assert T.int8_matmul_plain(x, wq, one).item() == 1.0
    assert T.int8_matmul_xla(x, wq, one).item() == 1.0 + 2 ** -10


@pytest.mark.parametrize("vocab", [1000, 1024])
def test_quantized_tree_is_bit_equal_to_jax(vocab):
    dims = dict(DIMS, vocab_size=vocab)
    jp = jax_init(jax.random.PRNGKey(1), JConfig(dtype=jnp.float32, **dims))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jq = jax_quantize(jp, JConfig(dtype=jnp.float32, **dims))
    tq = quantize_qwen3_params(tp, Qwen3Config(dtype=torch.float32, **dims))
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jq))
    tl = tree_leaves(tq)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.numpy().dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b.numpy(), a)
    assert tq["head_q"].shape == (64, -(-vocab // 128) * 128)
    assert tq["head_q"].is_contiguous()
    # dequantized layers (the prefill's) equal JAX's too
    cfg = Qwen3Config(dtype=torch.float32, **dims)
    jcfg = JConfig(dtype=jnp.float32, **dims)
    for jlayer, tlayer in zip(jq["layers"], tq["layers"]):
        jd = jax_dequantize(jlayer, jnp.float32, jcfg)
        td = dequantize_layer(tlayer, torch.float32, cfg)
        assert sorted(jd) == sorted(td)
        for key in jd:
            np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]))


def test_params_from_jax_carries_an_int8_tree():
    jp = jax_init(jax.random.PRNGKey(2), JConfig(dtype=jnp.bfloat16, **DIMS))
    jq = jax_quantize(jp, JConfig(dtype=jnp.bfloat16, **DIMS))
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    layer = tq["layers"][0]
    assert layer["wqkv_q"].dtype == torch.int8
    assert layer["wqkv_s"].dtype == torch.float32
    assert tq["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(layer["w_down_q"].numpy(),
                                  np.asarray(jq["layers"][0]["w_down_q"]))


def test_build_hash_follows_included_headers(tmp_path, monkeypatch):
    """Editing a header a source includes renames the source's library;
    a header it does not include leaves the name alone."""
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "other.cuh").write_text("int c;\n")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n  # include <x.h>\n')
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert [p.name for p in cuda_build.headers(tmp_path / "k.cu")] == [
        "a.cuh", "b.cuh"]
    before = cuda_build.target("k")
    (tmp_path / "other.cuh").write_text("int c2;\n")
    assert cuda_build.target("k") == before
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert cuda_build.target("k") != before
    assert cuda_build.target("k").name.startswith("k_")


def test_every_new_source_is_built():
    """Each int8 decode source is built and hashed with the headers it
    includes, recursively (the two megakernel sources share
    ``decoder_layer.cuh``, which includes the weight phases of
    ``weight_phases.cuh``, built on ``hopper.cuh`` for its TMA pieces and
    ``int8_decode.cuh``; the fused MLP is those weight phases too, and so
    is the weight-only kernel of ``int8_matmul.cu``, whose W8A8 kernel
    takes its TMA and mma pieces from ``hopper.cuh``)."""
    phases = ["weight_phases.cuh", "hopper.cuh", "int8_decode.cuh"]
    megakernel = ["decoder_layer.cuh"] + phases
    for stem, want in (("int8_matmul", ["hopper.cuh", "weight_phases.cuh",
                                        "int8_decode.cuh"]),
                       ("slot_attention", ["int8_decode.cuh"]),
                       ("fused_mlp", phases),
                       ("decoder_layer", megakernel),
                       ("decoder_layer_kv8", megakernel)):
        assert stem in cuda_build.SOURCES
        assert cuda_build.source(stem).is_file()
        assert [p.name for p in cuda_build.headers(cuda_build.source(stem))] \
            == want


def test_ivf_scan_is_built_with_its_headers():
    """The IVF scan is hashed with the Hopper pieces it takes its TMA ring
    from (``hopper.cuh``) and the exact selection it launches after the
    scan (``select_k.cuh``): an edit of either rebuilds it."""
    assert "ivf_scan" in cuda_build.SOURCES
    assert [p.name for p in cuda_build.headers(cuda_build.source("ivf_scan"))
            ] == ["hopper.cuh", "select_k.cuh"]
