"""PyTorch port of the model forwards (cmw_rag_tpu_torch.models) against the
JAX package on the same inputs and weights.

Algorithm checks run in float32 on both sides (atol 1e-4: the frameworks sum
in different orders, ~1e-6 relative). One check runs in bf16 on the pooled
unit vectors (atol 2e-2): XLA and PyTorch round bf16 intermediates at
different places, which moves hidden states by a few bf16 ulps; the pooled
unit vectors have elements of ~0.06, so 2e-2 bounds that drift.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.models import common as jcommon
from cmw_rag_tpu.models import pooling as jpool
from cmw_rag_tpu.models import qwen3 as jqwen
from cmw_rag_tpu.models import t5_encoder as jt5
from cmw_rag_tpu_torch.models import pooling as tpool
from cmw_rag_tpu_torch.models import qwen3 as tqwen
from cmw_rag_tpu_torch.models import t5_encoder as tt5
from cmw_rag_tpu_torch.models.weights import (
    load_params_npz,
    params_from_jax,
    tree_leaves,
)

CKPT = Path(__file__).resolve().parents[1] / "checkpoints"
VOCAB = 16512


def _ids(b, l, seed, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 16388, (b, l)).astype(np.int32) % vocab
    mask = np.ones((b, l), np.int32)
    mask[1, l // 2:] = 0            # one padded row
    return ids, mask


def _t5_cfgs(d, ff, layers, heads, jdtype, tdtype, vocab=VOCAB):
    return (jt5.T5EncoderConfig(vocab_size=vocab, d_model=d, d_ff=ff,
                                num_layers=layers, num_heads=heads,
                                dtype=jdtype),
            tt5.T5EncoderConfig(vocab_size=vocab, d_model=d, d_ff=ff,
                                num_layers=layers, num_heads=heads,
                                dtype=tdtype))


def _qwen_cfgs(jdtype, tdtype):
    kw = dict(vocab_size=VOCAB, d_model=256, d_ff=768, num_layers=4,
              num_heads=4, num_kv_heads=2, head_dim=64)
    return (jqwen.Qwen3Config(dtype=jdtype, **kw),
            tqwen.Qwen3Config(dtype=tdtype, **kw))


@pytest.mark.parametrize("length", [1, 2, 17, 64, 128, 129, 300, 513, 1024])
def test_t5_bucket_table_equals_jax(length):
    """int(log(...)) truncates: a float rounding at a boundary would move a
    bucket, so the whole [L, L] table must equal JAX's."""
    pos = jnp.arange(length)
    want = np.asarray(jt5._relative_position_bucket(
        pos[None, :] - pos[:, None], 32, 128))
    got = tt5._bucket_table(length, 32, 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_checkpoint_leaf_order_matches_jax_tree():
    """The npz stores leaves in JAX tree order (sorted dict keys). wq, wk,
    wv and wo share one shape, so a wrong order would load silently."""
    cfg = jt5.T5EncoderConfig(vocab_size=VOCAB, d_model=256, d_ff=768,
                              num_layers=4, num_heads=4)
    like = jax.eval_shape(lambda: jt5.init_t5_encoder(jax.random.PRNGKey(0),
                                                      cfg))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(like)[0]]
    _, tcfg = _t5_cfgs(256, 768, 4, 4, jnp.float32, torch.float32)
    layout = tt5.t5_layout(tcfg)
    ours = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + f"['{k}']")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, prefix + f"[{i}]")
        else:
            ours.append(prefix)

    walk(layout, "")
    assert ours == paths
    assert paths[2:11] == [f"['layers'][0]['{k}']" for k in (
        "attn_norm", "ffn_norm", "wi_gelu", "wi_lin", "wk", "wo", "wo_ff",
        "wq", "wv")]
    # the loaded tensors are the npz arrays in that order
    params = load_params_npz(layout, CKPT / "frida_mini_cl2.npz")
    with np.load(CKPT / "frida_mini_cl2.npz") as data:
        for i, leaf in enumerate(tree_leaves(params)):
            np.testing.assert_array_equal(leaf.numpy(), data[f"arr_{i}"])


def _jax_ckpt(init, cfg, path):
    like = init(jax.random.PRNGKey(0), cfg)
    return jcommon.load_params_npz(like, path)


@pytest.mark.parametrize("ckpt,score_head", [
    ("frida_mini_cl2.npz", False), ("reranker_hn2_kb.npz", True)])
def test_t5_encode_matches_jax_on_checkpoint(ckpt, score_head):
    jcfg, tcfg = _t5_cfgs(256, 768, 4, 4, jnp.float32, torch.float32)

    def jinit(key, cfg):
        p = jt5.init_t5_encoder(key, cfg)
        if score_head:
            p["score_head"] = jnp.zeros((cfg.d_model, 1), jnp.float32)
        return p

    jp = _jax_ckpt(jinit, jcfg, CKPT / ckpt)
    tp = load_params_npz(tt5.t5_layout(tcfg, score_head=score_head),
                         CKPT / ckpt)
    ids, mask = _ids(3, 40, seed=1)
    want = np.asarray(jt5.t5_encode(jp, jcfg, jnp.asarray(ids),
                                    jnp.asarray(mask)))
    got = tt5.t5_encode(tp, tcfg, torch.from_numpy(ids),
                        torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_qwen3_hidden_states_match_jax_on_checkpoint():
    jcfg, tcfg = _qwen_cfgs(jnp.float32, torch.float32)
    jp = _jax_ckpt(jqwen.init_qwen3, jcfg, CKPT / "llm_reranker_micro.npz")
    tp = load_params_npz(tqwen.qwen3_layout(tcfg),
                         CKPT / "llm_reranker_micro.npz")
    ids, mask = _ids(3, 33, seed=2)
    want = np.asarray(jqwen.qwen3_hidden_states(jp, jcfg, jnp.asarray(ids),
                                                jnp.asarray(mask)))
    got = tqwen.qwen3_hidden_states(tp, tcfg, torch.from_numpy(ids),
                                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["t5", "qwen3"])
def test_random_init_params_carry_over_from_jax(arch):
    """params_from_jax: a randomly initialised JAX tree runs identically in
    the port (small widths, odd head dim 32 → sqrt(dh) is inexact)."""
    ids, mask = _ids(2, 24, seed=3, vocab=512)
    if arch == "t5":
        jcfg, tcfg = _t5_cfgs(64, 128, 2, 2, jnp.float32, torch.float32,
                              vocab=512)
        jp = jt5.init_t5_encoder(jax.random.PRNGKey(4), jcfg)
        want = jt5.t5_encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
        got = tt5.t5_encode(params_from_jax(jax.tree.map(np.asarray, jp)),
                            tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    else:
        kw = dict(vocab_size=512, d_model=64, d_ff=128, num_layers=2,
                  num_heads=2, num_kv_heads=1, head_dim=32)
        jcfg = jqwen.Qwen3Config(dtype=jnp.float32, **kw)
        tcfg = tqwen.Qwen3Config(dtype=torch.float32, **kw)
        jp = jqwen.init_qwen3(jax.random.PRNGKey(5), jcfg)
        want = jqwen.qwen3_hidden_states(jp, jcfg, jnp.asarray(ids),
                                         jnp.asarray(mask))
        got = tqwen.qwen3_hidden_states(
            params_from_jax(jax.tree.map(np.asarray, jp)), tcfg,
            torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("method", ["cls", "mean", "last_token"])
def test_pool_hidden_matches_jax(method):
    rng = np.random.default_rng(6)
    h = rng.standard_normal((3, 9, 16)).astype(np.float32)
    _, mask = _ids(3, 9, seed=6)
    want = jpool.pool_hidden(jnp.asarray(h), jnp.asarray(mask), method)
    got = tpool.pool_hidden(torch.from_numpy(h), torch.from_numpy(mask), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_t5_bf16_pooled_vectors_close_to_jax():
    """bf16 end to end (the shipping dtype) on the frida checkpoint: mean-
    pooled unit vectors agree to 2e-2 (see module docstring)."""
    jcfg, tcfg = _t5_cfgs(256, 768, 4, 4, jnp.bfloat16, torch.bfloat16)
    jp = _jax_ckpt(jt5.init_t5_encoder, jcfg, CKPT / "frida_mini_cl2.npz")
    tp = load_params_npz(tt5.t5_layout(tcfg), CKPT / "frida_mini_cl2.npz")
    ids, mask = _ids(3, 40, seed=7)
    want = jpool.pool_hidden(
        jt5.t5_encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)),
        jnp.asarray(mask), "mean")
    t_mask = torch.from_numpy(mask)
    got = tpool.pool_hidden(tt5.t5_encode(tp, tcfg, torch.from_numpy(ids),
                                          t_mask), t_mask, "mean")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)
