"""The port's KV-cache generation (cmw_rag_tpu_torch.models.generate) on the
CPU against the JAX package's (cmw_rag_tpu.models.generate), with the same
weights carried across by ``params_from_jax``: the cases of
``tests/test_generate.py``, each also held to the JAX function.

Float32 config of ``tests/test_generate.py`` (2 layers, d 32, 4 heads, 2 KV
heads, head_dim 8). Logits to 2e-4 (prefill) and 5e-4 (after six decode
steps), the tolerances the JAX package holds its own cache to its full
forward; greedy text equal. Temperature sampling draws from a
``torch.Generator``, not JAX's stream, so those runs are held to the port's
own determinism only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.models import generate as JG
from cmw_rag_tpu.models.qwen3 import Qwen3Config as JConfig
from cmw_rag_tpu.models.qwen3 import init_qwen3 as jax_init
from cmw_rag_tpu.models.qwen3 import qwen3_forward
from cmw_rag_tpu.tokenizer import get_tokenizer as jax_tokenizer
from cmw_rag_tpu_torch.models import generate as G
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config, qwen3_hidden_states
from cmw_rag_tpu_torch.models.weights import params_from_jax
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

DIMS = dict(vocab_size=3712, d_model=32, d_ff=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=8)
JCFG = JConfig(dtype=jnp.float32, **DIMS)
CFG = Qwen3Config(dtype=torch.float32, **DIMS)
PROMPTS = ["Привет мир", "configure the workflow process now", "коротко"]


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _full_logits(params, seq):
    ids = torch.as_tensor(seq[None].astype(np.int64))
    h = qwen3_hidden_states(params, CFG, ids, torch.ones_like(ids))
    return (h[0, -1] @ params["embed"].T).numpy()


def test_prefill_matches_full_forward_and_jax(weights):
    jp, tp = weights
    ids = np.random.default_rng(0).integers(1, 3000, (1, 12)).astype(np.int32)
    cache = G.init_cache(CFG, batch=1, max_len=32)
    logits, cache = G._block_forward(tp, CFG, torch.as_tensor(ids), cache, 0)
    assert cache["len"] == 12 and logits.dtype == torch.float32
    np.testing.assert_allclose(logits[0].numpy(), _full_logits(tp, ids[0]),
                               rtol=2e-4, atol=2e-4)
    jl, _ = JG._block_forward(jp, JCFG, jnp.asarray(ids),
                              JG.init_cache(JCFG, batch=1, max_len=32),
                              jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    full = qwen3_forward(jp, JCFG, jnp.asarray(ids), jnp.ones_like(ids))
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(full[0, -1]),
                               rtol=2e-4, atol=2e-4)


def test_incremental_decode_matches_full_forward_and_jax(weights):
    jp, tp = weights
    seq = np.random.default_rng(1).integers(1, 3000, 10).astype(np.int32)
    prefix, rest = seq[:4], seq[4:]
    cache = G.init_cache(CFG, batch=1, max_len=16)
    jcache = JG.init_cache(JCFG, batch=1, max_len=16)
    logits, cache = G._block_forward(tp, CFG, torch.as_tensor(prefix[None]),
                                     cache, 0)
    jl, jcache = JG._block_forward(jp, JCFG, jnp.asarray(prefix[None]), jcache,
                                   jnp.asarray(0, jnp.int32))
    for pos, tok in enumerate(rest, start=len(prefix)):
        logits, cache = G._block_forward(tp, CFG, torch.tensor([[int(tok)]]),
                                         cache, pos)
        jl, jcache = JG._block_forward(jp, JCFG, jnp.asarray([[int(tok)]]),
                                       jcache, jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(logits[0].numpy(), _full_logits(tp, seq),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=5e-4, atol=5e-4)


def test_generate_greedy_deterministic_and_equal_to_jax(weights):
    jp, tp = weights
    tok = get_tokenizer()
    out1 = G.generate(tp, CFG, tok, "Привет", max_new_tokens=8, max_len=64)
    out2 = G.generate(tp, CFG, tok, "Привет", max_new_tokens=8, max_len=64)
    assert out1 == out2 and isinstance(out1, str)
    assert out1 == JG.generate(jp, JCFG, jax_tokenizer(), "Привет",
                               max_new_tokens=8, max_len=64)


def test_generate_respects_stop_and_limit(weights):
    _, tp = weights
    tok = get_tokenizer()
    out = G.generate(tp, CFG, tok, "тест", max_new_tokens=3, max_len=64)
    assert len(tok.encode(out)) <= 3 + 2  # decode may merge differently
    stop_all = [s for s in tok.special_tokens]
    ids = G._stop_ids(tok, stop_all)
    assert ids == set(tok.special_tokens.values())


def test_generate_sampling_is_seeded(weights):
    _, tp = weights
    tok = get_tokenizer()
    a = G.generate(tp, CFG, tok, "q", max_new_tokens=4, temperature=0.8,
                   max_len=64, seed=1)
    b = G.generate(tp, CFG, tok, "q", max_new_tokens=4, temperature=0.8,
                   max_len=64, seed=1)
    assert isinstance(a, str) and a == b


def test_generate_batch_matches_single_and_jax(weights):
    """Left-padded batched generation gives the one-at-a-time greedy tokens
    (padding and RoPE offsets), and the JAX package's batch."""
    jp, tp = weights
    tok = get_tokenizer()
    singles = [G.generate(tp, CFG, tok, p, max_new_tokens=6, max_len=64)
               for p in PROMPTS]
    batched = G.generate_batch(tp, CFG, tok, PROMPTS, max_new_tokens=6,
                               max_len=64)
    assert batched == singles
    assert batched == JG.generate_batch(jp, JCFG, jax_tokenizer(), PROMPTS,
                                        max_new_tokens=6, max_len=64)


def test_generate_batch_empty_and_one(weights):
    _, tp = weights
    tok = get_tokenizer()
    assert G.generate_batch(tp, CFG, tok, [], max_new_tokens=4) == []
    out = G.generate_batch(tp, CFG, tok, ["тест"], max_new_tokens=4,
                           max_len=64, temperature=0.5, seed=3)
    assert len(out) == 1 and isinstance(out[0], str)


def test_rope_and_layer_pieces_match_jax(weights):
    """``_apply_rope_bt`` and one ``_layer_forward`` over a cache with left
    padding, the pieces the paged engine reuses."""
    jp, tp = weights
    rng = np.random.default_rng(2)
    b, t, max_len = 2, 5, 8
    x = rng.standard_normal((b, t, 32)).astype(np.float32)
    k = rng.standard_normal((b, max_len, 2, 8)).astype(np.float32)
    v = rng.standard_normal((b, max_len, 2, 8)).astype(np.float32)
    ang = rng.uniform(0, 6, (b, t, 4)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    pos = np.arange(3, 3 + t, dtype=np.int32)
    pads = np.asarray([0, 2], np.int32)
    got = G._layer_forward(tp["layers"][1], CFG, torch.from_numpy(x),
                           torch.from_numpy(cos), torch.from_numpy(sin),
                           torch.from_numpy(k), torch.from_numpy(v), 3 + t,
                           torch.from_numpy(pos), torch.from_numpy(pads))
    want = JG._layer_forward(jp["layers"][1], JCFG, jnp.asarray(x),
                             jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(k),
                             jnp.asarray(v), 3 + t, jnp.asarray(pos),
                             jnp.asarray(pads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    xr = rng.standard_normal((b, t, 3, 8)).astype(np.float32)
    np.testing.assert_allclose(
        G._apply_rope_bt(torch.from_numpy(xr), torch.from_numpy(cos),
                         torch.from_numpy(sin)).numpy(),
        np.asarray(JG._apply_rope_bt(jnp.asarray(xr), jnp.asarray(cos),
                                     jnp.asarray(sin))), rtol=1e-6, atol=1e-6)
