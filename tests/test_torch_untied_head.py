"""An untied LM head (``tie_embeddings=False``, a separate ``lm_head``
[d, vocab]) in the port against the JAX package, which builds, runs and
quantizes one (``models/qwen3.py:69-70``, ``generate.py:138``,
``engine.py:127,212,510``, ``quantize.py:42``).

Tiny float32 config (2 layers, d 64, 4 heads, 2 KV heads, head_dim 16, the
tokenizer's vocabulary), the weights carried across by ``params_from_jax``:
the layout and the npz checkpoint hold ``lm_head`` in JAX's tree position;
``generate``'s greedy text, the paged engine's greedy ids on the native
routes (golden and kernel) and on the int8 megakernel route (JAX's kernels
in interpret mode, the port's twins) are equal; the quantized head is bit
for bit JAX's. The head is drawn apart from the embedding, so a route that
read the embedding's transpose would give other ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.models import engine as JE
from cmw_rag_tpu.models import generate as JG
from cmw_rag_tpu.models.common import save_params_npz as jax_save
from cmw_rag_tpu.models.qwen3 import Qwen3Config as JConfig
from cmw_rag_tpu.models.qwen3 import init_qwen3 as jax_init
from cmw_rag_tpu.models.quantize import quantize_qwen3_params as jax_quantize
from cmw_rag_tpu.tokenizer import get_tokenizer as jax_tokenizer
from cmw_rag_tpu_torch.models import engine as E
from cmw_rag_tpu_torch.models import generate as G
from cmw_rag_tpu_torch.models.quantize import quantize_qwen3_params
from cmw_rag_tpu_torch.models.qwen3 import (
    Qwen3Config,
    init_qwen3,
    qwen3_layout,
)
from cmw_rag_tpu_torch.models.weights import (
    load_params_npz,
    params_from_jax,
    tree_leaves,
)
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

TOK, JTOK = get_tokenizer(), jax_tokenizer()
DIMS = dict(vocab_size=TOK.n_vocab, d_model=64, d_ff=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, tie_embeddings=False)
JCFG = JConfig(dtype=jnp.float32, **DIMS)
CFG = Qwen3Config(dtype=torch.float32, **DIMS)
JP = jax_init(jax.random.PRNGKey(3), JCFG)
TP = params_from_jax(jax.tree.map(np.asarray, JP))
PROMPTS = ["Как настроить процесс в системе?", "What is the license cost?"]


def test_layout_init_and_checkpoint_hold_the_head_in_jax_order(tmp_path):
    layout = qwen3_layout(CFG)
    assert tuple(layout["lm_head"].shape) == (64, TOK.n_vocab)
    mine = init_qwen3(torch.Generator().manual_seed(0), CFG)
    assert tuple(mine["lm_head"].shape) == (64, TOK.n_vocab)
    assert not torch.equal(mine["lm_head"], mine["embed"].T)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(JP)]
    jax_save(JP, tmp_path / "untied.npz")
    loaded = load_params_npz(layout, tmp_path / "untied.npz")
    for a, b in zip(tree_leaves(loaded), tree_leaves(TP)):
        assert torch.equal(a, b)
    assert torch.equal(loaded["lm_head"], TP["lm_head"])


def test_generate_greedy_text_matches_jax():
    for prompt in PROMPTS:
        got = G.generate(TP, CFG, TOK, prompt, max_new_tokens=8, max_len=64)
        want = JG.generate(JP, JCFG, JTOK, prompt, max_new_tokens=8,
                           max_len=64)
        assert got == want


def test_quantized_head_is_bit_equal_to_jax():
    got = quantize_qwen3_params(TP, CFG)
    want = jax_quantize(JP, JCFG)
    for key in ("head_q", "head_s"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["head_q"].shape[1] % 128 == 0


@pytest.mark.parametrize("kw", [dict(use_kernel=False),
                                dict(use_kernel=True),
                                dict(weights="int8", use_kernel=True)],
                         ids=["native-golden", "native-kernel", "int8"])
def test_engine_greedy_ids_match_jax(kw):
    base = dict(max_slots=2, page_size=16, max_ctx=256)
    jkw = dict(kw, kernel_interpret=True) if kw.get("use_kernel") else kw
    jeng = JE.PagedLLMEngine(JP, JCFG, JTOK, **base, **jkw)
    teng = E.PagedLLMEngine(TP, CFG, TOK, device="cpu", **base, **kw)
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        eng.run_until_done(reqs)
        outs.append([(r.out, r.finish_reason) for r in reqs])
    assert outs[0] == outs[1]
