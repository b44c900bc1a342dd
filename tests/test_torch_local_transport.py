"""The port's in-process LLM transport (cmw_rag_tpu_torch.llm.local_transport)
on the CPU against the JAX package's: ``format_chatml``, and the JSON and SSE
bodies of ``make_local_transport`` (one ``generate`` a request) and of
``make_engine_transport`` (an ``EngineLoop`` over the paged engine), for the
same weights and the same requests. The bodies are held equal byte for
byte, but for the JSON ``id``, which carries the clock. The tiny float32
spec of ``tests/test_local_llm.py`` (vocabulary 0: the tokenizer's, rounded
up to 128).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.llm import local_transport as JT
from cmw_rag_tpu.models.engine import EngineLoop as JLoop
from cmw_rag_tpu.models.engine import PagedLLMEngine as JEngine
from cmw_rag_tpu.models.qwen3 import Qwen3Config as JConfig
from cmw_rag_tpu.models.qwen3 import init_qwen3 as jax_init
from cmw_rag_tpu.tokenizer import get_tokenizer as jax_tokenizer
from cmw_rag_tpu_torch.config import GuardModelSpec
from cmw_rag_tpu_torch.llm import local_transport as T
from cmw_rag_tpu_torch.models.engine import EngineLoop, PagedLLMEngine
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
from cmw_rag_tpu_torch.models.weights import params_from_jax
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

TINY = GuardModelSpec(slug="tiny-lm", arch="qwen3", max_tokens=256,
                      d_model=32, d_ff=64, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=8, vocab_size=0)
TOK, JTOK = get_tokenizer(), jax_tokenizer()
VOCAB = -(-TOK.n_vocab // 128) * 128
DIMS = dict(vocab_size=VOCAB, d_model=32, d_ff=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=8)
JCFG = JConfig(dtype=jnp.float32, **DIMS)
CFG = Qwen3Config(dtype=torch.float32, **DIMS)
JP = jax_init(jax.random.PRNGKey(0), JCFG)
TP = params_from_jax(jax.tree.map(np.asarray, JP))
CHATS = [[{"role": "user", "content": "привет"}],
         [{"role": "system", "content": "s"}, {"role": "user", "content": "u"},
          {"role": "tool", "name": "f", "content": "r"}]]


def _payload(messages, stream, max_tokens=6):
    return json.dumps({"messages": messages, "max_tokens": max_tokens,
                       "stream": stream}).encode()


def _body(resp, stream):
    if stream:
        return b"".join(resp if hasattr(resp, "__iter__")
                        and not hasattr(resp, "getvalue") else [resp.read()])
    body = json.loads(resp.read())
    assert body.pop("id").startswith("local-")
    return body


def test_tokenizer_serving_api_matches_jax():
    """What the engine and the transports call on the tokenizer."""
    assert TOK.special_tokens == JTOK.special_tokens
    text = T.format_chatml(CHATS[1]) + " Привет, мир! ünïcode 12345"
    ids = TOK.encode(text, allowed_special="all")
    assert ids == JTOK.encode(text, allowed_special="all")
    assert TOK.decode_bytes(ids) == JTOK.decode_bytes(ids)
    assert TOK.decode_bytes(ids[:3]) + TOK.decode_bytes(ids[3:]) == \
        TOK.decode_bytes(ids)
    assert TOK.count(text) == JTOK.count(text) == len(TOK.encode(text))


def test_format_chatml_matches_jax():
    for messages in CHATS + [[], [{"content": None}]]:
        assert T.format_chatml(messages) == JT.format_chatml(messages)
    text = T.format_chatml(CHATS[1])
    assert text.startswith("<|im_start|>system\ns<|im_end|>")
    assert "[tool:f] r" in text and text.endswith("<|im_start|>assistant\n")


@pytest.mark.parametrize("stream", [False, True])
def test_local_transport_bodies_match_jax(stream):
    port = T.make_local_transport(TP, CFG, TOK, max_len=256)
    ref = JT.make_local_transport(JP, JCFG, JTOK, max_len=256)
    for messages in CHATS:
        got = _body(port("u", _payload(messages, stream), {}, 10.0, stream),
                    stream)
        want = _body(ref("u", _payload(messages, stream), {}, 10.0, stream),
                     stream)
        assert got == want


@pytest.mark.parametrize("stream", [False, True])
def test_engine_transport_bodies_match_jax(stream):
    """One request at a time through each package's loop: the same ids,
    so the same deltas, finish reason and usage."""
    port_loop = EngineLoop(PagedLLMEngine(
        TP, CFG, TOK, max_slots=4, page_size=16, max_ctx=256,
        device="cpu")).start()
    ref_loop = JLoop(JEngine(JP, JCFG, JTOK, max_slots=4, page_size=16,
                             max_ctx=256)).start()
    try:
        port = T.make_engine_transport(port_loop, TOK)
        ref = JT.make_engine_transport(ref_loop, JTOK)
        for messages in CHATS:
            got = _body(port("u", _payload(messages, stream), {}, 10.0,
                             stream), stream)
            want = _body(ref("u", _payload(messages, stream), {}, 10.0,
                             stream), stream)
            assert got == want
            if not stream:
                usage = got["usage"]
                assert usage["total_tokens"] == (usage["prompt_tokens"]
                                                 + usage["completion_tokens"])
                assert usage["prompt_tokens"] == len(TOK.encode(
                    T.format_chatml(messages), allowed_special="all"))
            else:
                assert got.endswith(b"data: [DONE]\n\n")
    finally:
        port_loop.stop()
        ref_loop.stop()


@pytest.mark.parametrize("continuous", [False, True])
def test_create_local_llm_transport_on_the_cpu(continuous):
    llm = T.create_local_llm_transport(spec=TINY, tokenizer=TOK, params=TP,
                                       max_len=256, page_size=16,
                                       dtype=torch.float32,
                                       continuous_batching=continuous,
                                       device="cpu")
    try:
        assert llm.cfg.vocab_size == VOCAB and llm.cfg.vocab_size % 128 == 0
        assert (llm.engine_loop is not None) == continuous
        got = _body(llm.transport("u", _payload(CHATS[0], False), {}, 10.0,
                                  False), False)
        want = _body(JT.make_local_transport(JP, JCFG, JTOK, max_len=256)(
            "u", _payload(CHATS[0], False), {}, 10.0, False), False)
        assert got["choices"][0]["message"] == want["choices"][0]["message"]
        assert got["usage"]["prompt_tokens"] == want["usage"]["prompt_tokens"]
        assert got["model"] == "local-tpu"
    finally:
        if llm.engine_loop is not None:
            llm.engine_loop.stop()


def test_create_local_llm_transport_draws_its_own_weights():
    """Random init from the seed (CPU generator) at the spec's shapes, bf16
    unless told otherwise; the default device is the card."""
    a = T.create_local_llm_transport(spec=TINY, tokenizer=TOK, seed=3,
                                     device="cpu")
    b = T.create_local_llm_transport(spec=TINY, tokenizer=TOK, seed=3,
                                     device="cpu")
    assert a.params["embed"].shape == (VOCAB, 32)
    assert a.params["embed"].dtype == torch.bfloat16
    assert torch.equal(a.params["layers"][1]["wq"], b.params["layers"][1]["wq"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.create_local_llm_transport(spec=TINY, tokenizer=TOK)
