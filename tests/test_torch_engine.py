"""The port's paged-KV engine (cmw_rag_tpu_torch.models.engine) on the CPU
against the JAX package's (cmw_rag_tpu.models.engine): the same weights
(carried across by ``params_from_jax``, and the other way), the same
requests, the same greedy token ids and finish reasons, in the cases of
``tests/test_engine.py``.

The tiny float32 config of ``tests/test_engine.py`` (2 layers, d 64, 4
heads, 2 KV heads, head_dim 16, the tokenizer's vocabulary) and a GQA-free
one (4 KV heads). On the CPU the port's kernel route (``use_kernel=True``)
runs the kernels' plain twins, the role interpret mode plays in the JAX
tests; its golden route (``use_kernel=False``) runs the gather golden. The
JAX reference runs its gather golden: its own tests hold its kernels to
it. Ids are held equal: float32 sums in another order move the logits by
~1e-6, and these runs meet no top-2 gap that small.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.models import engine as JE
from cmw_rag_tpu.models.qwen3 import Qwen3Config as JConfig
from cmw_rag_tpu.models.qwen3 import init_qwen3 as jax_init
from cmw_rag_tpu.tokenizer import get_tokenizer as jax_tokenizer
from cmw_rag_tpu_torch.models import engine as E
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3
from cmw_rag_tpu_torch.models.weights import params_from_jax, tree_map
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

TOK, JTOK = get_tokenizer(), jax_tokenizer()
DIMS = {"gqa": dict(num_kv_heads=2), "mha": dict(num_kv_heads=4)}


def _dims(kind):
    return dict(vocab_size=TOK.n_vocab, d_model=64, d_ff=128, num_layers=2,
                num_heads=4, head_dim=16, **DIMS[kind])


JP = {k: jax_init(jax.random.PRNGKey(0), JConfig(dtype=jnp.float32, **_dims(k)))
      for k in DIMS}
TP = {k: params_from_jax(jax.tree.map(np.asarray, JP[k])) for k in DIMS}
RU = "Как настроить процесс в системе?"
EN = "What is the license cost?"
_REF: dict = {}


def jax_engine(kind="gqa", params=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 16)
    kw.setdefault("max_ctx", 256)
    return JE.PagedLLMEngine(JP[kind] if params is None else params,
                             JConfig(dtype=jnp.float32, **_dims(kind)), JTOK,
                             **kw)


def port_engine(kind="gqa", params=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 16)
    kw.setdefault("max_ctx", 256)
    kw.setdefault("device", "cpu")
    return E.PagedLLMEngine(TP[kind] if params is None else params,
                            Qwen3Config(dtype=torch.float32, **_dims(kind)),
                            TOK, **kw)


def run(engine, prompts, max_new_tokens, **submit_kw):
    reqs = [engine.submit(p, max_new_tokens=max_new_tokens, **submit_kw)
            for p in prompts]
    engine.run_until_done(reqs)
    return [(r.out, r.finish_reason) for r in reqs]


def reference(key, make, prompts, max_new_tokens, **submit_kw):
    """The JAX engine's result for ``key``, computed once per module."""
    if key not in _REF:
        _REF[key] = run(make(), prompts, max_new_tokens, **submit_kw)
    return _REF[key]


ROUTES = {"golden": dict(use_kernel=False),
          "kernel-scatter": dict(use_kernel=True),
          "kernel-dma": dict(use_kernel=True, scatter_fused=False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kind", sorted(DIMS))
def test_native_kv_routes_give_the_jax_greedy_ids(kind, route):
    want = reference(("native", kind), lambda: jax_engine(kind), [RU, EN], 12)
    eng = port_engine(kind, **ROUTES[route])
    assert eng.scatter_fused == (route == "kernel-scatter")
    assert run(eng, [RU, EN], 12) == want


@pytest.mark.parametrize("route", ["golden", "kernel-dma"])
def test_int8_kv_gives_the_jax_greedy_ids(route):
    want = reference("int8", lambda: jax_engine(kv_dtype="int8"), [RU, EN], 12)
    eng = port_engine(kv_dtype="int8", **ROUTES[route])
    assert eng.k_pool.dtype == torch.int8
    assert eng.k_scale.shape == (2, eng.num_pages, 2)
    assert run(eng, [RU, EN], 12) == want


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_chunked_prefill_gives_the_jax_greedy_ids(kv_dtype):
    """Multi-chunk, single-chunk and short prompts: the chunked engine
    equals the JAX chunked engine and the port's bucketed one."""
    prompts = [RU * 6, EN, RU]
    want = reference(("chunked", kv_dtype), lambda: jax_engine(
        num_pages=64, prefill_chunk=32, kv_dtype=kv_dtype), prompts, 12)
    chunked = run(port_engine(num_pages=64, prefill_chunk=32,
                              kv_dtype=kv_dtype, use_kernel=True), prompts, 12)
    bucketed = run(port_engine(num_pages=64, kv_dtype=kv_dtype), prompts, 12)
    assert chunked == want == bucketed


def test_chunked_prefill_streams_while_decoding():
    eng = port_engine(num_pages=64, prefill_chunk=32)
    short = eng.submit(EN, max_new_tokens=24)
    for _ in range(3):
        eng.step()
    produced = len(short.out)
    long_req = eng.submit(RU * 10, max_new_tokens=4)
    chunks = 0
    while not long_req.out and not short.done:
        eng.step()
        chunks += 1
    assert chunks > 1 and len(short.out) >= produced + chunks - 1
    eng.run_until_done([short, long_req])
    assert short.done and long_req.done and long_req.out


def test_continuous_admission_gives_the_jax_ids():
    """A request joining mid-flight changes no tokens of the one already
    decoding, and itself matches a solo run and the JAX engine."""
    def sequence(eng):
        ra = eng.submit(RU, max_new_tokens=16)
        for _ in range(5):
            eng.step()
        rb = eng.submit(EN, max_new_tokens=16)
        eng.run_until_done([ra, rb])
        return [ra.out, rb.out]

    got = sequence(port_engine())
    assert got == sequence(jax_engine())
    assert got == [run(port_engine(), [p], 16)[0][0] for p in (RU, EN)]


def test_preemption_under_page_pressure_gives_the_jax_ids():
    """A pool too small for both sequences forces a preemption; the outputs
    still equal solo runs and the JAX engine's, and every page returns."""
    def pressure(eng):
        r1 = eng.submit(RU, max_new_tokens=60)
        r2 = eng.submit(EN, max_new_tokens=60)
        eng.run_until_done([r1, r2])
        return [r1.out, r2.out], r1.preemptions + r2.preemptions

    eng = port_engine(num_pages=1 + 9)
    got, pre = pressure(eng)
    want, jpre = pressure(jax_engine(num_pages=1 + 9))
    assert pre > 0 and pre == jpre and got == want
    assert eng.free_pages == eng.num_pages - 1
    assert got == [run(port_engine(), [p], 60)[0][0] for p in (RU, EN)]


def test_oversize_prompt_fails_gracefully():
    eng = port_engine(num_pages=3)   # 2 real pages = 32 tokens
    req = eng.submit(RU * 40, max_new_tokens=8)
    eng.step()
    assert req.done and req.finish_reason == "context" and not req.out


def test_custom_bucket_overflow_fails_the_request_not_the_engine():
    got = run(port_engine(prefill_buckets=(32,), num_pages=16),
              [RU * 30, EN], 4)
    want = run(jax_engine(prefill_buckets=(32,), num_pages=16), [RU * 30, EN], 4)
    assert got == want
    assert got[0] == ([], "context") and got[1][1] in ("stop", "length")


def test_default_bucket_ladder_includes_max_ctx():
    eng = port_engine(max_ctx=192, num_pages=16)
    assert eng.prefill_buckets[-1] == 192
    (out, reason), = run(eng, [RU * 12], 4)
    assert reason in ("stop", "length") and out


def test_stop_tokens_and_finish_reasons_match_jax():
    """A stop id ends a request with "stop" (the id itself is not emitted);
    otherwise "length", or "context" at max_ctx."""
    full = run(port_engine(), [RU], 12)[0][0]
    stop_at = next(i for i in range(3, 12) if full[i] not in full[:i])

    def stopped(eng):
        req = eng.submit(RU, max_new_tokens=12)
        req.stop_ids = frozenset({full[stop_at]})
        eng.run_until_done([req])
        return req.out, req.finish_reason

    assert stopped(port_engine()) == stopped(jax_engine()) == (
        full[:stop_at], "stop")
    eng = port_engine()
    stop_text = TOK.decode([TOK.special_tokens["<|im_end|>"]])
    assert stop_text == "<|im_end|>"
    got = run(eng, [RU], 200)
    assert got == run(jax_engine(), [RU], 200)
    assert got[0][1] in ("stop", "length", "context")


def test_temperature_sampling_is_seeded():
    """The numpy sampler with ``default_rng(seed)``: the same seed gives the
    same samples, and the JAX engine's (equal logits, equal draws)."""
    a = run(port_engine(seed=7), [RU], 10, temperature=0.8)
    b = run(port_engine(seed=7), [RU], 10, temperature=0.8)
    assert a == b
    assert a == run(jax_engine(seed=7), [RU], 10, temperature=0.8)


def test_sampler_top_p_top_k():
    eng = object.__new__(E.PagedLLMEngine)
    eng._rng = np.random.default_rng(0)
    logits = np.array([10.0, 9.0, 1.0, 0.0, -5.0])

    def req(**kw):
        base = dict(rid=0, ids=[], prompt_len=0, max_new_tokens=1,
                    temperature=1.0, top_p=1.0, top_k=0,
                    stop_ids=frozenset())
        base.update(kw)
        return E.Request(**base)

    assert eng._sample_row(logits, req(temperature=0.0)) == 0
    assert {eng._sample_row(logits, req(top_p=0.5)) for _ in range(200)} <= {0, 1}
    assert {eng._sample_row(logits, req(top_k=2)) for _ in range(200)} <= {0, 1}
    hot = {eng._sample_row(logits, req(temperature=50.0)) for _ in range(300)}
    assert len(hot) >= 4


def test_weights_carry_across_both_ways():
    """The port's own random weights, carried into the JAX engine, give
    the same ids as in the port's engine (JAX → port is every other test)."""
    cfg = Qwen3Config(dtype=torch.float32, **_dims("gqa"))
    tp = init_qwen3(torch.Generator().manual_seed(5), cfg)
    jp = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tp))
    assert (run(port_engine(params=tp), [EN], 10)
            == run(jax_engine(params=jp), [EN], 10))


def test_engine_loop_streams_tokens():
    loop = E.EngineLoop(port_engine()).start()
    try:
        req, q = loop.submit_stream(RU, max_new_tokens=8)
        got = []
        while (item := q.get(timeout=120)) is not None:
            got.append(item)
        assert req.done
        assert [t for t, _ in got if t is not None] == req.out
        assert "".join(text for _, text in got) == TOK.decode(req.out)
    finally:
        loop.stop()


def test_engine_loop_survives_step_failure():
    """A failed step drains a sentinel to every stream and refuses further
    submissions, instead of stranding ``q.get()``."""
    eng = port_engine()
    loop = E.EngineLoop(eng)
    req, q = loop.submit_stream(RU, max_new_tokens=4)

    def boom():
        raise RuntimeError("device exploded")

    eng.step = boom
    loop.start()
    while q.get(timeout=10) is not None:
        pass
    assert req.done and req.finish_reason == "error"
    assert loop.fatal is not None
    with pytest.raises(RuntimeError, match="died"):
        loop.submit_stream(EN)
    loop.stop()


def test_concurrent_streams_share_the_batch():
    """Two streams submitted from two threads each get their solo answer."""
    solo = {p: run(port_engine(), [p], 12)[0][0] for p in (RU, EN)}
    loop = E.EngineLoop(port_engine(max_slots=4)).start()
    got = {}

    def ask(p):
        req, q = loop.submit_stream(p, max_new_tokens=12)
        while q.get(timeout=120) is not None:
            pass
        got[p] = req.out

    try:
        threads = [threading.Thread(target=ask, args=(p,)) for p in (RU, EN)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        loop.stop()
    assert got == solo


def test_deferred_and_invalid_knobs_raise():
    """Nothing is deferred any more: W8A8, the int8-KV megakernel,
    ``attn_batched`` and the ablations construct (their routes are held to
    the JAX engine in ``tests/test_torch_engine_int8.py``); every
    combination the JAX engine refuses still raises ValueError."""
    for kw, knob in ((dict(weights="w8a8"), "w8a8"),
                     (dict(weights="int8", use_kernel=True, kv_dtype="int8",
                           layer_fused=True), "layer_fused"),
                     (dict(weights="int8", use_kernel=True,
                           attn_batched=True), "attn_batched"),
                     (dict(use_kernel=True, attn_batched=True),
                      "attn_batched")):
        assert getattr(port_engine(**kw), knob)
    for kw in (dict(mlp_fused=True), dict(layer_fused=True),
               dict(use_kernel=False, scatter_fused=True),
               dict(use_kernel=True, kv_dtype="int8", scatter_fused=True),
               dict(attn_batched=True), dict(max_ctx=250),
               dict(prefill_chunk=24), dict(weights="w8a8", mlp_fused=True),
               dict(use_kernel=True, kv_dtype="int8", attn_slot=True)):
        with pytest.raises(ValueError):
            port_engine(**kw)
    # the JAX package refuses the same ones
    for kw in (dict(weights="w8a8", mlp_fused=True),
               dict(use_kernel=True, kv_dtype="int8", attn_slot=True)):
        with pytest.raises(ValueError):
            jax_engine(**kw)
    # what moved out of the list: int8 weights, and slot-major attention
    # with native weights (legal in JAX: a plain write, then the kernel)
    assert port_engine(weights="int8").weights_int8
    assert port_engine(use_kernel=True, attn_slot=True).slot_pages
    eng = port_engine()
    z = torch.zeros((2,), dtype=torch.int32)
    logits = E._paged_decode(eng.params, eng.k_pool, eng.v_pool, eng.k_scale,
                             eng.v_scale, torch.from_numpy(eng.tables), z, z,
                             torch.ones((2,), dtype=torch.bool), eng.cfg,
                             False, eng._rope, ablate="noattn")
    assert logits.shape == (2, eng.cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_engine_defaults_to_the_card_with_the_kernel():
    cfg = Qwen3Config(dtype=torch.float32, **_dims("gqa"))
    if torch.cuda.is_available():
        eng = E.PagedLLMEngine(TP["gqa"], cfg, TOK)
        assert eng.device.type == "cuda" and eng.use_kernel
        assert eng.scatter_fused
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            E.PagedLLMEngine(TP["gqa"], cfg, TOK)
    cpu = port_engine()
    assert not cpu.use_kernel and not cpu.scatter_fused
