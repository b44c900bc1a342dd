"""The port's paged-KV engine with int8 weights (``weights="int8"``) on the
CPU against the JAX package's: the same float32 weights (quantized by each
package from the same tree), the same requests, the same greedy token ids
and finish reasons, on the tiny float32 config of ``tests/test_engine.py``
(2 layers, d 64, 4 heads, 2 KV heads, head_dim 16, the tokenizer's
vocabulary; 2 slots, 16-token pages, a 256-token context).

The JAX engine runs its Pallas kernels in interpret mode
(``kernel_interpret=True``); the port's kernel route runs the kernels' plain
twins, which keep the TPU kernels' rounding points. Each route of the JAX
engine's defaults is held: the decoder-layer megakernel with slot-major
attention and with paged attention, the unfused int8 route (slot-major
attention and the fused MLP), the int8 products without the fused MLP, int8
KV pages, slot-major attention with native weights, the float32 golden and
chunked prefill; and the routes a caller selects: W8A8 weights, the int8-KV
megakernel (``layer_fused=True`` with int8 KV) and the batched attention
alias (native weights through the unfused scatter-free route, and int8
weights, where the megakernel gets ``batched=True``). Ids are held equal:
float32 sums in another order move the logits by ~1e-6, and these runs
meet no top-2 gap that small (the W8A8 twin's activation scale is one
float32 step from the jitted JAX one at most, ``tests/test_torch_w8a8.py``).
The decode ablations, diagnosis knobs with wrong outputs on purpose, are
held by their logits: one ``_paged_decode`` step from the same state in
both packages, within 1e-4 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmw_rag_tpu.models import engine as JE
from cmw_rag_tpu.models.qwen3 import Qwen3Config as JConfig
from cmw_rag_tpu.models.qwen3 import init_qwen3 as jax_init
from cmw_rag_tpu.tokenizer import get_tokenizer as jax_tokenizer
from cmw_rag_tpu_torch.config import GuardModelSpec
from cmw_rag_tpu_torch.llm import local_transport as T
from cmw_rag_tpu_torch.models import engine as E
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config
from cmw_rag_tpu_torch.models.weights import params_from_jax
from cmw_rag_tpu_torch.ops import decoder_layer as DL
from cmw_rag_tpu_torch.ops import fused_mlp as FM
from cmw_rag_tpu_torch.ops import int8_matmul as IM
from cmw_rag_tpu_torch.ops import paged_attention as PA
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

TOK, JTOK = get_tokenizer(), jax_tokenizer()
DIMS = dict(vocab_size=TOK.n_vocab, d_model=64, d_ff=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16)
JP = jax_init(jax.random.PRNGKey(0), JConfig(dtype=jnp.float32, **DIMS))
TP = params_from_jax(jax.tree.map(np.asarray, JP))
RU = "Как настроить процесс в системе?"
EN = "What is the license cost?"
BASE = dict(max_slots=2, page_size=16, max_ctx=256)
TINY = GuardModelSpec(slug="tiny-lm", arch="qwen3", d_model=64, d_ff=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)

#: route -> (engine keywords, what the port's engine must pick)
ROUTES = {
    "megakernel-slot": (dict(weights="int8", use_kernel=True),
                        dict(layer_fused=True, attn_slot=True)),
    "megakernel-paged": (dict(weights="int8", use_kernel=True,
                              attn_slot=False),
                         dict(layer_fused=True, attn_slot=False)),
    "unfused-slot": (dict(weights="int8", use_kernel=True, layer_fused=False),
                     dict(layer_fused=False, attn_slot=True, mlp_fused=True)),
    "int8-products": (dict(weights="int8", use_kernel=True, layer_fused=False,
                           mlp_fused=False, attn_slot=False),
                      dict(layer_fused=False, mlp_fused=False,
                           scatter_fused=True)),
    "int8-kv": (dict(weights="int8", use_kernel=True, kv_dtype="int8"),
                dict(layer_fused=False, attn_slot=False, mlp_fused=True)),
    "native-slot": (dict(use_kernel=True, attn_slot=True),
                    dict(attn_slot=True, mlp_fused=False)),
    "golden": (dict(weights="int8", use_kernel=False),
               dict(layer_fused=False, attn_slot=False, mlp_fused=False)),
    "chunked": (dict(weights="int8", use_kernel=True, prefill_chunk=32),
                dict(layer_fused=True, attn_slot=True)),
    "w8a8": (dict(weights="w8a8", use_kernel=True),
             dict(layer_fused=False, mlp_fused=False, attn_slot=False,
                  scatter_fused=True, w8a8=True)),
    "w8a8-golden": (dict(weights="w8a8", use_kernel=False),
                    dict(layer_fused=False, w8a8=True)),
    "int8-kv-megakernel": (dict(weights="int8", use_kernel=True,
                                kv_dtype="int8", layer_fused=True),
                           dict(layer_fused=True, attn_slot=False)),
    "attn-batched": (dict(use_kernel=True, attn_batched=True,
                          scatter_fused=False),
                     dict(attn_batched=True, attn_slot=False)),
    "attn-batched-int8": (dict(weights="int8", use_kernel=True,
                               attn_batched=True, attn_slot=False),
                          dict(attn_batched=True, layer_fused=True)),
}
#: the wrappers each route's kernel steps must reach (their twins, here)
REACHES = {"megakernel-slot": ("decoder_layer_int8", "int8_matmul"),
           "megakernel-paged": ("decoder_layer_int8", "int8_matmul"),
           "unfused-slot": ("paged_decode_attention_dma_slot",
                            "fused_mlp_int8", "int8_matmul"),
           "int8-products": ("paged_decode_attention_dma_scatter",
                             "int8_matmul"),
           "int8-kv": ("paged_decode_attention_dma_kv_int8",
                       "fused_mlp_int8", "int8_matmul"),
           "native-slot": ("paged_decode_attention_dma_slot",),
           "golden": (), "chunked": ("decoder_layer_int8", "int8_matmul"),
           "w8a8": ("paged_decode_attention_dma_scatter", "int8_matmul_w8a8"),
           "w8a8-golden": (),
           "int8-kv-megakernel": ("decoder_layer_int8_kv8", "int8_matmul"),
           "attn-batched": ("paged_decode_attention_dma_batched",),
           "attn-batched-int8": ("decoder_layer_int8", "int8_matmul")}
WRAPPERS = {"decoder_layer_int8": DL.decoder_layer_int8,
            "decoder_layer_int8_kv8": DL.decoder_layer_int8_kv8,
            "fused_mlp_int8": FM.fused_mlp_int8,
            "int8_matmul": IM.int8_matmul,
            "int8_matmul_w8a8": IM.int8_matmul_w8a8,
            "paged_decode_attention_dma_batched":
                PA.paged_decode_attention_dma_batched,
            "paged_decode_attention_dma_slot":
                PA.paged_decode_attention_dma_slot,
            "paged_decode_attention_dma_scatter":
                PA.paged_decode_attention_dma_scatter,
            "paged_decode_attention_dma_kv_int8":
                PA.paged_decode_attention_dma_kv_int8}


def jax_engine(**kw):
    kw = dict(BASE, **kw)
    if kw.get("use_kernel"):
        kw["kernel_interpret"] = True
    return JE.PagedLLMEngine(JP, JConfig(dtype=jnp.float32, **DIMS), JTOK,
                             **kw)


def port_engine(**kw):
    return E.PagedLLMEngine(TP, Qwen3Config(dtype=torch.float32, **DIMS), TOK,
                            **dict(BASE, device="cpu", **kw))


def run(engine, prompts, max_new_tokens):
    reqs = [engine.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    engine.run_until_done(reqs)
    return [(r.out, r.finish_reason) for r in reqs]


def _spy(monkeypatch, calls):
    """Count each kernel wrapper's calls (on the CPU they run the twins)."""
    for name, fn in WRAPPERS.items():
        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        for mod in (E, PA, DL, FM, IM):
            if getattr(mod, name, None) is fn:
                monkeypatch.setattr(mod, name, wrapped)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_int8_routes_give_the_jax_greedy_ids(route, monkeypatch):
    kw, picks = ROUTES[route]
    prompts = [RU * 4, EN] if route == "chunked" else [RU, EN]
    want = run(jax_engine(**kw), prompts, 10)
    eng = port_engine(**kw)
    for knob, value in picks.items():
        assert getattr(eng, knob) == value, knob
    assert eng.weights_int8 == (kw.get("weights") in ("int8", "w8a8"))
    calls: dict = {}
    _spy(monkeypatch, calls)
    assert run(eng, prompts, 10) == want
    assert set(calls) == set(REACHES[route])
    if eng.weights_int8:
        assert eng.params["layers"][0]["wqkv_q"].dtype == torch.int8
    if eng.slot_pages:
        assert eng.free_pages == eng.maxp * 2


def test_slot_pages_are_the_partitions():
    eng = port_engine(weights="int8", use_kernel=True)
    reqs = [eng.submit(p, max_new_tokens=20) for p in (RU, EN)]
    for _ in range(3):
        eng.step()
    for slot in range(2):
        n = -(-int(eng.lens[slot]) // eng.page)
        assert eng.tables[slot, :n].tolist() == [
            1 + slot * eng.maxp + j for j in range(n)]
    assert eng.free_pages == 0
    opts = eng.decode_options(eng._active_mask())
    assert opts["slot_cap"] == -(-(int(eng.lens.max()) + 1) // eng.page)
    eng.run_until_done(reqs)
    assert eng.free_pages == 2 * eng.maxp and not eng.tables.any()


def test_slot_route_falls_back_as_in_jax(monkeypatch):
    """Slot-major buffers over the TPU budget, or the megakernel past 8
    slots, take the paged route, as the JAX engine does."""
    seen = []
    real = DL.decoder_layer_int8

    def spy(*a, **k):
        seen.append(k["attn_slot"])
        return real(*a, **k)

    monkeypatch.setattr(E, "decoder_layer_int8", spy)
    eng = port_engine(weights="int8", use_kernel=True)
    eng.generate([RU], max_new_tokens=3)
    assert seen and all(seen)
    seen.clear()
    monkeypatch.setattr(E, "SLOT_ATTN_VMEM_LIMIT", 0)
    eng.generate([RU], max_new_tokens=3)
    assert seen and not any(seen)
    monkeypatch.undo()
    monkeypatch.setattr(E, "decoder_layer_int8", spy)
    seen.clear()
    wide = port_engine(weights="int8", use_kernel=True, max_slots=9,
                       layer_fused=True)
    assert wide.attn_slot and wide.slot_pages
    wide.generate([RU, EN], max_new_tokens=3)
    assert seen and not any(seen)


def test_deferred_and_invalid_int8_knobs_raise():
    """Every combination the JAX engine refuses raises ValueError in both
    packages (none is deferred any more: W8A8, the int8-KV megakernel and
    attn_batched are routes above); an unknown ablation raises in the
    port, whose engine takes the knob."""
    for kw in (dict(weights="w8a8", mlp_fused=True),
               dict(weights="w8a8", use_kernel=True, mlp_fused=True),
               dict(weights="w8a8", use_kernel=True, layer_fused=True),
               dict(weights="int8", use_kernel=True, kv_dtype="int8",
                    attn_batched=True),
               dict(use_kernel=False, attn_batched=True),
               dict(weights="int8", use_kernel=True, kv_dtype="int8",
                    attn_slot=True),
               dict(weights="int8", use_kernel=True, num_pages=8,
                    attn_slot=True),
               dict(weights="int8", layer_fused=True)):
        with pytest.raises(ValueError):
            port_engine(**kw)
        with pytest.raises(ValueError):
            jax_engine(**kw)
    with pytest.raises(ValueError, match="ablate"):
        port_engine(use_kernel=True, ablate="nomlp")


def _same_state(n_steps: int = 3, **kw):
    """A JAX and a port engine after the same admissions and steps."""
    je, pe = jax_engine(**kw), port_engine(**kw)
    for eng in (je, pe):
        for p in (RU, EN):
            eng.submit(p, max_new_tokens=10)
        for _ in range(n_steps):
            eng.step()
    assert je.lens.tolist() == pe.lens.tolist()
    assert je.cur_ids.tolist() == pe.cur_ids.tolist()
    return je, pe


@pytest.mark.parametrize("ablate", ["noattn", "noscatter"])
def test_ablations_give_the_jax_logits(ablate):
    je, pe = _same_state(use_kernel=True)
    active = pe._active_mask()
    want, *_ = JE._paged_decode(
        je.params, je.k_pool, je.v_pool, je.k_scale, je.v_scale,
        jnp.asarray(je.tables), jnp.asarray(je.lens), jnp.asarray(je.cur_ids),
        jnp.asarray(active), je.cfg, True, True, chunk=je.chunk,
        ablate=ablate, scatter_fused=je.scatter_fused)
    k_before = pe.k_pool.clone()
    opts = pe.decode_options(active)
    full = E._paged_decode(
        pe.params, pe.k_pool.clone(), pe.v_pool.clone(), pe.k_scale,
        pe.v_scale, pe._dev(pe.tables), pe._dev(pe.lens),
        pe._dev(pe.cur_ids), pe._dev(active), pe.cfg, True, pe._rope, **opts)
    got = E._paged_decode(
        pe.params, pe.k_pool, pe.v_pool, pe.k_scale, pe.v_scale,
        pe._dev(pe.tables), pe._dev(pe.lens), pe._dev(pe.cur_ids),
        pe._dev(active), pe.cfg, True, pe._rope, **dict(opts, ablate=ablate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert not torch.allclose(got, full, atol=1e-3)    # it did ablate
    assert torch.equal(pe.k_pool, k_before) == (ablate == "noscatter")


@pytest.mark.parametrize("layer_fused", [None, True, False])
@pytest.mark.parametrize("weights,use_kernel", [("int8", True),
                                                ("int8", False),
                                                ("native", True),
                                                ("w8a8", True)])
def test_transport_folds_layer_fused_as_jax(layer_fused, weights, use_kernel,
                                            monkeypatch):
    """``create_local_llm_transport(layer_fused=...)`` hands the engine what
    the JAX factory hands it: ``None``, or the flag and the kernel route and
    int8 weights."""
    seen = {}

    class Probe:
        def __init__(self, *a, **kw):
            seen.update(kw)
            raise RuntimeError("probe")

    monkeypatch.setattr(T, "PagedLLMEngine", Probe)
    with pytest.raises(RuntimeError, match="probe"):
        T.create_local_llm_transport(
            spec=TINY, tokenizer=TOK, continuous_batching=True,
            use_kernel=use_kernel, weights=weights, layer_fused=layer_fused,
            dtype=torch.float32, device="cpu")
    want = (None if layer_fused is None else
            (layer_fused and use_kernel and weights == "int8"))
    assert seen["layer_fused"] == want and seen["weights"] == weights


@pytest.mark.parametrize("kw,picks", [
    (dict(weights="w8a8"), dict(w8a8=True, layer_fused=False)),
    (dict(weights="int8", kv_dtype="int8", layer_fused=True),
     dict(kv_int8=True, layer_fused=True)),
    (dict(weights="w8a8", layer_fused=True),
     dict(w8a8=True, layer_fused=False))],
    ids=["w8a8", "int8-kv-megakernel", "w8a8-layer-fused-folds"])
def test_transport_serves_the_new_routes(kw, picks):
    """``create_local_llm_transport`` hands W8A8 weights and the forced
    int8-KV megakernel to the engine, which serves a request on each;
    ``layer_fused=True`` with W8A8 folds off as in the JAX factory instead
    of reaching the engine's refusal."""
    llm = T.create_local_llm_transport(
        spec=TINY, tokenizer=TOK, max_len=256, page_size=16,
        dtype=torch.float32, continuous_batching=True, use_kernel=True,
        device="cpu", **kw)
    try:
        eng = llm.engine_loop.engine
        for knob, value in picks.items():
            assert getattr(eng, knob) == value, knob
        req, q = llm.engine_loop.submit_stream(RU, max_new_tokens=4)
        while q.get(timeout=120) is not None:
            pass
        assert req.done and req.out and llm.engine_loop.fatal is None
    finally:
        llm.engine_loop.stop()


def test_transport_serves_int8_weights():
    llm = T.create_local_llm_transport(
        spec=TINY, tokenizer=TOK, max_len=256, page_size=16,
        dtype=torch.float32, continuous_batching=True, use_kernel=True,
        weights="int8", device="cpu")
    try:
        eng = llm.engine_loop.engine
        assert eng.weights_int8 and eng.layer_fused and eng.attn_slot
        req, q = llm.engine_loop.submit_stream(RU, max_new_tokens=6)
        while q.get(timeout=120) is not None:
            pass
        assert req.done and req.out
    finally:
        llm.engine_loop.stop()
