"""The local LLM serving path, as ``chip_smoke.py`` drives it.

    python -m cmw_rag_tpu_torch.scripts.local_llm [--weights int8|w8a8]
        [--slots 16] [--kv-dtype int8] [--layer-fused] [--attn-batched]
        [--ablate noattn|noscatter] [--prefill-chunk 256] [--reference]
        [--profile] [--device cuda]

Model: ``qwen3guard-0.6b`` (``cmw_rag_tpu/config/models.yaml:310-331``), the
spec the JAX package's ``create_local_llm_manager`` serves by default, at
full width and depth (d 1024, d_ff 3072, 28 layers, 16 query and 8 KV heads
of 128, vocabulary 151,680, tied embeddings), bf16, with random weights from
a seeded CPU generator: the repository holds no converted checkpoint, so
runs read token ids and never quality.

Serving shape: the port's ``Settings`` (``config/settings.py:125-132``): 4
slots, a 2,048-token context, 64-token pages (``local_transport.py:162``),
native weights and KV pages. The int8 configuration is the reference's own
``local_llm_weights = "int8"`` ("half memory", ``settings.py:130``): at 4
slots each layer is one decoder-layer megakernel launch, at 16 slots the
fused QKV ``int8_matmul``, slot-major attention and the fused MLP
(``INT8_SLOTS``). ``--weights w8a8`` quantizes the activations too
(``int8_matmul_w8a8`` for every product and the head); ``--kv-dtype int8
--layer-fused`` forces the int8-KV megakernel; ``--attn-batched`` takes the
batched attention alias; ``--ablate`` runs a diagnosis ablation (wrong
outputs on purpose). ``--profile`` then profiles one decode step at 4
active slots (``profile_decode``) and prints it as JSON. Requests: ChatML (``format_chatml``) of the 8
bilingual texts that the shipping path plants (``scripts/shipping.py``),
greedy, 32 new tokens each; with more requests than slots, later ones are
admitted mid-flight.

With random weights at the full vocabulary, greedy ids reach rows the
bundled 16k BPE cannot decode, as in the JAX package, whose tokenizer raises
``KeyError`` there: so this path reads ids, and the transport run uses the
tokenizer's vocabulary instead (``spec_with_tokenizer_vocab``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from cmw_rag_tpu_torch.config import Settings, get_guard_model
from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.llm.local_transport import format_chatml
from cmw_rag_tpu_torch.models.engine import (PagedLLMEngine, Request,
                                             _paged_decode)
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3
from cmw_rag_tpu_torch.scripts.profile_query import _busy_us, _is_kernel
from cmw_rag_tpu_torch.scripts.shipping import PLANTED_TEXTS
from cmw_rag_tpu_torch.tokenizer import get_tokenizer

SPEC = "qwen3guard-0.6b"
PAGE = 64
N_REQUESTS = 6
MAX_NEW_TOKENS = 32
TIMED_STEPS = 20
PROFILED_STEPS = 5
#: the int8-weight serving configurations: slots -> the route they take
INT8_SLOTS = {4: "decoder-layer megakernel", 16: "int8_matmul + slot "
              "attention + fused MLP"}
#: device-side name of the paged attention kernel (one launch a call)
PAGED_KERNEL_NAMES = ("paged_decode_kernel",)
#: device-side name of the decoder-layer megakernel (both pool types)
LAYER_KERNEL_NAMES = ("decoder_layer_kernel",)
#: device-side name of the W8A8 matmul (one kernel a call, the activation
#: quantization and the merge of its splits inside it)
W8A8_KERNEL_NAMES = ("w8a8_mma_kernel",)
#: device-side name of the fused MLP (int8 weights past the megakernel's
#: route: past 8 slots, or int8 KV)
MLP_KERNEL_NAMES = ("fused_mlp_kernel",)


def spec_with_tokenizer_vocab(slug: str = SPEC):
    """The spec with ``vocab_size`` 0: ``create_local_llm_transport`` then
    takes the tokenizer's vocabulary, rounded up to 128 (as the JAX
    package's own tests of ``create_local_llm_manager`` do)."""
    return dataclasses.replace(get_guard_model(slug), vocab_size=0)


def config(slug: str = SPEC) -> Qwen3Config:
    spec = get_guard_model(slug)
    return Qwen3Config(vocab_size=spec.vocab_size, d_model=spec.d_model,
                       d_ff=spec.d_ff, num_layers=spec.num_layers,
                       num_heads=spec.num_heads,
                       num_kv_heads=spec.num_kv_heads,
                       head_dim=spec.head_dim, dtype=torch.bfloat16)


def build_params(cfg: Qwen3Config, seed: int = 0, device="cuda"):
    """Random parameters drawn from a seeded CPU generator, on ``device``."""
    return init_qwen3(torch.Generator().manual_seed(seed), cfg,
                      device=resolve_device(device))


def chat_prompts(n: int = N_REQUESTS) -> list[str]:
    return [format_chatml([{"role": "user", "content": t}])
            for t in PLANTED_TEXTS[:n]]


def long_chat_prompt(min_tokens: int = 400) -> str:
    """One ChatML request of the planted texts, repeated until its prompt has
    more than ``min_tokens`` tokens: a context past the slot-major budget
    (384 tokens at this width), so the megakernel takes its paged route
    while the request is in flight."""
    tok = get_tokenizer()
    text = ""
    while True:
        text += " ".join(PLANTED_TEXTS) + "\n"
        prompt = format_chatml([{"role": "user", "content": text}])
        if len(tok.encode(prompt, allowed_special="all")) > min_tokens:
            return prompt


def build_engine(params, cfg: Qwen3Config, device="cuda", engine_cls=None,
                 **engine_kw) -> PagedLLMEngine:
    """An engine at the serving settings; ``engine_kw`` overrides
    (``use_kernel``, ``weights``, ``max_slots``, ``kv_dtype``,
    ``prefill_chunk``, ``scatter_fused``, ...)."""
    s = Settings()
    kw = dict(max_slots=s.local_llm_slots, page_size=PAGE,
              max_ctx=s.local_llm_max_ctx, kv_dtype=s.local_llm_kv_dtype,
              device=device)
    kw.update(engine_kw)
    return (engine_cls or PagedLLMEngine)(params, cfg, get_tokenizer(), **kw)


def run_requests(engine: PagedLLMEngine, prompts: list[str],
                 max_new_tokens: int = MAX_NEW_TOKENS) -> list[Request]:
    """Submit every prompt (greedy) and step until all are done."""
    reqs = [engine.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    engine.run_until_done(reqs)
    return reqs


@torch.no_grad()
def profile_decode(engine: PagedLLMEngine,
                   names: tuple = PAGED_KERNEL_NAMES) -> dict:
    """Where one decode step of ``engine``'s current state spends its time,
    on a card: the step is repeated as it stands (it writes the same rows
    each time), ``TIMED_STEPS`` times without the profiler and
    ``PROFILED_STEPS`` under ``torch.profiler``. → host wall per step
    without and with the profiler, device busy (union of kernel intervals)
    and idle share, the device time and share of the kernels whose names
    contain one of ``names`` (the paged attention kernel by default,
    ``LAYER_KERNEL_NAMES`` for the megakernel), launches per step, and the
    kernels that took the most device time."""
    active = engine._active_mask()
    tables, lens = engine._dev(engine.tables), engine._dev(engine.lens)
    cur, act = engine._dev(engine.cur_ids), engine._dev(active)
    options = engine.decode_options(active)

    def step():
        return _paged_decode(
            engine.params, engine.k_pool, engine.v_pool, engine.k_scale,
            engine.v_scale, tables, lens, cur, act, engine.cfg,
            engine.use_kernel, engine._rope, **options)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    n = PROFILED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    events = prof.events()
    kernels: dict[str, float] = defaultdict(float)
    launches = 0
    for e in events:
        if _is_kernel(e):
            kernels[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / n
            launches += 1
    busy_ms = _busy_us(events) / 1e3 / n
    named = {k: v for k, v in kernels.items() if any(p in k for p in names)}
    return {
        "active_slots": int(active.sum()),
        "context_lens": [int(x) for x in engine.lens[active]],
        "route": {k: v for k, v in options.items() if v},
        "wall_ms_per_step_unprofiled": plain_ms,
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "named_kernels": list(names),
        "named_kernel_ms_per_step": sum(named.values()),
        "named_share_of_busy": sum(named.values()) / busy_ms,
        "kernel_launches_per_step": launches / n,
        "top_kernels_ms_per_step":
            sorted(kernels.items(), key=lambda kv: -kv[1])[:10]}


def profile_names(engine: PagedLLMEngine) -> tuple:
    """The kernels whose share ``profile_decode`` reports for the engine's
    route: the megakernel, the W8A8 matmul, the fused MLP, or the paged
    kernel."""
    if engine.layer_fused:
        return LAYER_KERNEL_NAMES
    if engine.w8a8:
        return W8A8_KERNEL_NAMES
    return MLP_KERNEL_NAMES if engine.mlp_fused else PAGED_KERNEL_NAMES


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default="native",
                    choices=("native", "int8", "w8a8"))
    ap.add_argument("--slots", type=int, default=None,
                    help="serving slots (default: the settings' 4)")
    ap.add_argument("--kv-dtype", default="native", choices=("native", "int8"))
    ap.add_argument("--layer-fused", action="store_true",
                    help="force the decoder-layer megakernel (int8 weights)")
    ap.add_argument("--attn-batched", action="store_true",
                    help="the batched attention alias (native KV)")
    ap.add_argument("--ablate", default="", choices=("", "noattn",
                                                     "noscatter"))
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--reference", action="store_true",
                    help="the gather golden instead of the paged kernel")
    ap.add_argument("--profile", action="store_true",
                    help="then profile one decode step at 4 active slots")
    ap.add_argument("--max-new-tokens", type=int, default=MAX_NEW_TOKENS)
    args = ap.parse_args()
    cfg = config()
    params = build_params(cfg, args.seed, args.device)
    kw = {} if args.slots is None else dict(max_slots=args.slots)
    if args.layer_fused:
        kw["layer_fused"] = True
    engine = build_engine(params, cfg, args.device, kv_dtype=args.kv_dtype,
                          prefill_chunk=args.prefill_chunk,
                          weights=args.weights,
                          attn_batched=args.attn_batched, ablate=args.ablate,
                          use_kernel=False if args.reference else None, **kw)
    t0 = time.perf_counter()
    reqs = run_requests(engine, chat_prompts(), args.max_new_tokens)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    for r in reqs:
        print(f"request {r.rid}: {r.finish_reason}, prompt {r.prompt_len} "
              f"tokens, ids {r.out}")
    n_out = sum(len(r.out) for r in reqs)
    print(f"decode steps {engine.decode_steps}, {n_out} tokens in {wall:.3f} s "
          f"(host clock, prefill included)")
    if args.profile:
        for p in chat_prompts(4):
            engine.submit(p, max_new_tokens=64)
        for _ in range(16):
            engine.step()
        print(json.dumps(profile_decode(engine, profile_names(engine))))


if __name__ == "__main__":
    main()
