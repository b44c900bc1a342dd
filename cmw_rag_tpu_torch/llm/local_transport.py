"""In-process LLM provider: an OpenAI-compatible *transport* backed by the
port's Qwen3-class model (port of ``cmw_rag_tpu/llm/local_transport.py``).

A transport is ``transport(url, payload, headers, timeout, stream)`` →
response, the callable the JAX package's ``LLMManager`` posts through; with
this one the model runs inside the serving process (the role vLLM plays in
the reference topology). Both wire shapes the client consumes are kept byte
for byte: the JSON body and the SSE stream, with the same usage counts and
the same ``model`` default.
"""

from __future__ import annotations

import dataclasses
import io
import json
import time
from typing import Any, Callable, Optional

import torch

from cmw_rag_tpu_torch.config import GuardModelSpec, get_guard_model
from cmw_rag_tpu_torch.device import resolve_device
from cmw_rag_tpu_torch.models.engine import EngineLoop, PagedLLMEngine
from cmw_rag_tpu_torch.models.generate import generate
from cmw_rag_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3, qwen3_layout
from cmw_rag_tpu_torch.models.weights import load_params_npz
from cmw_rag_tpu_torch.tokenizer import get_tokenizer


def format_chatml(messages: list[dict[str, Any]]) -> str:
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content") or ""
        if role == "tool":
            role = "user"
            content = f"[tool:{m.get('name', '')}] {content}"
        parts.append(f"<|im_start|>{role}\n{content}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


class _Response(io.BytesIO):
    status = 200


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def _json_body(model: str, text: str, finish_reason: str, usage: dict) -> bytes:
    return json.dumps({
        "id": f"local-{int(time.time() * 1000)}",
        "model": model,
        "choices": [{"index": 0, "finish_reason": finish_reason,
                     "message": {"role": "assistant", "content": text}}],
        "usage": usage,
    }).encode()


def make_local_transport(params, cfg: Qwen3Config, tokenizer,
                         max_len: int = 2048, default_max_tokens: int = 256):
    """→ transport(url, payload, headers, timeout, stream) over one
    ``models.generate.generate`` call a request."""

    def transport(url: str, payload: bytes, headers: dict, timeout: float,
                  stream: bool):
        body = json.loads(payload)
        prompt = format_chatml(body.get("messages") or [])
        temperature = float(body.get("temperature") or 0.0)
        max_new = int(body.get("max_tokens") or default_max_tokens)
        text = generate(params, cfg, tokenizer, prompt, max_new_tokens=max_new,
                        temperature=temperature, max_len=max_len)
        usage = _usage(len(tokenizer.encode(prompt, allowed_special="all")),
                       len(tokenizer.encode(text)))
        model = body.get("model", "local-tpu")
        if not body.get("stream"):
            return _Response(_json_body(model, text, "stop", usage))
        # SSE: the text in a few delta chunks, then usage and [DONE]
        out = b""
        step = max(1, len(text) // 4)
        for i in range(0, len(text) or 1, step):
            chunk = {"choices": [{"index": 0,
                                  "delta": {"content": text[i:i + step]}}]}
            out += b"data: " + json.dumps(chunk, ensure_ascii=False).encode() + b"\n\n"
        out += b"data: " + json.dumps(
            {"choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}],
             "usage": usage}).encode() + b"\n\n"
        out += b"data: [DONE]\n\n"
        return _Response(out)

    return transport


class _EngineSSE:
    """Iterable SSE response over a live engine stream: tokens become
    ``data:`` delta lines as the engine decodes them, then usage and
    [DONE]."""

    status = 200

    def __init__(self, req, q, tokenizer, model: str):
        self._req = req
        self._q = q
        self._tok = tokenizer
        self._model = model

    def read(self) -> bytes:  # error-path compat with urllib responses
        return b""

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            _, text = item
            chunk = {"model": self._model,
                     "choices": [{"index": 0, "delta": {"content": text}}]}
            yield b"data: " + json.dumps(chunk, ensure_ascii=False).encode() + b"\n\n"
        yield b"data: " + json.dumps({
            "choices": [{"index": 0, "delta": {},
                         "finish_reason": self._req.finish_reason or "stop"}],
            "usage": _usage(self._req.prompt_len, len(self._req.out)),
        }).encode() + b"\n\n"
        yield b"data: [DONE]\n\n"


def make_engine_transport(loop: EngineLoop, tokenizer,
                          default_max_tokens: int = 256):
    """OpenAI-compatible transport over a running :class:`EngineLoop`
    (continuous batching: concurrent requests share the decode batch)."""

    def transport(url: str, payload: bytes, headers: dict, timeout: float,
                  stream: bool):
        body = json.loads(payload)
        prompt = format_chatml(body.get("messages") or [])
        temperature = float(body.get("temperature") or 0.0)
        max_new = int(body.get("max_tokens") or default_max_tokens)
        model = body.get("model", "local-tpu")
        req, q = loop.submit_stream(
            prompt, max_new_tokens=max_new, temperature=temperature,
            top_p=float(body.get("top_p") or 1.0),
            top_k=int(body.get("top_k") or 0))
        if body.get("stream"):
            return _EngineSSE(req, q, tokenizer, model)
        while q.get() is not None:
            pass
        return _Response(_json_body(
            model, tokenizer.decode(req.out), req.finish_reason or "stop",
            _usage(req.prompt_len, len(req.out))))

    return transport


@dataclasses.dataclass
class LocalLLM:
    """What ``create_local_llm_transport`` built; stop ``engine_loop`` (when
    there is one) to shut it down."""

    transport: Callable
    cfg: Qwen3Config
    params: dict
    engine_loop: Optional[EngineLoop] = None


def create_local_llm_transport(spec: Optional[GuardModelSpec] = None,
                               tokenizer=None, params=None, seed: int = 0,
                               max_len: int = 2048,
                               dtype: Optional[torch.dtype] = None,
                               continuous_batching: bool = False,
                               max_slots: int = 4, page_size: int = 64,
                               use_kernel: Optional[bool] = None,
                               checkpoint: Optional[str] = None,
                               weights: str = "native",
                               kv_dtype: str = "native",
                               layer_fused: Optional[bool] = None,
                               device: str | torch.device = "cuda") -> LocalLLM:
    """The engine-building half of the JAX package's
    ``create_local_llm_manager`` (``local_transport.py:188-217``): the spec
    (``qwen3guard-0.6b`` by default) becomes a ``Qwen3Config`` whose
    vocabulary is the larger of the spec's and the tokenizer's, rounded up
    to 128; the parameters are drawn from ``seed`` (a CPU generator) unless
    given or loaded from ``checkpoint`` (an npz in the JAX layout); with
    ``continuous_batching`` a ``PagedLLMEngine`` behind a started
    ``EngineLoop`` serves the transport, else one ``generate`` call per
    request. ``weights`` is "native", "int8" or "w8a8" and reaches the
    engine as it is, as does ``kv_dtype``; ``layer_fused`` folds as the JAX
    factory folds it: on only with the kernel route and int8 weights,
    ``None`` keeps the engine's default. The other half, wrapping the
    transport in an ``LLMManager``,
    waits for the port of the manager (``llm/manager.py``, which imports no
    pydantic) and its stdlib helpers, which is not done yet (``ROADMAP.md``
    Queue 1 item 3); hence this name and the ``LocalLLM`` it returns
    instead of a manager."""
    dev = resolve_device(device)
    tokenizer = tokenizer or get_tokenizer()
    spec = spec or get_guard_model("qwen3guard-0.6b")
    vocab = -(-max(spec.vocab_size, tokenizer.n_vocab) // 128) * 128
    cfg = Qwen3Config(
        vocab_size=vocab, d_model=spec.d_model, d_ff=spec.d_ff,
        num_layers=spec.num_layers, num_heads=spec.num_heads,
        num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
        dtype=dtype or torch.bfloat16)
    if params is None:
        if checkpoint:
            params = load_params_npz(qwen3_layout(cfg), checkpoint, device=dev)
        else:
            params = init_qwen3(torch.Generator().manual_seed(seed), cfg,
                                device=dev)
    if not continuous_batching:
        return LocalLLM(make_local_transport(params, cfg, tokenizer,
                                             max_len=max_len), cfg, params)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    engine = PagedLLMEngine(
        params, cfg, tokenizer, max_slots=max_slots, page_size=page_size,
        max_ctx=max_len, use_kernel=use_kernel, weights=weights,
        kv_dtype=kv_dtype, device=dev,
        layer_fused=(None if layer_fused is None else
                     (layer_fused and use_kernel and weights == "int8")))
    loop = EngineLoop(engine).start()
    return LocalLLM(make_engine_transport(loop, tokenizer), cfg, params, loop)
