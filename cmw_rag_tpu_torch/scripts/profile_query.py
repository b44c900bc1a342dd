"""Where a batch of the shipping query path spends its time, on the card.

    python -m cmw_rag_tpu_torch.scripts.profile_query

Builds the shipping path that ``chip_smoke.py`` drives (``shipping.py``:
``frida-hybrid`` and the 4-member rerank ensemble over 1M x 5120 rows), on
the bf16 corpus and then on the int8 one. For each, after one warm-up batch
of the 8 planted texts, it times ``TIMED_BATCHES`` batches without the
profiler and ``PROFILED_BATCHES`` under ``torch.profiler``, and prints one
JSON line with, per batch: the host wall time without and with the
profiler; the device-busy time (union of CUDA kernel intervals) and the idle
share; the host time of each pipeline stage (the ``fused.*`` spans of
``retrieval/fused.py``; launches are asynchronous, so a stage's host time is
its enqueue cost); and the kernels that took the most device time. The
card's ``nvidia-smi`` name and power limit are printed beside it.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cmw_rag_tpu_torch.scripts.shipping import (PLANTED_TEXTS, TIMED_BATCHES,
                                                ShippingPath, card)

PROFILED_BATCHES = 5
#: host seconds between a profiler window's edges and its first and last
#: calls
EDGE_S = 0.002


def _is_kernel(e) -> bool:
    """A device-side event that is not a span annotation (``fused.*``)."""
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("fused."))


def _busy_us(events) -> float:
    """Union length of the CUDA kernel intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if _is_kernel(e))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def kernel_window(fn, iters: int, kernel: str | None = None,
                  tries: int = 3) -> tuple:
    """The CUDA kernel events of ``iters`` calls of ``fn`` under
    ``torch.profiler``, after one warm-up call and a warm-up profiler step
    (which turns the device tracing on before the window opens), with
    ``EDGE_S`` of host time at each edge of the window: → (the events, the
    windows dropped). With ``kernel``, a window counts only when complete:
    at least ``iters`` kernels whose name holds ``kernel`` (more are
    returned for the caller to refuse). Without it (a composite of several
    kernels a call), a window counts when it holds any kernel: never an
    empty one, but one that lost some of its events passes. The profiler
    on the card sometimes loses a window's events, in part or whole; a
    window short of its count is dropped and another taken, ``tries`` in
    all, then RuntimeError."""
    from torch.profiler import schedule

    fn()
    torch.cuda.synchronize()
    for dropped in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(EDGE_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
            prof.step()
        events = [e for e in prof.events() if _is_kernel(e)]
        named = [e for e in events if kernel is None or kernel in e.name]
        if len(named) >= (1 if kernel is None else iters):
            return events, dropped
    raise RuntimeError(f"{tries} profiler windows of {iters} calls were all "
                       f"incomplete (the last held {len(events)} kernels)")


def profile_batches(pipe, queries) -> dict:
    """Per-batch host wall, device busy, stage host times and top kernels."""
    pipe.query(queries)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_BATCHES):
        pipe.query(queries)
    torch.cuda.synchronize()
    plain_wall_ms = 1e3 * (time.perf_counter() - t0) / TIMED_BATCHES

    nb = PROFILED_BATCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(nb):
            pipe.query(queries)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / nb
    events = prof.events()
    busy_ms = _busy_us(events) / 1e3 / nb
    stages: dict[str, float] = defaultdict(float)
    kernels: dict[str, float] = defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("fused."):
            stages[e.name] += e.cpu_time_total / 1e3 / nb
        elif _is_kernel(e):
            kernels[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / nb
    return {
        "batch": len(queries), "timed_batches": TIMED_BATCHES,
        "profiled_batches": nb,
        "wall_ms_per_batch_unprofiled": plain_wall_ms,
        "wall_ms_per_batch": wall_ms, "device_busy_ms_per_batch": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "stage_host_ms_per_batch": dict(stages),
        "kernel_launches_per_batch": sum(1 for e in events if _is_kernel(e))
        / nb,
        "top_kernels_ms_per_batch":
            sorted(kernels.items(), key=lambda kv: -kv[1])[:12]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_query: CUDA is not available")
    card_line = card()
    path = ShippingPath()
    for quantize in (False, True):
        pipe = path.pipeline(quantize)
        print(json.dumps({"card": card_line, "quantize": quantize,
                          **profile_batches(pipe, PLANTED_TEXTS)}), flush=True)
        del pipe  # free this corpus before the next one is built
        torch.cuda.empty_cache()
    print(card_line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
