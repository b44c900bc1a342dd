"""Time the slot-major decode attention kernel (``csrc/slot_attention.cu``)
through two versions of its wrapper in one process, in alternating pairs.

    python -m cmw_rag_tpu_torch.scripts.slot_pairs BASE_ROOT [--pairs 10]

BASE_ROOT is another checkout whose ``csrc/slot_attention.cu`` and
``csrc/int8_decode.cuh`` are this checkout's (the script refuses others):
both wrappers then launch the one library built from them, and only what a
wrapper does around its launch differs (scratch, counters). The base's
``ops/paged_attention.py`` is loaded as a module of its own, over this
checkout's ``device`` and ``cuda_build``. At phase 9's shapes of
``chip_smoke.py`` (qwen3guard-0.6b's heads, 28 layers, page 64, 32 pages a
slot; 4 slots at cap 6 with lengths 65, 200 and 384, and 16 slots at cap
6; an idle slot each), the two wrappers' outputs must agree bit for bit;
then each pair times 56 calls of each wrapper over the layers in turn,
the base first in even pairs and this checkout first in odd ones: the mean
device time of the slot kernel's events in a complete profiler window
(``profile_query.kernel_window``). Prints the card's name and power limit,
then one JSON line with every pair's times. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import statistics
from pathlib import Path

import torch

from cmw_rag_tpu_torch.scripts.profile_query import kernel_window
from cmw_rag_tpu_torch.scripts.shipping import card

HERE = Path(__file__).resolve().parents[2]
SOURCES = ("cmw_rag_tpu_torch/csrc/slot_attention.cu",
           "cmw_rag_tpu_torch/csrc/int8_decode.cuh")
SHAPES = (("s4-cap6", 4, [65, 200, 384]),
          ("s16-cap6", 16, [1 + 25 * i for i in range(15)]))
LAYERS, HQ, HKV, DH, PAGE, MAXP = 28, 16, 8, 128, 64, 32
KERNEL = "slot_attention_kernel"
CALLS = 56


def load_base(root: Path):
    """The base checkout's ``ops/paged_attention.py`` as a module."""
    for rel in SOURCES:
        if (root / rel).read_bytes() != (HERE / rel).read_bytes():
            raise SystemExit(f"{rel} differs between the checkouts: the "
                             f"wrappers would launch two kernels")
    spec = importlib.util.spec_from_file_location(
        "base_paged_attention", root / "cmw_rag_tpu_torch/ops/paged_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def slot_ms(wrapper, q, kp, vp, lens, cap: int) -> tuple:
    """Mean device ms of the slot kernel over ``CALLS`` calls of
    ``wrapper``, the layers in turn; → (ms, windows dropped)."""
    it = itertools.count()

    def call():
        return wrapper(q, kp, vp, lens, layer=next(it) % LAYERS, cap=cap,
                       maxp_slot=MAXP)
    events, dropped = kernel_window(call, CALLS, KERNEL)
    mine = [e for e in events if KERNEL in e.name]
    if len(mine) != CALLS:
        raise RuntimeError(f"{len(mine)} slot kernels in {CALLS} calls")
    us = sum(e.time_range.end - e.time_range.start for e in mine)
    return us / CALLS / 1e3, dropped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="root of the base checkout")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args(argv)
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    wrappers = {"base": load_base(args.base.resolve())
                .paged_decode_attention_dma_slot,
                "this": PA.paged_decode_attention_dma_slot}
    line = card()
    print(line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"card": line, "pairs": args.pairs, "calls": CALLS, "shapes": {}}
    for case, s, lens in SHAPES:
        shape = (LAYERS, 1 + s * MAXP, PAGE, HKV, DH)
        kp = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        q = torch.randn((s, HQ, DH), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        lens_t = torch.tensor(lens + [1], dtype=torch.int32, device="cuda")
        cap = -(-max(lens) // PAGE)
        got = {k: w(q, kp, vp, lens_t, layer=3, cap=cap, maxp_slot=MAXP)
               for k, w in wrappers.items()}
        if not torch.equal(got["base"], got["this"]):
            raise AssertionError(f"{case}: the two wrappers' outputs differ")
        times = {"base": [], "this": []}
        dropped = 0
        for i in range(args.pairs):
            for tree in ("base", "this") if i % 2 == 0 else ("this", "base"):
                ms, d = slot_ms(wrappers[tree], q, kp, vp, lens_t, cap)
                times[tree].append(ms)
                dropped += d
        diffs = [b - a for a, b in zip(times["base"], times["this"])]
        out["shapes"][case] = {
            "S": s, "cap": cap, "lens": lens + [1], "ms": times,
            "mean_ms": {k: statistics.mean(v) for k, v in times.items()},
            "this_minus_base_ms": {"mean": statistics.mean(diffs),
                                   "stdev": statistics.stdev(diffs),
                                   "this_faster": sum(d < 0 for d in diffs)},
            "dropped_windows": dropped}
        del kp, vp, q, got
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
