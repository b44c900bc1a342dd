"""Time two checkouts on one card in turns: ``chip_smoke.py``'s flat scan
(phase 2), shipping pipeline (phase 3), flash-kernel,
long-context, training, int8 LLM (phase 9), w8a8 / int8-KV (phase 10),
paged-kernel, local LLM (phase 8), IVF (phase 6) and segmented store
(phase 7) phases of a base checkout (A) and of
this one (B), each run in a process of its own started from its
checkout's root, in the order A, B, B, A, so that a drift of the card over
the call falls on both alike.

    python -m cmw_rag_tpu_torch.scripts.compare_trees BASE_ROOT \\
        [--phases scan,pipeline,flash,long_context,training,int8_llm,
                  w8a8_kv8,paged_kernel,local_llm,ivf,segmented]
        [--steps int8-s16,int8-kv8] [--batch] [--bits] [--flat-batch]
        [--int8-mm] [--out FILE]

BASE_ROOT is another checkout of the repository (for example the parent
commit, ``git archive <commit> chip_smoke.py cmw_rag_tpu_torch | tar -x -C
build/base``); each checkout builds its own kernels into its own
``build/``. A phase that fails in either checkout fails the run (its gates
are the phase's own). Prints, per run, a line ``{"tree": "A" or "B",
"run": i, "card": ..., "summary": {...}}`` with the readings a comparison
reads (phase 2's scan records, with each call's scan and selection
device times and workspace where the tree's phase gives them, and the
shipping pipeline's queries/s, bf16 and int8; the flash kernel's ms per
shape, the long-context stages' ms per
query, the backward kernels' ms per shape, the training step's host and
busy ms and its first-step gates; phase 9's slot attention, fused MLP and
megakernel records and its profiled int8 decode step; phase 10's W8A8
records (the whole call's device time, the kernels a call, the split),
its profiled w8a8 decode step and its int8-KV megakernel records; phase
8's paged kernel records, by phase, and its profiled native decode step;
phase 6's IVF kernel records (with the union's scan and selection device
times where the tree's phase gives them) and recall@10; phase 7's top-20
overlap with an exact index, planted ranks and launches;
the megakernels' records carry their device ms whole, with attention
ablated (``noattn_ms``) and at each split, where the tree's phases time
them in a process of their own, ``chip_smoke.timings_child``), then one
line with every run's summary; ``--out`` keeps the phases' whole reports, one
JSON line a run. ``--steps`` also profiles one decode step of each named
engine configuration (``STEPS``) in every run, through the tree's own
``scripts/local_llm.py --profile`` in a process of its own (4 active
slots; the summary's ``steps``). ``--batch`` also times, in every run,
the IVF union scans of phase 6's index at batches past one query chunk
(``BATCH_CASES``, nprobe 64) through this script's own harness over the
tree's package (``_BATCH_CHILD``; a parent's chip_smoke.py has no such
case): each call's device ms (CUDA events), its largest |score - plain
twin's|, the share of ids equal to the twin's, the distinct blocks
scanned, and the device memory a first call takes beyond what was
allocated before it (the summary's ``ivf_batch``). ``--bits`` also
hashes, in every run, the IVF kernels' outputs (probed and union, bf16
and int8, ``BITS_CASES``) over a seeded blocked corpus of phase 6's shape
(rows cut into blocks in order, tables drawn from a seed, no k-means,
whose atomics may cluster differently run to run) through the tree's own
package (``_BITS_CHILD``): equal hashes mean equal bits (the summary's
``ivf_bits``). ``--flat-batch`` also times, in every run, the flat scans
(bf16 and int8) at batches phase 2 lacks (``FLAT_CASES``) over a 1M x
5120 corpus through the tree's own package (``_FLAT_CHILD``: CUDA
events over 10 calls after 2; the summary's ``flat_batch``).
``--int8-mm`` also times, in every run, the weight-only int8 matmul at
phase 9's cases (``MM_CASES``: the QKV over 28 layers' weights in turn
and the head, at 4 and 16 rows, which a parent's phase 9 may lack)
through the tree's own package and ``chip_smoke.py`` helpers
(``_MM_CHILD``: the whole call's device time from a complete profiler
window of 56 calls, the kernels a call, the twin, the library yardstick,
the bound; the summary's ``int8_mm``). Each of the four runs in a process
of its own from the tree's root (``run_extra``).
The phases' own log lines go to stderr.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
PHASES = ("scan", "pipeline", "flash", "long_context", "training",
          "int8_llm", "w8a8_kv8", "paged_kernel", "local_llm", "ivf",
          "segmented")
#: the readings of phase 2's scan records (rows 1 to 4)
SCAN_READINGS = ("ms", "plain_ms", "library_ms", "bound_ms", "scan_ms",
                 "select_ms", "workspace_mib")
#: the readings of phase 6's IVF kernel records (rows 9 to 13)
IVF_READINGS = ("ms", "plain_ms", "library_ms", "bound_ms", "scan_ms",
                "select_ms")
#: the kernels of phases 9 and 10 that a comparison reads (rows 19, 23, 24
#: and 25 of PERF.md)
INT8_KERNELS = ("int8_matmul", "paged_decode_attention_dma_slot",
                "fused_mlp_int8", "decoder_layer_int8",
                "decoder_layer_int8_kv8")
INT8_STEP = ("wall_ms_per_step_unprofiled", "wall_ms_per_step",
             "device_busy_ms_per_step", "idle_share",
             "kernel_launches_per_step", "named_kernel_ms_per_step")
#: the readings of phase 10's W8A8 records (row 22)
W8A8_READINGS = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                 "kernels_per_call", "split", "grid_blocks")
#: the readings of phase 8's paged kernel records (rows 15, 16 and 18)
PAGED_READINGS = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                  "split", "n_split", "ms_by_split", "kernels_per_call")

#: the union scans' batches ``--batch`` times: (Q, k) at nprobe 64
BATCH_CASES = ((128, 20), (256, 20), (256, 1000))

#: the IVF kernels' cases ``--bits`` hashes: (route, Q, k)
BITS_CASES = (("probed", 1, 20), ("probed", 8, 1000), ("union", 8, 20),
              ("union", 32, 129), ("union", 100, 1000))

#: the flat scans' batches ``--flat-batch`` times past phase 2's Q 8, 32
#: and 128: (Q, k) over 1M x 5120
FLAT_CASES = ((64, 20), (256, 20))

#: the weight-only int8 matmul's cases ``--int8-mm`` times (phase 9's,
#: ``chip_smoke.INT8_MM_CASES``, which a parent's phase may lack): (case,
#: rows, output columns, x's dtype) at K 1024
MM_CASES = (("qkv-s4", 4, 4096, "bfloat16"), ("qkv-s16", 16, 4096, "bfloat16"),
            ("head-s4", 4, 151680, "float32"),
            ("head-s16", 16, 151680, "float32"))

#: decode-step configurations ``--steps`` profiles: the CLI's arguments
STEPS = {"int8-s16": ("--weights", "int8", "--slots", "16"),
         "int8-kv8": ("--weights", "int8", "--kv-dtype", "int8"),
         "int8-s4": ("--weights", "int8")}

_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from cmw_rag_tpu_torch.scripts.shipping import card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
line = card()
def plain(x):
    if isinstance(x, dict):
        return {("/".join(map(str, k)) if isinstance(k, tuple) else str(k)):
                plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x if isinstance(x, (int, float, str, bool, type(None))) else str(x)
out = {name: plain(getattr(c, name + "_phase")(line)) for name in PHASES}
print("COMPARE_RESULT " + json.dumps({"card": line, "phases": out}), flush=True)
"""

_BATCH_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
from cmw_rag_tpu_torch.index.ivf import IVFIndex, union_blocks
from cmw_rag_tpu_torch.ops import ivf_scan as V
from cmw_rag_tpu_torch.scripts import ivf as I
rows, ids, _, _ = I.clustered_corpus()
gen = torch.Generator(device="cuda").manual_seed(77)
qn = max(q for q, _ in CASES)
at = torch.randint(0, I.N_ROWS, (qn,), generator=gen, device="cuda")
qs = rows[at].float() + I.NOISE * torch.randn((qn, I.DIM), generator=gen,
                                              device="cuda")
qs = (qs / qs.norm(dim=1, keepdim=True)).to(torch.bfloat16)
out = {}
for quantize in (False, True):
    idx = IVFIndex.build(rows, ids, block_n=I.BLOCK_N, quantize=quantize)
    name = "ivf_union_scan" + ("_int8" if quantize else "")
    extra = () if idx.scales is None else (idx.scales,)
    fn = getattr(V, name)
    for nq, k in CASES:
        q = qs[:nq].contiguous()
        table, nu = union_blocks(idx.probe(q.float(), I.NPROBE))
        call = lambda: fn(idx.corpus, *extra, idx.ids, q, table, k,
                          I.BLOCK_N, nu)
        getattr(V, "_WORKSPACES", {}).clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = call()
        torch.cuda.synchronize()
        extra_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        want = V.ivf_union_plain(idx.corpus, idx.ids, q, table, k, I.BLOCK_N,
                                 nu, scales=idx.scales)
        for _ in range(3):
            call()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(20):
            call()
        b.record()
        torch.cuda.synchronize()
        out[f"{name}/q{nq}k{k}"] = {
            "ms": a.elapsed_time(b) / 20, "blocks": int(nu.item()),
            "max_abs_err": float((got[0] - want[0]).abs().max()),
            "ids_equal_share": float((got[1] == want[1]).float().mean()),
            "extra_mib": extra_mib}
    del idx
    torch.cuda.empty_cache()
print("EXTRA_RESULT " + json.dumps(out), flush=True)
"""


_BITS_CHILD = """
import hashlib, json, sys, torch
sys.path.insert(0, ".")
from cmw_rag_tpu_torch.ops import ivf_scan as V
from cmw_rag_tpu_torch.ops.topk import quantize_rows_int8
from cmw_rag_tpu_torch.scripts import ivf as I
rows, ids, q, _ = I.clustered_corpus()
n = rows.shape[0] // I.BLOCK_N * I.BLOCK_N
rows, ids = rows[:n].contiguous(), ids[:n].contiguous()
n_blocks = n // I.BLOCK_N
gen = torch.Generator(device="cuda").manual_seed(5)
c8, sc = quantize_rows_int8(rows)
out = {}
for route, nq, k in CASES:
    qq = q[:nq].contiguous()
    probes = torch.randint(0, n_blocks, (nq, I.NPROBE), generator=gen,
                           device="cuda", dtype=torch.int32)
    for int8 in (False, True):
        extra = (c8, sc) if int8 else (rows,)
        name = f"ivf_{route}_scan" + ("_int8" if int8 else "")
        if route == "union":
            blocks = torch.unique(probes.reshape(-1)).to(torch.int32)
            nu = torch.tensor([blocks.numel()], dtype=torch.int32,
                              device="cuda")
            got = getattr(V, name)(*extra, ids, qq, blocks, k, I.BLOCK_N, nu)
        else:
            got = getattr(V, name)(*extra, ids, qq, probes, k, I.BLOCK_N)
        h = hashlib.sha256()
        for t in got:
            h.update(t.cpu().numpy().tobytes())
        out[f"{name}/q{nq}k{k}"] = h.hexdigest()[:16]
print("EXTRA_RESULT " + json.dumps(out), flush=True)
"""


_FLAT_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
from cmw_rag_tpu_torch.ops import topk as T
from cmw_rag_tpu_torch.scripts.shipping import (DIM, N_ROWS, fill_unit_rows,
                                                quantize_slices)
gen = torch.Generator(device="cuda").manual_seed(11)
corpus = fill_unit_rows(N_ROWS, DIM, gen)
ids = torch.arange(N_ROWS, dtype=torch.int32, device="cuda")
q = fill_unit_rows(max(nq for nq, _ in CASES), DIM, gen)
c8, sc = quantize_slices(corpus)
out = {}
for nq, k in CASES:
    qq = q[:nq].contiguous()
    for name, call in (
            ("topk_scan_bf16", lambda: T.topk_scan_bf16(corpus, ids, qq, k)),
            ("topk_scan_int8", lambda: T.topk_scan_int8(c8, sc, ids, qq, k))):
        for _ in range(2):
            call()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(10):
            call()
        b.record()
        torch.cuda.synchronize()
        out[f"{name}/q{nq}k{k}"] = {"ms": a.elapsed_time(b) / 10}
print("EXTRA_RESULT " + json.dumps(out), flush=True)
"""


_MM_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from cmw_rag_tpu_torch.ops import int8_matmul as IM
gen = torch.Generator(device="cuda").manual_seed(9)
d = 1024
layers = c.int8_layers(28, gen)
head = IM.quantize_weight(torch.randn((d, 151680), generator=gen,
                                      device="cuda") * 0.02)
out = {}
for case, m, n, dtype in CASES:
    x = torch.randn((m, d), generator=gen, device="cuda").to(
        getattr(torch, dtype))
    ws = ([head] if case.startswith("head")
          else [(lay["wqkv_q"], lay["wqkv_s"]) for lay in layers])
    kern = c.cycling(lambda i: IM.int8_matmul(x, *ws[i]), len(ws))
    ms, seen, dropped = c.device_profile(kern, 56, "int8_matmul_kernel")
    xb = x.element_size()
    b = c.bound(d * n + 4 * n + m * d * xb + m * n * xb, 2.0 * m * d * n)
    out[case] = {
        "ms": ms, "kernels_per_call": len(seen) / 56,
        "kernels": sorted(set(seen)), "dropped_windows": dropped,
        "plain_ms": c.device_ms(c.cycling(
            lambda i: IM.int8_matmul_plain(x, *ws[i]), len(ws)), 5),
        "library_ms": c.device_ms(c.cycling(
            lambda i: c.library_mm(x, *ws[i]), len(ws)), 5),
        "call_ms": c.cuda_ms(kern, 56), **b, "bound_share": b["bound_ms"] / ms}
print("EXTRA_RESULT " + json.dumps(out), flush=True)
"""


#: what ``--batch``, ``--bits``, ``--flat-batch`` and ``--int8-mm`` add to
#: a run: its key in the summary → (the cases, the child program that
#: takes them)
EXTRAS = {"ivf_batch": (BATCH_CASES, _BATCH_CHILD),
          "ivf_bits": (BITS_CASES, _BITS_CHILD),
          "flat_batch": (FLAT_CASES, _FLAT_CHILD),
          "int8_mm": (MM_CASES, _MM_CHILD)}


def run_extra(root: Path, name: str) -> dict:
    """The child program of ``EXTRAS[name]`` over its cases and ``root``'s
    package, in a process started from ``root``; → its result."""
    cases, child = EXTRAS[name]
    proc = subprocess.run([sys.executable, "-c", f"CASES = {cases!r}\n"
                           + child], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise RuntimeError(f"{root}: {name} failed ({proc.returncode})")
    for line in proc.stdout.splitlines():
        if line.startswith("EXTRA_RESULT "):
            return json.loads(line[len("EXTRA_RESULT "):])
    raise RuntimeError(f"{root}: no {name} result line")


def run_tree(root: Path, phases: list[str]) -> dict:
    """One process from ``root`` running ``phases``; → its result line."""
    code = f"PHASES = {phases!r}\n" + _CHILD
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: phases {phases} failed "
                           f"({proc.returncode})")
    for line in proc.stdout.splitlines():
        if line.startswith("COMPARE_RESULT "):
            return json.loads(line[len("COMPARE_RESULT "):])
    raise RuntimeError(f"{root}: no result line")


def run_step(root: Path, name: str) -> dict:
    """One decode step of configuration ``name`` profiled by the tree's own
    CLI (``scripts/local_llm.py --profile``) in a process started from
    ``root``; → the profile's step readings."""
    proc = subprocess.run(
        [sys.executable, "-m", "cmw_rag_tpu_torch.scripts.local_llm",
         *STEPS[name], "--profile", "--max-new-tokens", "4"],
        cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise RuntimeError(f"{root}: step {name} failed ({proc.returncode})")
    prof = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: prof.get(k) for k in INT8_STEP + ("named_kernels",)}


def summary(phases: dict) -> dict:
    """The readings a comparison of two trees reads, from one run."""
    out = {}
    scan = phases.get("scan")
    if scan:
        out["scan_kernels"] = {case: {k: r[k] for k in SCAN_READINGS
                                      if k in r}
                               for case, r in scan.items()}
    pipe = phases.get("pipeline")
    if pipe:
        out["pipeline_qps"] = pipe["qps"]
    flash = phases.get("flash")
    if flash:
        out["flash_ms"] = {case: r["ms"] for case, r in flash.items()}
    lc = phases.get("long_context")
    if lc:
        out["long_context_stages"] = lc["stages"]
    tr = phases.get("training")
    if tr:
        out["backward_ms"] = {k: r["ms"] for k, r in tr["kernels"].items()
                              if k.startswith("flash_attention_bwd_")}
        steps = tr["train"]["steps"]
        out["train_step"] = {k: steps[k] for k in (
            "host_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "flash_share_of_busy")}
        out["train_first_step"] = tr["train"]["first_step"]
    for phase in ("int8_llm", "w8a8_kv8"):
        if phase in phases:
            out.setdefault("int8_kernels", {}).update({
                case: {k: r.get(k) for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "call_ms",
                                             "kernels_per_call", "split",
                                             "n_split",
                                             "grid_blocks", "ms_by_split",
                                             "noattn_ms", "ring", "splits",
                                             "grid_waits", "merges",
                                             "block_stages")}
                for case, r in phases[phase]["kernels"].items()
                if case.split("/")[0] in INT8_KERNELS})
    w8 = phases.get("w8a8_kv8")
    if w8:
        out["w8a8_kernels"] = {
            case: {k: r.get(k) for k in W8A8_READINGS}
            for case, r in w8["kernels"].items()
            if case.split("/")[0] == "int8_matmul_w8a8"}
        prof = w8["engine"]["decode_profiles"]["w8a8"]
        out["w8a8_step"] = {k: prof[k] for k in INT8_STEP}
    i8 = phases.get("int8_llm")
    if i8:
        prof = i8["engine"]["decode_profile"]
        out["int8_step"] = {k: prof[k] for k in INT8_STEP}
    llm = phases.get("local_llm")
    for phase, records in (("paged_kernel", phases.get("paged_kernel")),
                           ("local_llm", llm and llm["kernels"])):
        if records:
            out.setdefault("paged_kernels", {})[phase] = {
                case: {k: r.get(k) for k in PAGED_READINGS}
                for case, r in records.items()}
    if llm:
        prof = llm["engine"]["decode_profile"]
        out["native_step"] = {k: prof[k] for k in INT8_STEP}
    ivf = phases.get("ivf")
    if ivf:
        out["ivf_kernels"] = {case: {k: r[k] for k in IVF_READINGS if k in r}
                              for case, r in ivf["kernels"].items()}
        out["ivf_recall_at_10"] = ivf["recall_at_10"]
    seg = phases.get("segmented")
    if seg:
        out["segmented"] = {k: seg[k] for k in ("top20_overlap_with_flat",
                                                "planted_ranks", "launches")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="root of the base checkout (A)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--steps", default="",
                    help="decode-step configurations to profile: "
                    + ",".join(STEPS))
    ap.add_argument("--batch", action="store_true",
                    help="also time the IVF union scans at BATCH_CASES")
    ap.add_argument("--bits", action="store_true",
                    help="also hash the IVF kernels' outputs at BITS_CASES")
    ap.add_argument("--flat-batch", action="store_true",
                    help="also time the flat scans at FLAT_CASES")
    ap.add_argument("--int8-mm", action="store_true",
                    help="also time int8_matmul at MM_CASES")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every run's result here as JSON lines")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p}")
    steps = [s for s in args.steps.split(",") if s]
    for s in steps:
        if s not in STEPS:
            ap.error(f"unknown step {s}")
    trees = {"A": args.base.resolve(), "B": HERE}
    extras = [name for name, on in (("ivf_batch", args.batch),
                                    ("ivf_bits", args.bits),
                                    ("flat_batch", args.flat_batch),
                                    ("int8_mm", args.int8_mm)) if on]
    runs = []
    for i, tree in enumerate("ABBA"):
        res = (run_tree(trees[tree], phases) if phases
               else {"card": None, "phases": {}})
        res["steps"] = {s: run_step(trees[tree], s) for s in steps}
        res.update({name: run_extra(trees[tree], name) for name in extras})
        row = {"tree": tree, "run": i, "root": str(trees[tree]), **res}
        runs.append(row)
        print(json.dumps({"tree": tree, "run": i, "card": res["card"],
                          "summary": summary(res["phases"]),
                          "steps": res["steps"],
                          **{name: res.get(name) for name in EXTRAS}}),
              flush=True)
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in runs))
    print(json.dumps({"summary": [{"tree": r["tree"], "run": r["run"],
                                   **summary(r["phases"]),
                                   "steps": r["steps"],
                                   **{name: r.get(name) for name in EXTRAS}}
                                  for r in runs]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
