"""Where the weight-only int8 matmul's time goes, on a card: probe builds
of ``csrc/int8_matmul.cu`` beside the tree's own.

    python -m cmw_rag_tpu_torch.scripts.int8_mm_probe [--out FILE]

Copies ``csrc/`` into ``build/int8_mm_probe/`` and switches parts of the
weight phases' product loop (``csrc/weight_phases.cuh`` ``mma_item``) off
by text edits that must each apply once:

- ``stream``: the TMA loads alone (the consumers wait on each stage and
  free it, and compute nothing);
- ``consumers``: the products alone (no loads, no waits; the producer
  warp issues nothing);
- ``noconv``: ``consumers`` without the int8 -> bf16 conversion (each
  column's pair of rows is the byte permute's word).

Each probe library and the tree's own (``ops/int8_matmul.py``) run through
the C entry at phase 9's cases (``chip_smoke.INT8_MM_CASES``: the QKV over
28 layers' weights in turn and the head) with the host plan's splits, ring
and grid, and the tree's own also at other rings and splits; each time is
the device ms of a call from a complete profiler window of 40 calls. Only
the tree's build is held to the twin (the probes' outputs are wrong by
design). Prints one JSON line with the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PROBE_DIR = ROOT / "build" / "int8_mm_probe"

#: the product loop's text edits of each probe: (old, new), each applied
#: once to csrc/weight_phases.cuh
_WAIT = "        hopper::mbar_wait(&full[slot], phase);\n"
_STEPS = "        for (int j = 0; j < 2; ++j) {  // this warp's two 16-row steps\n"
_ARRIVE = "      if (empty != nullptr) {  // the producer warp refills the stages\n"
_ISSUE = "    for (int i = 0; i < p.ring && w.more(p); ++i) w.issue(p, ring, full);\n"
_CONV = ("  const uint32_t p = __byte_perm(r0, r1, c * 0x1111 + 0x4400);\n")
PROBES = {
    "stream": [(_STEPS, "        for (int j = 0; j < 0; ++j) {\n")],
    "consumers": [(_WAIT, ""), (_ARRIVE, "      if (false) {\n"),
                  (_ISSUE, "    return;\n")],
    "noconv": [(_WAIT, ""), (_ARRIVE, "      if (false) {\n"),
               (_ISSUE, "    return;\n"), (_CONV, _CONV + "  return p;\n")],
}


def probe_source(name: str) -> Path:
    """``build/int8_mm_probe/<name>/csrc`` with the probe's edits."""
    dst = PROBE_DIR / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "cmw_rag_tpu_torch" / "csrc", dst)
    path = dst / "weight_phases.cuh"
    text = path.read_text()
    for old, new in PROBES[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"probe {name}: the edit of {old!r} does not "
                               f"apply once")
        text = text.replace(old, new)
    path.write_text(text)
    return dst / "int8_matmul.cu"


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul.argtypes = [p, i, p, p] + [i] * 6 + [p] * 4
    lib.int8_matmul.restype = i
    lib.int8_matmul_encode.argtypes = [p, i, i, p]
    lib.int8_matmul_encode.restype = i
    return lib


def build_probes() -> dict:
    """The probe libraries, built in parallel: {name: CDLL}."""
    from cmw_rag_tpu_torch.ops import cuda_build

    procs = {}
    for name in PROBES:
        src = probe_source(name)
        so = PROBE_DIR / name / "int8_matmul.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"probe {name}: nvcc failed:\n{log}")
        libs[name] = typed(ctypes.CDLL(str(so)))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    # chip_smoke.py's helpers (its layers, cases, timers), loaded from its
    # file: the checkout's root is no package
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    from cmw_rag_tpu_torch.device import sm_count
    from cmw_rag_tpu_torch.ops import int8_matmul as IM
    from cmw_rag_tpu_torch.ops import weight_phases as WP

    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    libs = {"tree": IM._lib(), **build_probes()}
    d, dev = 1024, torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(9)
    layers = c.int8_layers(28, gen)
    head = IM.quantize_weight(torch.randn((d, 151680), generator=gen,
                                          device="cuda") * 0.02)

    def launch(lib, x, w_q, scale, ks, ring, grid):
        m, n = x.shape[0], w_q.shape[1]
        stream = torch.cuda.current_stream().cuda_stream
        part = counts = None
        if ks > 1:
            mt = WP.layer_tile(m)
            tiles = -(-m // mt) * -(-n // WP.LAYER_COLS)
            floats, ints = WP.workspace(dev, stream,
                                        tiles * ks * mt * WP.LAYER_COLS, tiles)
            part, counts = floats.data_ptr(), ints.data_ptr()
        y = torch.empty((m, n), dtype=x.dtype, device=dev)
        err = lib.int8_matmul(
            x.data_ptr(), int(x.dtype == torch.float32),
            WP.weight_map(lib.int8_matmul_encode, w_q, "int8_mm_probe"),
            scale.data_ptr(), m, d, n, ks, ring, grid, part, counts,
            y.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y

    out = {}
    for case, m, n, dtype in c.INT8_MM_CASES:
        x = torch.randn((m, d), generator=gen, device=dev).to(
            getattr(torch, dtype))
        ws = ([head] if case.startswith("head") else
              [(lay["wqkv_q"], lay["wqkv_s"]) for lay in layers])
        plan = WP.matmul_plan(m, d, n, IM._grid(dev, WP.layer_tile(m),
                                                x.dtype == torch.float32),
                              sm_count(dev))
        ks, ring, grid = plan.products[1].ks, plan.ring, plan.grid
        runs = [(name, ks, ring, grid) for name in libs]
        # the tree's own at other rings (the head) or splits (the QKV)
        if case.startswith("head"):
            runs += [("tree", ks, r, grid) for r in (2, 4) if r != ring]
        else:
            tiles = plan.mtiles * plan.products[1].ctiles
            runs += [("tree", k2, max(2, -(-16 // k2)),
                      min(tiles * k2, 2 * sm_count(dev)))
                     for k2 in (2, 8)
                     if -(-16 // k2) <= WP.mm_max_ring(plan.mt)]
        want = IM.int8_matmul_plain(x, *ws[0])
        for name, k2, r, g in runs:
            lib = libs[name]
            if name == "tree":
                c.held(launch(lib, x, *ws[0], k2, r, g), want, c.INT8_MM_TOL,
                       f"int8_matmul {case}")
            kern = c.cycling(lambda i, lib=lib, k2=k2, r=r, g=g: launch(
                lib, x, *ws[i], k2, r, g), len(ws))
            ms = c.device_ms(kern, 40, "int8_matmul_kernel")
            key = f"{case}/{name}/ks{k2}/ring{r}/grid{g}"
            out[key] = ms
            print(f"{key} {ms:.5f} ms", file=sys.stderr, flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    line = json.dumps({"card": card, "ms": out})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
