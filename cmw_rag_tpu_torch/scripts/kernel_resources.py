"""Registers, spills and shared memory of a checkout's kernels as ptxas
reports them, and the cooperative grid of its decoder-layer megakernels
(``decoder_layer_blocks``, ``decoder_layer_kv8_blocks``), on a card.

    python -m cmw_rag_tpu_torch.scripts.kernel_resources \\
        [--root ROOT] [--sources decoder_layer,slot_attention] [--out FILE]

ROOT is a checkout of the repository (this one by default; another, such
as a parent commit unpacked under ``build/``, to compare). Each source
``ROOT/cmw_rag_tpu_torch/csrc/<stem>.cu`` is compiled with the port's
``nvcc`` flags plus ``-Xptxas -v`` into ``build/kernel_resources/`` of this
checkout (nothing of ROOT is imported, so any checkout whose C entries keep
these names can be read). Prints one JSON line: per kernel its registers,
spill stores and loads, stack frame and static shared memory; per
megakernel source the blocks of one cooperative launch for each row tile
(4, 8, 16, 32) at Dh 128; the card's ``nvidia-smi`` line. Needs ``nvcc``
and, for the grid, a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from cmw_rag_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_BLOCKS = {"decoder_layer": "decoder_layer_blocks",
           "decoder_layer_kv8": "decoder_layer_kv8_blocks"}


def demangle(names: list[str]) -> list[str]:
    """C++ names through ``cu++filt`` or ``c++filt`` where one is found."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        nvcc = Path(find_nvcc())
        cand = nvcc.parent / "cu++filt"
        tool = str(cand) if cand.is_file() else None
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(log: str) -> list[dict]:
    """Per kernel of one ``nvcc -Xptxas -v`` log: its registers, spills,
    stack and static shared memory."""
    kernels: list[dict] = []
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            kernels.append({"kernel": m.group(1)})
            continue
        if not kernels:
            continue
        m = _FRAME.search(line)
        if m:
            kernels[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            kernels[-1].update(registers=int(m.group(1)),
                               smem=int(m.group(2) or 0))
    for k, name in zip(kernels, demangle([k["kernel"] for k in kernels])):
        k["kernel"] = name
    return kernels


def compile_source(root: Path, stem: str) -> tuple[Path, list[dict]]:
    """Build ``stem`` of ``root`` with ``-Xptxas -v``; → (library, report)."""
    out_dir = BUILD_DIR.parent / "kernel_resources" / (
        re.sub(r"[^A-Za-z0-9]+", "_", str(root.resolve())).strip("_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{stem}.so"
    src = root / "cmw_rag_tpu_torch" / "csrc" / f"{stem}.cu"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{proc.stdout}{proc.stderr}")
    return lib, ptxas_report(proc.stdout + proc.stderr)


def grid_blocks(lib: Path, entry: str, dh: int = 128) -> dict:
    """Blocks of one cooperative launch per row tile (a card is needed)."""
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return {f"mt{mt}_dh{dh}": fn(mt, dh) for mt in (4, 8, 16, 32)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--sources", default="decoder_layer,decoder_layer_kv8,"
                    "slot_attention,fused_mlp,int8_matmul")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"root": str(args.root), "card": card, "kernels": [],
              "blocks": {}}
    for stem in (s for s in args.sources.split(",") if s):
        lib, kernels = compile_source(args.root, stem)
        result["kernels"] += [dict(k, source=stem) for k in kernels]
        if stem in _BLOCKS:
            result["blocks"][stem] = grid_blocks(lib, _BLOCKS[stem])
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
