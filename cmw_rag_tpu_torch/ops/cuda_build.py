"""Build the hand-written CUDA kernels and load them with ctypes.

Each source ``csrc/<stem>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, on first use, into
``build/cmw_rag_tpu_torch/`` under the checkout. A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them together. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from cmw_rag_tpu_torch.device import REPO_ROOT

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: every kernel source of the port, by stem
SOURCES = ("topk_scan", "flash_attention")
BUILD_DIR = REPO_ROOT / "build" / "cmw_rag_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source(stem: str) -> Path:
    return CSRC / f"{stem}.cu"


def target(stem: str) -> Path:
    """The library built from ``source(stem)`` with ``NVCC_FLAGS``."""
    digest = hashlib.sha256(source(stem).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}_{digest}.so"


def build(stems=SOURCES) -> dict[str, Path]:
    """Compile every source in ``stems`` that has no up-to-date library, one
    ``nvcc`` each, all started together; return each library's path. Raises
    with the compiler's output if a build fails."""
    out = {stem: target(stem) for stem in stems}
    todo = {stem: path for stem, path in out.items() if not path.is_file()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        for stem, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(stem))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for stem, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{log}")
            else:
                os.replace(tmp, todo[stem])  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("\n".join(failed))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    if stem not in _libs:
        _libs[stem] = ctypes.CDLL(str(build((stem,))[stem]))
    return _libs[stem]
