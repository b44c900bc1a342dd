"""Build the hand-written CUDA kernels and load them with ctypes.

``csrc/topk_scan.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, on first use, into
``build/cmw_rag_tpu_torch/`` under the checkout. The library's file name
carries a hash of its source, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from cmw_rag_tpu_torch.device import REPO_ROOT

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "topk_scan.cu"
BUILD_DIR = REPO_ROOT / "build" / "cmw_rag_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the source unless an up-to-date library exists; return the
    library's path. Raises with the compiler's output if the build fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{SOURCE.stem}_{digest}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc {SOURCE.name} failed ({res.returncode}):"
                               f"\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    """The loaded library built from the source."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
