"""Device selection shared by the port's entry points."""

from __future__ import annotations

import functools
from pathlib import Path

import torch

#: root of the checkout: bundled checkpoints and the BPE vocabulary are read
#: from here, and kernels are built under ``build/cmw_rag_tpu_torch/``
REPO_ROOT = Path(__file__).resolve().parents[1]


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises on any other mix. Kernel wrappers take their plain
    twin only for CPU tensors."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs must share one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return False


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (grid sizing)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def need(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` has ``dtype`` (one dtype or a tuple of them),
    ``shape`` and a contiguous, 16-byte aligned layout: what a kernel
    wrapper checks before it hands a pointer to its kernel."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected "
                        f"{' or '.join(str(d) for d in dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when it names CUDA and
    no card is present. Nothing falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # "cuda" → "cuda:<current>", as tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
