"""PyTorch + CUDA port of ``cmw_rag_tpu`` for an NVIDIA H100.

The JAX package beside this one stays the reference: every public function
here keeps its counterpart's name and array layout. This package imports
``torch``, ``numpy`` and the standard library only; the bundled checkpoints
(``checkpoints/*.npz``) and the BPE vocabulary are read by path.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
card is present unless the caller asks for ``device="cpu"``. On a CUDA
tensor the scan top-k, the IVF block scan and flash attention run the
hand-written kernels of ``csrc/``; on a CPU tensor they run their plain
PyTorch twins.
"""

from cmw_rag_tpu_torch.device import REPO_ROOT, resolve_device

__all__ = ["REPO_ROOT", "resolve_device"]
