"""Weight-only int8 matmul: y = x @ (w_int8 · scale) without a bf16 copy of
the weights (port of ``cmw_rag_tpu/ops/int8_matmul.py``).

Weights are quantized per output channel, symmetric: ``scale[n] =
max|w[:, n]| / 127`` and ``w ≈ w_int8 * scale`` (``quantize_weight``, :29).
The column scales commute with the contraction, so they multiply the
float32 accumulator once per output element.

- ``int8_matmul_xla`` (:38) is the golden: x in float32, the product in
  float32, the result in x's dtype. The engine's golden route
  (``use_kernel=False``) runs it.
- ``int8_matmul_plain`` is the twin of the TPU kernel (:59, body
  ``_int8_kernel`` :47), whose rounding points it keeps: x is rounded to
  bf16 before the product (bf16 x int8 products are exact in float32), the
  sum is float32, times ``scale``, cast to x's dtype.
- ``int8_matmul`` is the wrapper the engine's kernel route calls. On CUDA
  tensors it launches ``csrc/int8_matmul.cu`` (x bf16 or float32 [M, K],
  any M, K a multiple of 64, N a multiple of 16) and adds one to its
  ``launches`` count; on CPU tensors it runs the plain twin. Wrong device,
  dtype, shape or contiguity raises: there is no fallback. ``block_n`` is
  the TPU kernel's column block and changes nothing here.

W8A8 (:105-171, ``weights="w8a8"``): the activations are quantized too,
per row and dynamically (``quantize_activations`` :105, torch ops in the
wrapper, as the JAX package keeps them outside its ``pallas_call``), and
the product is int8 x int8 with an exact int32 sum.

- ``int8_matmul_w8a8_xla`` (:118) is the golden: ``acc · x_scale[m] ·
  scale[n]`` in float32.
- ``int8_matmul_w8a8_plain`` is the twin of the TPU kernel (:133, body
  ``_w8a8_kernel`` :126), whose order it keeps: ``float(acc) · scale[n]``
  in the body, ``· x_scale[m]`` on the output (:171), cast to x's dtype.
  The sum is taken in float64, which holds it exactly.
- ``int8_matmul_w8a8`` is the wrapper. On CUDA tensors it launches the
  ``int8_matmul_w8a8`` kernel of ``csrc/int8_matmul.cu`` (x bf16 or
  float32 [M, K], any M, K a multiple of 64, N of 16) and adds one to its
  ``launches`` count; it equals the twin bit for bit. The TPU's padding of
  M to 32 and its ``block_n`` search are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from cmw_rag_tpu_torch.device import need, on_cpu, sm_count
from cmw_rag_tpu_torch.ops import cuda_build

#: the CUDA tile: activation rows, weight columns and contraction rows
M_TILE_MAX = 32
N_TILE = 64
K_TILE = 64


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: → (w_int8 [K, N], scale [N]
    float32) with ``w ≈ w_int8 * scale``; rounds half to even, as JAX."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def int8_matmul_xla(x: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Golden: [M, K] @ int8 [K, N] · scale[N] → [M, N] in x.dtype, all in
    float32."""
    return ((x.float() @ w_q.float()) * scale[None, :]).to(x.dtype)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Twin of the kernel: x rounded to bf16, float32 sum, · scale, x.dtype."""
    xb = x.to(torch.bfloat16).float()
    return ((xb @ w_q.float()) * scale[None, :]).to(x.dtype)


def k_split(k: int, tiles: int, target: int) -> int:
    """The largest split of the contraction into K_TILE-row multiples that
    keeps ``tiles * split`` work items within ``target`` (at least 1)."""
    steps = k // K_TILE
    best = 1
    for d in range(1, steps + 1):
        if steps % d == 0 and tiles * d <= target:
            best = d
    return best


def m_tile(m: int) -> int:
    """Activation rows of the CUDA tile for ``m`` rows: 4, 8, 16 or 32."""
    return next(t for t in (4, 8, 16, M_TILE_MAX) if m <= t or t == M_TILE_MAX)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("int8_matmul")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul.argtypes = [p, i, p, p, i, i, i, i, p, p, p]
        lib.int8_matmul.restype = ctypes.c_int
        lib.int8_matmul_w8a8.argtypes = [p, p, p, p, i, i, i, i, p, p, i, p]
        lib.int8_matmul_w8a8.restype = ctypes.c_int
        lib._typed = True
    return lib


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                block_n: int = 512) -> torch.Tensor:
    """y = x [M, K] @ int8 w_q [K, N] · scale [N] → [M, N] in x.dtype, with
    the kernel's rounding points (``int8_matmul_plain``)."""
    if on_cpu(x, w_q, scale):
        return int8_matmul_plain(x, w_q, scale)
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError("x must be [M, K] and w_q [K, N]")
    m, k = x.shape
    n = w_q.shape[1]
    need(x, "x", (torch.bfloat16, torch.float32), (m, k))
    need(w_q, "w_q", torch.int8, (k, n))
    need(scale, "scale", torch.float32, (n,))
    if k % K_TILE or n % 16 or m < 1:
        raise ValueError(f"K={k} must be a multiple of {K_TILE} and N={n} of "
                         f"16")
    mt = m_tile(m)
    tiles = -(-m // mt) * -(-n // N_TILE)
    ks = k_split(k, tiles, 2 * sm_count(x.device))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
               if ks > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().int8_matmul(
            x.data_ptr(), int(x.dtype == torch.float32), w_q.data_ptr(),
            scale.data_ptr(), m, k, n, ks,
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


# ------------------------------------------------------------------- W8A8


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) symmetric int8: → (x_int8 [M, K], scale [M]
    float32) with ``x ≈ x_int8 * scale[:, None]``: ``max(absmax, 1e-8) /
    127``, a division by it, round half to even, a clip to ±127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return q.to(torch.int8).contiguous(), scale.contiguous()


def _w8a8_acc(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of int8 x int8, as float32 (each rounded once,
    as the kernel converts them): float64 holds every sum exactly."""
    return (xq.double() @ w_q.double()).float()


def int8_matmul_w8a8_xla(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """Golden: quantize x per row, int32 sums, ``acc · x_scale · scale``."""
    xq, sx = quantize_activations(x)
    return (_w8a8_acc(xq, w_q) * sx[:, None] * scale[None, :]).to(x.dtype)


def int8_matmul_w8a8_plain(x: torch.Tensor, w_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Twin of the kernel: ``(float(acc) · scale[n]) · x_scale[m]``."""
    xq, sx = quantize_activations(x)
    return ((_w8a8_acc(xq, w_q) * scale[None, :]) * sx[:, None]).to(x.dtype)


def int8_matmul_w8a8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     block_n: int = 512) -> torch.Tensor:
    """y = quantize_activations(x) [M, K] @ int8 w_q [K, N], rescaled →
    [M, N] in x.dtype (``int8_matmul_w8a8_plain``'s arithmetic)."""
    if on_cpu(x, w_q, scale):
        return int8_matmul_w8a8_plain(x, w_q, scale)
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError("x must be [M, K] and w_q [K, N]")
    m, k = x.shape
    n = w_q.shape[1]
    need(x, "x", (torch.bfloat16, torch.float32), (m, k))
    need(w_q, "w_q", torch.int8, (k, n))
    need(scale, "scale", torch.float32, (n,))
    if k % K_TILE or n % 16 or m < 1:
        raise ValueError(f"K={k} must be a multiple of {K_TILE} and N={n} of "
                         f"16")
    xq, sx = quantize_activations(x)
    tiles = -(-m // m_tile(m)) * -(-n // N_TILE)
    ks = k_split(k, tiles, 2 * sm_count(x.device))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = (torch.empty((ks, m, n), dtype=torch.int32, device=x.device)
               if ks > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().int8_matmul_w8a8(
            xq.data_ptr(), sx.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            m, k, n, ks, None if partial is None else partial.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_w8a8 launch failed: CUDA error "
                           f"{err}")
    int8_matmul_w8a8.launches += 1
    return out


int8_matmul_w8a8.launches = 0
