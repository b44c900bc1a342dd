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
per row and dynamically (``quantize_activations`` :105), and the product is
int8 x int8 with an exact int32 sum.

- ``int8_matmul_w8a8_xla`` (:118) is the golden: ``acc · x_scale[m] ·
  scale[n]`` in float32.
- ``int8_matmul_w8a8_plain`` is the twin of the TPU kernel (:133, body
  ``_w8a8_kernel`` :126), whose order it keeps: ``float(acc) · scale[n]``
  in the body, ``· x_scale[m]`` on the output (:171), cast to x's dtype.
  The sum is taken in float64, which holds it exactly.
- ``int8_matmul_w8a8`` is the wrapper. On CUDA tensors it makes one
  launch of the ``int8_matmul_w8a8`` kernel of ``csrc/int8_matmul.cu``
  (x bf16 or float32 [M, K], any M, K a multiple of 64, N of 16), which
  quantizes the activations itself, and adds one to its ``launches``
  count; it runs no other operation on the card than allocating the
  output (the weight's tensor map and the per-(device, stream) workspace
  of split contractions are made once and kept). It equals the twin bit
  for bit. The TPU's
  padding of M to 32 and its ``block_n`` search are dropped.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cmw_rag_tpu_torch.device import need, on_cpu, sm_count
from cmw_rag_tpu_torch.ops import cuda_build
from cmw_rag_tpu_torch.ops.paged_attention import split_workspace

#: the CUDA tile: activation rows, weight columns and contraction rows
M_TILE_MAX = 32
N_TILE = 64
K_TILE = 64
#: the W8A8 kernel's tile: 128 weight columns (one 128-byte TMA box row)
#: and 64 weight rows a stage
W8A8_COLS = 128
W8A8_STAGE_ROWS = 64


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
        lib.int8_matmul_w8a8.argtypes = [p, i, p, p, i, i, i, i, i, p, p, p,
                                         p]
        lib.int8_matmul_w8a8.restype = ctypes.c_int
        lib.w8a8_encode.argtypes = [p, i, i, p]
        lib.w8a8_encode.restype = ctypes.c_int
        lib.w8a8_resident.argtypes = [i, i, p]
        lib.w8a8_resident.restype = ctypes.c_int
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
    127``, a division by it, round half to even, a clip to ±127. Both
    divisions are IEEE float32 divisions on every device, as the kernel's."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=1), min=1e-8)
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its float32 reciprocal, one step off the quotient on some rows
    scale = absmax / torch.full_like(absmax, 127.0)
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


def w8a8_frags(m: int) -> int:
    """Fragments of 8 activation rows the kernel's m tile takes for ``m``
    rows: 1, 2 or 4 (m tiles of 32 rows past 32)."""
    return 1 if m <= 8 else 2 if m <= 16 else 4


@functools.lru_cache(maxsize=None)
def w8a8_plan(m: int, k: int, n: int, sms: int, resident: int
              ) -> tuple[int, int]:
    """(splits of the contraction, blocks) of the W8A8 kernel for an [m, k]
    x [k, n] product on ``sms`` SMs that keep ``resident`` blocks each.

    A work item is (m tile of 8F rows, 128-column tile, split of whole
    64-row stages). An SM streams about ceil(items / sms) items of
    ceil(stages / splits) stages: the split that makes that least wins,
    the fewest splits on a tie (each split adds a partial tile to write
    and to read back). The blocks are min(items, sms * resident), each
    walking the items it is given in turn."""
    tiles = -(-m // (8 * w8a8_frags(m))) * -(-n // W8A8_COLS)
    steps = k // W8A8_STAGE_ROWS
    best_cost, best = None, 1
    for ks in range(1, steps + 1):
        cost = -(-tiles * ks // sms) * -(-steps // ks)
        if best_cost is None or cost < best_cost:
            best_cost, best = cost, ks
    return best, min(tiles * best, sms * resident)


def w8a8_workspace(m: int, n: int, ks: int) -> tuple[int, int]:
    """(int32 partials, counters) the kernel needs in its workspace: a
    partial tile of 8F x 128 a split of each tile, one arrival counter a
    tile; none with one split."""
    if ks == 1:
        return 0, 0
    rows = 8 * w8a8_frags(m)
    tiles = -(-m // rows) * -(-n // W8A8_COLS)
    return tiles * ks * rows * W8A8_COLS, tiles


@functools.lru_cache(maxsize=None)
def _w8a8_resident(frags: int, x_f32: bool, device: torch.device) -> int:
    """Blocks of the W8A8 kernel one SM of ``device`` keeps resident."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().w8a8_resident(8 * frags, int(x_f32),
                                   ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"W8A8 occupancy query failed: CUDA error {err}, "
                           f"{blocks.value} blocks")
    return blocks.value


_MAPS: dict = {}


def _w8a8_map(w_q: torch.Tensor) -> int:
    """Host address of the tensor map of the weight [K, N] int8 (TMA boxes
    of 64 rows x 128 columns): encoded once a weight, then cached (a map
    holds the address, shape and strides only, so a weight that takes a
    freed one's address and shape has the same map)."""
    key = (w_q.data_ptr(), tuple(w_q.shape))
    buf = _MAPS.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        err = _lib().w8a8_encode(w_q.data_ptr(), w_q.shape[0], w_q.shape[1],
                                 buf)
        if err != 0:
            raise RuntimeError(f"W8A8 tensor map failed: CUDA error {err}")
        _MAPS[key] = buf
    return ctypes.addressof(buf)


_WORKSPACES: dict = {}


def _w8a8_launch(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 split: int | None = None) -> torch.Tensor:
    """One launch of the W8A8 kernel on CUDA tensors. ``split`` overrides
    ``w8a8_plan``'s splits (the card tests hold every split to the same
    bits)."""
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
    x_f32 = x.dtype == torch.float32
    frags = w8a8_frags(m)
    resident = _w8a8_resident(frags, x_f32, x.device)
    ks, grid = w8a8_plan(m, k, n, sm_count(x.device), resident)
    if split is not None:
        if not 1 <= split <= k // W8A8_STAGE_ROWS:
            raise ValueError(f"split {split}: 1 to the {k // W8A8_STAGE_ROWS}"
                             f" stages of K={k}")
        tiles = -(-m // (8 * frags)) * -(-n // W8A8_COLS)
        ks = split
        grid = min(tiles * ks, sm_count(x.device) * resident)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part = count = None
    if ks > 1:   # float32 words of the workspace, taken as int32 by the kernel
        part, count = split_workspace(
            _WORKSPACES, (x.device.index, stream), *w8a8_workspace(m, n, ks),
            lambda size, dtype: torch.zeros((size,), dtype=dtype,
                                            device=x.device))
    with torch.cuda.device(x.device):
        err = _lib().int8_matmul_w8a8(
            x.data_ptr(), int(x_f32), _w8a8_map(w_q), scale.data_ptr(), m, k,
            n, ks, grid, None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_w8a8 launch failed: CUDA error "
                           f"{err}")
    int8_matmul_w8a8.launches += 1
    return out


def int8_matmul_w8a8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     block_n: int = 512) -> torch.Tensor:
    """y = quantize_activations(x) [M, K] @ int8 w_q [K, N], rescaled →
    [M, N] in x.dtype (``int8_matmul_w8a8_plain``'s arithmetic); on CUDA
    tensors one kernel launch, the quantization inside it."""
    if on_cpu(x, w_q, scale):
        return int8_matmul_w8a8_plain(x, w_q, scale)
    return _w8a8_launch(x, w_q, scale)


int8_matmul_w8a8.launches = 0
