"""Fused int8 decode MLP: wo → residual → RMSNorm → gate/up → SiLU·up →
down → residual in one kernel launch a layer (port of
``cmw_rag_tpu/ops/fused_mlp.py``).

All weights are int8 per output channel (``ops.int8_matmul.quantize_weight``
layout, w ≈ w_q · s); ``gateup_q`` is ONE [D, 2F] buffer, gate columns
first.

- ``fused_mlp_int8_xla`` (:41) is the golden, all float32; the engine's
  golden route runs the unfused XLA ops, not this.
- ``fused_mlp_int8_plain`` is the twin of the TPU kernel (:101, body
  ``_fused_mlp_kernel`` :59), whose rounding points it keeps: ``attn``
  rounded to bf16 before the wo product, ``x1 = x + attn @ wo`` in float32,
  the normed ``y`` rounded to bf16, ``g`` and ``u`` in float32, ``h =
  silu(g) · u`` rounded to bf16, the down sum in float32 times ``down_s``,
  the output in x's dtype.
- ``fused_mlp_int8`` is the wrapper. On CUDA tensors it launches the
  cooperative kernel of ``csrc/fused_mlp.cu`` (the megakernel's weight
  phases, ``csrc/weight_phases.cuh``; x and attn bf16, any S, D, A and F
  multiples of 64) and adds one to its ``launches`` count; on CPU tensors
  it runs the plain twin. There is no fallback. The launch follows the
  host plan ``weight_phases.mlp_plan`` and reads the weights through
  tensor maps encoded once a weight (``weight_phases.weight_maps``); its
  partial tiles, h, x1 and counters live in the per-(device, stream)
  workspace it shares with the megakernels (``weight_phases.workspace``),
  so a call allocates only its output. ``block_f`` is the TPU kernel's
  d_ff block and changes nothing here.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from cmw_rag_tpu_torch.device import need, on_cpu
from cmw_rag_tpu_torch.ops import cuda_build
from cmw_rag_tpu_torch.ops import weight_phases as WP


def fused_mlp_int8_xla(x, attn, wo_q, wo_s, ffn_norm_w, gateup_q, gateup_s,
                       down_q, down_s, eps: float = 1e-6):
    """Golden: x' = x + attn @ wo; y = rmsnorm(x', ffn_norm_w); g, u = y @
    gateup; out = x' + (silu(g) · u) @ down, all float32 → x.dtype."""
    f = down_q.shape[0]
    xf = x.float()
    x1 = xf + attn.float() @ (wo_q.float() * wo_s[None, :])
    var = x1.square().mean(dim=-1, keepdim=True)
    y = x1 * torch.rsqrt(var + eps) * ffn_norm_w.float()[None, :]
    gu = y @ (gateup_q.float() * gateup_s[None, :])
    h = torch.nn.functional.silu(gu[:, :f]) * gu[:, f:]
    out = x1 + h @ (down_q.float() * down_s[None, :])
    return out.to(x.dtype)


def mlp_tail_plain(x1, ffn_norm_w, gateup_q, gateup_s, down_q, down_s,
                   eps: float, dtype):
    """The part after ``x1`` with the kernel's rounding points (shared with
    the decoder-layer twin): → out in ``dtype``."""
    f = down_q.shape[0]
    var = x1.square().mean(dim=-1, keepdim=True)
    y = (x1 * torch.rsqrt(var + eps) * ffn_norm_w.float()[None, :]
         ).to(torch.bfloat16).float()
    g = (y @ gateup_q[:, :f].float()) * gateup_s[None, :f]
    u = (y @ gateup_q[:, f:].float()) * gateup_s[None, f:]
    h = (g * torch.sigmoid(g) * u).to(torch.bfloat16).float()
    return (x1 + (h @ down_q.float()) * down_s[None, :]).to(dtype)


def fused_mlp_int8_plain(x, attn, wo_q, wo_s, ffn_norm_w, gateup_q, gateup_s,
                         down_q, down_s, eps: float = 1e-6):
    """Twin of the kernel (the rounding points in the module docstring)."""
    a = attn.to(torch.bfloat16).float()
    x1 = x.float() + (a @ wo_q.float()) * wo_s[None, :]
    return mlp_tail_plain(x1, ffn_norm_w, gateup_q, gateup_s, down_q, down_s,
                          eps, x.dtype)


#: grid-wide waits a call: wo -> the FFN norm, gate/up -> down
GRID_WAITS = 2


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device, mt: int) -> int:
    """Blocks of the cooperative launch: all that can be resident at once
    at the most shared memory the plan gives the row tile (one a SM)."""
    with torch.cuda.device(device):
        n = _lib().fused_mlp_blocks(mt)
    if n <= 0:
        raise RuntimeError(f"fused_mlp_int8: occupancy query failed ({n})")
    return n


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("fused_mlp")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_mlp_int8.argtypes = ([p] * 6 + [i] * 4 + [f] + [i] * 3
                                       + [p] * 6 + [i] * 2 + [p])
        lib.fused_mlp_int8.restype = ctypes.c_int
        lib.fused_mlp_blocks.argtypes = [i]
        lib.fused_mlp_blocks.restype = ctypes.c_int
        lib.fused_mlp_encode.argtypes = [p, i, i, p]
        lib.fused_mlp_encode.restype = ctypes.c_int
        lib._typed = True
    return lib


def mlp_workspace(plan: WP.LayerPlan, s: int, d: int,
                  f: int) -> tuple[tuple[int, ...], int]:
    """Float32 words of each workspace buffer the kernel reads and writes
    (the split partial tiles, h as bf16, x1; each a multiple of 4 words,
    so that every buffer starts 16-byte aligned) and its int32 arrival
    counters."""
    sizes = (WP.part_words(plan), -(-s * f // 2), s * d)
    return tuple(-(-n // 4) * 4 for n in sizes), WP.tile_counters(plan)


def _launch(x, attn, wo_q, wo_s, ffn_norm_w, gateup_q, gateup_s, down_q,
            down_s, eps: float) -> torch.Tensor:
    """Check every operand and launch the kernel with the plan, the maps
    and the workspace; → out."""
    s, d = x.shape
    a = wo_q.shape[0]
    f = down_q.shape[0]
    need(x, "x", torch.bfloat16, (s, d))
    need(attn, "attn", torch.bfloat16, (s, a))
    need(wo_q, "wo_q", torch.int8, (a, d))
    need(gateup_q, "gateup_q", torch.int8, (d, 2 * f))
    need(down_q, "down_q", torch.int8, (f, d))
    for name, t, n in (("wo_s", wo_s, d), ("ffn_norm_w", ffn_norm_w, d),
                       ("gateup_s", gateup_s, 2 * f), ("down_s", down_s, d)):
        need(t, name, torch.float32, (n,))
    if d % WP.LAYER_ROWS or a % WP.LAYER_ROWS or f % WP.LAYER_ROWS:
        raise ValueError(f"D={d}, A={a} and F={f} must be multiples of "
                         f"{WP.LAYER_ROWS}")
    dev = x.device
    plan = WP.mlp_plan(s, d, a, f, _grid(dev, WP.layer_tile(s)))
    sizes, n_counts = mlp_workspace(plan, s, d, f)
    maps = WP.weight_maps(_lib().fused_mlp_encode, (wo_q, gateup_q, down_q),
                          "fused_mlp_int8")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        floats, counts = WP.workspace(dev, stream, sum(sizes), n_counts)
        part, h, x1 = (floats.data_ptr() + 4 * o
                       for o in itertools.accumulate((0,) + sizes[:-1]))
        ks_wo, ks_gu, ks_dn = (q.ks for q in plan.products[1:])
        err = _lib().fused_mlp_int8(
            x.data_ptr(), attn.data_ptr(), wo_s.data_ptr(),
            ffn_norm_w.data_ptr(), gateup_s.data_ptr(), down_s.data_ptr(),
            s, d, a, f, eps, ks_wo, ks_gu, ks_dn, part, h, x1,
            out.data_ptr(), maps, counts.data_ptr(), plan.ring, plan.grid,
            stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_int8 launch failed: CUDA error {err}")
    return out


def fused_mlp_int8(x, attn, wo_q, wo_s, ffn_norm_w, gateup_q, gateup_s,
                   down_q, down_s, block_f: int = 768, eps: float = 1e-6):
    """x [S, D] residual, attn [S, A] attention output (flattened heads) →
    [S, D] in x.dtype, with the kernel's rounding points."""
    args = (x, attn, wo_q, wo_s, ffn_norm_w, gateup_q, gateup_s, down_q,
            down_s)
    if on_cpu(*args):
        return fused_mlp_int8_plain(*args, eps=eps)
    out = _launch(*args, eps)
    fused_mlp_int8.launches += 1
    return out


fused_mlp_int8.launches = 0
