"""Host side of the int8 weight phases (``csrc/weight_phases.cuh``), shared
by the decoder-layer megakernels (``ops/decoder_layer.py``), the fused MLP
(``ops/fused_mlp.py``), which is the megakernel's back half, and the
weight-only int8 matmul (``ops/int8_matmul.py``), one product alone.

- The geometry: a TMA box of 128 columns x 64 contraction rows (one ring
  stage of 8 KB), at most 1024 contraction rows an item, a block's shared
  memory on sm_90 less the kernels' static share, at most 32 ring stages.
- The plans: ``layer_plan`` (QKV, wo, gate/up, down), ``mlp_plan`` (the
  same list with no QKV product) and ``matmul_plan`` (one product, in
  wo's slot), built by one helper: work items are (row
  tile, column tile, split of the contraction) of the products in phase
  order, block b taking items b, b + blocks, ...; the ring holds every
  stage of the busiest block where it fits.
- ``weight_map``, ``weight_maps``: the weights' tensor maps, each encoded
  once a weight and cached (every kernel's library encodes the same map).
- ``workspace``: the partial tiles, the buffers and the counters of one
  (device, stream), made once and grown when a call needs more; every
  launch leaves its counters 0, so the launches of one stream, the
  megakernels' and the fused MLP's alike, share it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cmw_rag_tpu_torch.ops.paged_attention import split_workspace

LAYER_COLS = 128
LAYER_ROWS = 64
LAYER_STAGE = LAYER_COLS * LAYER_ROWS
LAYER_KCAP = 1024
LAYER_SMEM_LIMIT = 232448 - 1024
LAYER_MAX_RING = 32


class Product(NamedTuple):
    """One weight product of the list: column tiles (gate/up: pairs of a
    gate and an up tile of the same columns; 0: not in this kernel's
    list), boxes a stage, splits of the contraction, its 64-row stages,
    output columns, the column of box 1 past box 0."""
    ctiles: int
    nb: int
    ks: int
    steps: int
    n: int
    box_off: int


#: the fused MLP's empty QKV slot
NO_PRODUCT = Product(0, 1, 1, 1, 0, 0)


class LayerPlan(NamedTuple):
    """A launch of the weight phases: row tile, row tiles, the four
    products (QKV, wo, gate/up, down), ring stages, blocks, dynamic shared
    memory bytes."""
    mt: int
    mtiles: int
    products: tuple
    ring: int
    grid: int
    smem: int


def layer_tile(s: int) -> int:
    """Rows of the row tile for ``s`` rows: 8 or 16 (the ``mma.sync``
    fragments hold 8 rows each; more rows take more row tiles, since a
    32-row tile's accumulators spill)."""
    return 8 if s <= 8 else 16


def layer_smem(mt: int, ring: int) -> int:
    """Dynamic shared memory of the kernels: slack to align the ring, the
    ring, the activations [mt, 1024 + 8] bf16, the tile buffer
    [mt, 260] float32."""
    return (1024 + mt * (LAYER_KCAP + 8) * 2 + mt * (2 * LAYER_COLS + 4) * 4
            + ring * LAYER_STAGE)


def layer_max_ring(mt: int) -> int:
    """The most ring stages that fit beside the row tile's buffers."""
    return min(LAYER_MAX_RING,
               (LAYER_SMEM_LIMIT - layer_smem(mt, 0)) // LAYER_STAGE)


#: a SM's shared memory on sm_90; the weight-only matmul keeps two blocks a
#: SM, each within half of it less the 1 KB the card reserves a block and
#: the kernel's static share
SM_SMEM = 233472
MM_SMEM_LIMIT = SM_SMEM // 2 - 1024 - 1024


def mm_max_ring(mt: int) -> int:
    """The most ring stages of the weight-only matmul (``mm_max_ring`` of
    ``csrc/int8_matmul.cu``): two blocks a SM."""
    return (MM_SMEM_LIMIT - layer_smem(mt, 0)) // LAYER_STAGE


def layer_items(plan: LayerPlan):
    """The list of work items in the kernels' order (``item_at`` of
    ``csrc/weight_phases.cuh``): → [(product, row tile, column tile, split,
    first stage, end stage)]; block b runs items b, b + grid, ..."""
    items = []
    for pr, q in enumerate(plan.products):
        for i in range(plan.mtiles * q.ctiles * q.ks):
            ki, tile = i % q.ks, i // q.ks
            items.append((pr, tile // q.ctiles, tile % q.ctiles, ki,
                          ki * q.steps // q.ks, (ki + 1) * q.steps // q.ks))
    return items


def layer_block_stages(plan: LayerPlan) -> list[int]:
    """Ring stages (8 KB boxes) each block loads over the launch."""
    stages = [0] * plan.grid
    for g, (pr, _, _, _, s0, s1) in enumerate(layer_items(plan)):
        stages[g % plan.grid] += (s1 - s0) * plan.products[pr].nb
    return stages


def _plan(s: int, specs, blocks: int, max_ring=layer_max_ring,
          split_blocks: int | None = None) -> LayerPlan:
    """The plan for ``s`` rows of the products ``specs`` (each (output
    columns, boxes a stage, contraction rows, box 1's offset), or None for
    an empty slot) on ``blocks`` co-resident blocks. Each product is split
    so that its items about fill ``split_blocks`` (the grid by default)
    once (``split_blocks`` // tiles splits, at most one a stage), and at
    least so far that an item's activations fit its 1024 rows. The ring
    holds every stage of the busiest block where it fits, else as many as
    fit, ``max_ring(row tile)`` (a ring that runs ahead)."""
    mt = layer_tile(s)
    mtiles = -(-s // mt)
    cap = LAYER_KCAP // LAYER_ROWS
    products = []
    for spec in specs:
        if spec is None:
            products.append(NO_PRODUCT)
            continue
        n, nb, k, box_off = spec
        ctiles = -(-n // LAYER_COLS)
        steps = k // LAYER_ROWS
        ks = min(steps, max(1, (split_blocks or blocks) // (mtiles * ctiles)))
        ks = max(ks, -(-steps // cap))
        products.append(Product(ctiles, nb, ks, steps, n, box_off))
    plan = LayerPlan(mt, mtiles, tuple(products), 2, blocks, 0)
    ring = max(2, min(max(layer_block_stages(plan)), max_ring(mt)))
    return plan._replace(ring=ring, smem=layer_smem(mt, ring))


@functools.lru_cache(maxsize=None)
def layer_plan(s: int, d: int, hq: int, hkv: int, dh: int, f: int,
               blocks: int) -> LayerPlan:
    """The megakernel's plan for ``s`` rows of a layer (D, Hq, Hkv, Dh, F)
    on ``blocks`` co-resident blocks (one a SM): QKV, wo, gate/up, down (up
    to 16 rows at qwen3guard-0.6b's width the ring holds all of a block's
    weights: all in flight from kernel entry)."""
    a3, a = (hq + 2 * hkv) * dh, hq * dh
    return _plan(s, ((a3, 1, d, 0), (d, 1, a, 0), (f, 2, d, f), (d, 1, f, 0)),
                 blocks)


@functools.lru_cache(maxsize=None)
def mlp_plan(s: int, d: int, a: int, f: int, blocks: int) -> LayerPlan:
    """The fused MLP's plan for ``s`` rows (D, A the attention width, F) on
    ``blocks`` co-resident blocks: the megakernel's list with no QKV
    product, wo, gate/up and down split alike."""
    return _plan(s, (None, (d, 1, a, 0), (f, 2, d, f), (d, 1, f, 0)), blocks)


@functools.lru_cache(maxsize=None)
def matmul_plan(m: int, k: int, n: int, blocks: int, sms: int) -> LayerPlan:
    """The weight-only int8 matmul's plan for [m, k] @ [k, n] on ``blocks``
    co-resident blocks (two on each of ``sms`` SMs): the list with one
    product, in wo's slot (whose input the kernels take as given, rounded
    to bf16), split so that its items about fill the SMs once (a block a SM
    with more splits, each merged, was slower at the fused QKV), the ring
    within ``mm_max_ring``; the grid no larger than the items (no block
    idle from the start)."""
    plan = _plan(m, (None, (n, 1, k, 0), None, None), blocks, mm_max_ring,
                 sms)
    q = plan.products[1]
    return plan._replace(grid=min(plan.grid, plan.mtiles * q.ctiles * q.ks))


def part_words(plan: LayerPlan) -> int:
    """Float32 words of the split partial tiles: the most any product
    split more than once writes (row tiles x column tiles x splits x row
    tile x boxes x 128)."""
    return max([plan.mtiles * q.ctiles * q.ks * plan.mt * q.nb * LAYER_COLS
                for q in plan.products if q.ks > 1], default=0)


def tile_counters(plan: LayerPlan) -> int:
    """The products' arrival counters: one a (row tile, column tile) of
    the product with the most."""
    return max(plan.mtiles * q.ctiles for q in plan.products)


_MAPS: dict = {}


def weight_map(encode, w: torch.Tensor, who: str) -> ctypes.Array:
    """The tensor map of the weight ``w`` [K, N] int8 (TMA boxes of 64 rows
    x 128 columns), 128 bytes: encoded once a weight by the C function
    ``encode(ptr, k, n, map)``, then cached (a map holds the address, shape
    and strides only, so a weight that takes a freed one's address and
    shape has the same map; every library's encoder gives the same map).
    ``who`` names the caller in errors."""
    key = (w.data_ptr(), tuple(w.shape))
    one = _MAPS.get(key)
    if one is None:
        one = ctypes.create_string_buffer(128)
        err = encode(w.data_ptr(), w.shape[0], w.shape[1], one)
        if err != 0:
            raise RuntimeError(f"{who}: tensor map failed: CUDA error {err}")
        _MAPS[key] = one
    return one


def weight_maps(encode, weights, who: str) -> ctypes.Array:
    """The weights' maps (``weight_map``), 128 bytes each, in order, in one
    buffer."""
    buf = ctypes.create_string_buffer(128 * len(weights))
    for i, w in enumerate(weights):
        ctypes.memmove(ctypes.addressof(buf) + 128 * i,
                       weight_map(encode, w, who), 128)
    return buf


_WORKSPACES: dict = {}


def workspace(device: torch.device, stream: int, n_float: int,
              n_counts: int) -> tuple:
    """The weight phases' workspace on ``stream``: at least ``n_float``
    float32 words and ``n_counts`` int32 counters, zero when made; each
    launch leaves its counters 0, so the launches of one stream share it
    (``paged_attention.split_workspace``)."""
    return split_workspace(
        _WORKSPACES, (device.index, stream), n_float, n_counts,
        lambda n, dtype: torch.zeros((n,), dtype=dtype, device=device))
