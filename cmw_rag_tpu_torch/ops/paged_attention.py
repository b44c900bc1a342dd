"""Paged decode attention: one query token per slot over a paged KV pool
(port of ``cmw_rag_tpu/ops/paged_attention.py``).

Each serving slot holds a block table of page indices into a pool
``[L, P, page, Hkv, Dh]`` (one layer of it ``[P, page, Hkv, Dh]``); slot s
attends over positions ``pos < lens[s]``, position ``pos`` living in page
``tables[s, pos // page]`` at row ``pos % page``; query head h reads KV head
``h // (Hq // Hkv)``. Scores are float32 products scaled by 1/sqrt(Dh),
softmaxed in float32, the value product is float32, and the output is cast
to q's dtype. int8 pools carry page-granular float32 scales ``[L, P, Hkv]``.

- ``paged_decode_attention_xla`` is the gather golden (JAX :36) and the plain
  twin of the bf16 kernel; ``paged_decode_attention_xla_kv_int8`` (:275), which
  dequantizes to q's dtype first, is the twin of the int8 one.
- ``paged_decode_attention_dma`` (:469), ``paged_decode_attention_dma_scatter``
  (:559) and ``paged_decode_attention_dma_kv_int8`` (:858) are the wrappers
  the engine calls. ``paged_decode_attention`` (:641, one layer's pool) and
  ``paged_decode_attention_pooled`` (:187) are two TPU schedules of the same
  function and here thin aliases over the same kernel. On CUDA tensors each
  launches ``csrc/paged_attention.cu`` once (bf16 q; bf16 pages, with the
  K/V row write fused in for the scatter wrapper, or int8 pages; Dh 64 or
  128, Hq / Hkv in 1, 2, 4, 8) and adds one to its own ``launches`` count;
  on CPU tensors it runs its plain twin. Wrong device, dtype, shape or
  contiguity raises: there is no fallback. The kernel's TMA boxes of
  gcd(page, 64, split) rows must fill a multiple of 128 bytes, so int8
  pages at Dh 64 with an odd page (or an odd split) are refused. The kernel cuts each slot's
  context into splits of ``paged_split`` positions, chosen from the table
  width and the blocks the card keeps resident, and merges them in the
  same launch.
- The wrappers keep the JAX signature's ``worklist=`` and ``chunk=``; the
  kernel reads ``tables`` and ``lens`` itself, so they change nothing.
  ``make_decode_worklist`` (:292) stays for callers of that signature.

- ``paged_decode_attention_dma_slot`` (:1024, body ``_slot_attn_inner``
  :931) is slot-major: slot s reads its contiguous partition of the pool
  (logical page j at physical ``base0 + s * maxp_slot + j``, the engine's
  partitioned allocator), ``cap`` pages of it, with a single-pass float32
  softmax. Its twin ``paged_decode_attention_slot_plain`` is the gather
  golden over that table (``slot_tables``). On CUDA tensors it launches
  ``csrc/slot_attention.cu`` (bf16; Dh 64 or 128, Hq / Hkv at most 8).

- That kernel and the decoder-layer megakernels cut each (slot, KV head)'s
  context into splits of ``ATTN_SPLIT`` positions (flash-decoding,
  ``attend_split()`` of ``csrc/int8_decode.cuh``) and merge the splits'
  partials in split order. ``attention_splits`` and ``split_scratch`` size
  the grid and the scratch from what the host holds (a cap or a table
  width, never the lengths on the device);
  ``paged_decode_attention_split_plain`` is the plain model of the split
  and the merge (over bf16 or int8 pages, with this step's row taken from
  ``k_new``/``v_new`` as the scatter kernel takes it), for tests: it meets
  the twin within float32 rounding (only the order of the sums differs).
- Both kernels keep their partials and merge counters in one workspace a
  (device, stream) (``split_workspace``), sized from the host's table width
  or cap and allocated only when a call needs more: launches on one stream
  run in order and each leaves its counters 0; two streams never share
  counters.

- ``paged_decode_attention_dma_batched`` (:1241, body
  ``_paged_dma_batched_kernel`` :1111, the engine's opt-in ``attn_batched``)
  runs the TPU kernel's iterations across slots over a flat worklist; its
  docstring gives it the semantics of ``paged_decode_attention_xla``
  (:1256-1257), which is all of its content beyond the TPU schedule. Here
  it is an alias of the bf16 kernel with its own ``launches`` count, as is
  the scatter wrapper with ``batched=True``. ``make_decode_worklist_flat``
  (:1086) stays for callers of that signature.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cmw_rag_tpu_torch.device import need, on_cpu, sm_count
from cmw_rag_tpu_torch.ops import cuda_build

NEG_INF = -3.0e38
KV_HEADROOM = 1.25   # a page's scale is set by its FIRST token; later tokens
                     # clip at ±127, and the headroom keeps that rare
#: positions of one split of decode attention in the slot-major kernel and
#: the megakernels (at most 128, the kernels' shared score buffer); read at
#: each call, so that the card tests and chip_smoke.py can run both sizes
ATTN_SPLIT = 64
#: the paged kernel's split (positions) is at least one stage of its ring,
#: unless the table is narrower
PAGED_MIN_SPLIT = 64
#: the paged kernel's work items may fill this many waves of the blocks the
#: card keeps resident before ``paged_split`` widens the split
PAGED_WAVES = 2


# ------------------------------------------------------------------- twins


def paged_decode_attention_xla(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, tables: torch.Tensor,
                               lens: torch.Tensor) -> torch.Tensor:
    """Golden: gather the slot's pages into a dense context and attend.
    q [S, Hq, Dh]; pools [P, page, Hkv, Dh]; tables [S, maxp]; lens [S]
    (including the new token) → [S, Hq, Dh] in q.dtype."""
    s, hq, dh = q.shape
    _, page, hkv, _ = k_pool.shape
    maxp = tables.shape[1]
    rep = hq // hkv
    t = tables.long()
    k_ctx = k_pool[t].reshape(s, maxp * page, hkv, dh)
    v_ctx = v_pool[t].reshape(s, maxp * page, hkv, dh)
    if rep > 1:
        k_ctx = torch.repeat_interleave(k_ctx, rep, dim=2)
        v_ctx = torch.repeat_interleave(v_ctx, rep, dim=2)
    scores = torch.einsum("shd,smhd->shm", q.float(), k_ctx.float())
    scores = scores / math.sqrt(dh)
    pos = torch.arange(maxp * page, device=q.device)[None, None, :]
    scores = torch.where(pos < lens.long()[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("shm,smhd->shd", probs, v_ctx.float())
    return out.to(q.dtype)


def quantize_kv_page(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(page, head) symmetric int8: x [..., page, Hkv, Dh] → (int8 of the
    same shape, float32 scales [..., Hkv])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=(-3, -1))
    scale = torch.clamp(absmax, min=1e-8) * (KV_HEADROOM / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale.float()


def quantize_kv_token(x: torch.Tensor, page_scale: torch.Tensor) -> torch.Tensor:
    """Quantize ONE token's K/V [S, Hkv, Dh] against its page's scale
    [S, Hkv] (clipping at ±127)."""
    q = torch.clamp(torch.round(x.float() / page_scale[..., None]), -127, 127)
    return q.to(torch.int8)


def paged_decode_attention_xla_kv_int8(q, k_pool_q, k_scale, v_pool_q, v_scale,
                                       tables, lens) -> torch.Tensor:
    """Golden for int8 pages [P, page, Hkv, Dh] with scales [P, Hkv]:
    dequantize to q's dtype, then attend."""
    k_pool = (k_pool_q.float() * k_scale[:, None, :, None]).to(q.dtype)
    v_pool = (v_pool_q.float() * v_scale[:, None, :, None]).to(q.dtype)
    return paged_decode_attention_xla(q, k_pool, v_pool, tables, lens)


def make_decode_worklist(tables: torch.Tensor, lens: torch.Tensor, page: int,
                         chunk: int = 1):
    """Slot-major compacted (slot, physical page, logical page) worklist of
    the TPU kernels: each slot's entries padded to a ``chunk`` multiple
    (padding: page 0, logical page ``maxp``), then sentinel entries of slot S.
    → (wl_slot, wl_page, wl_j, wl_n) int32. Requires ``maxp % chunk == 0``."""
    s, maxp = tables.shape
    if maxp % chunk:
        raise ValueError(f"maxp={maxp} must be a multiple of chunk={chunk}")
    dev = tables.device
    lens = lens.long()
    used = (lens + page - 1) // page
    used_pad = ((used + chunk - 1) // chunk) * chunk
    j_idx = torch.arange(maxp, device=dev)[None, :]
    real = j_idx < used[:, None]
    occupied = j_idx < used_pad[:, None]
    s_idx = torch.arange(s, device=dev)[:, None].expand(s, maxp)
    order = torch.argsort((~occupied).reshape(-1).to(torch.int32), stable=True)
    wl_slot = torch.where(occupied, s_idx, s).reshape(-1)[order].to(torch.int32)
    wl_page = torch.where(real, tables.long(), 0).reshape(-1)[order].to(torch.int32)
    wl_j = torch.where(real, j_idx, maxp).reshape(-1)[order].to(torch.int32)
    wl_slot = torch.cat([wl_slot, torch.full((chunk,), s, dtype=torch.int32,
                                             device=dev)])
    wl_n = occupied.sum().to(torch.int32)[None]
    return wl_slot, wl_page, wl_j, wl_n


def make_decode_worklist_flat(tables: torch.Tensor, lens: torch.Tensor,
                              page: int, chunk: int = 1):
    """The (slot, physical page, logical page) worklist of the TPU's batched
    kernel: every occupied page once, slot-major, then ``chunk`` dummies
    (slot S, page 0, logical page ``maxp``); ``wl_n`` is the occupied count
    rounded up to a ``chunk`` multiple. → (wl_slot, wl_page, wl_j, wl_n)
    int32."""
    s, maxp = tables.shape
    dev = tables.device
    used = (lens.long() + page - 1) // page
    j_idx = torch.arange(maxp, device=dev)[None, :]
    real = j_idx < used[:, None]
    s_idx = torch.arange(s, device=dev)[:, None].expand(s, maxp)
    order = torch.argsort((~real).reshape(-1).to(torch.int32), stable=True)
    wl_slot = torch.where(real, s_idx, s).reshape(-1)[order].to(torch.int32)
    wl_page = torch.where(real, tables.long(), 0).reshape(-1)[order].to(torch.int32)
    wl_j = torch.where(real, j_idx, maxp).reshape(-1)[order].to(torch.int32)

    def tail(v):
        return torch.full((chunk,), v, dtype=torch.int32, device=dev)
    wl_slot = torch.cat([wl_slot, tail(s)])
    wl_page = torch.cat([wl_page, tail(0)])
    wl_j = torch.cat([wl_j, tail(maxp)])
    n_real = real.sum().to(torch.int32)
    wl_n = ((n_real + chunk - 1) // chunk * chunk)[None]
    return wl_slot, wl_page, wl_j, wl_n


# ------------------------------------------------------------------ kernel


def _lib() -> ctypes.CDLL:
    lib = cuda_build.library("paged_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_bf16.argtypes = ([p] * 5 + [i] + [p] * 6
                                             + [i] * 8 + [p] * 4)
        lib.paged_attention_bf16.restype = ctypes.c_int
        lib.paged_attention_int8.argtypes = ([p] * 7 + [i] + [p] * 2
                                             + [i] * 8 + [p] * 4)
        lib.paged_attention_int8.restype = ctypes.c_int
        lib.paged_attention_encode.argtypes = [p, i, ctypes.c_longlong, i, i,
                                               i, p]
        lib.paged_attention_encode.restype = ctypes.c_int
        lib.paged_attention_resident.argtypes = [i, i, i, p]
        lib.paged_attention_resident.restype = ctypes.c_int
        lib._typed = True
    return lib


def _layer(pools: torch.Tensor, layer: int) -> torch.Tensor:
    if pools.dim() != 5 or not 0 <= layer < pools.shape[0]:
        raise ValueError(f"layer {layer} of a pool shaped {tuple(pools.shape)}")
    return pools[layer]


@functools.lru_cache(maxsize=None)
def paged_split(s: int, hkv: int, maxp: int, page: int, sms: int,
                per_sm: int) -> int:
    """Positions of one split of the paged kernel over S slots of ``maxp``
    pages of ``page`` rows, on a card of ``sms`` SMs that keeps ``per_sm``
    of its blocks resident on each: the narrowest split that is a multiple
    of the page or a divisor of it, at least ``PAGED_MIN_SPLIT`` (or the
    whole table), whose S x Hkv x ceil(maxp * page / split) work items fit
    ``PAGED_WAVES`` waves of resident blocks; the whole table when none
    does. Only what the host holds enters, never the lengths."""
    positions = maxp * page
    sizes = sorted({page // d for d in range(1, page + 1) if page % d == 0}
                   | {page * k for k in range(1, maxp + 1)})
    sizes = [n for n in sizes if min(PAGED_MIN_SPLIT, positions) <= n]
    room = PAGED_WAVES * sms * per_sm
    for n in sizes:
        if s * hkv * -(-positions // n) <= room:
            return n
    return positions


@functools.lru_cache(maxsize=None)
def _resident(int8: bool, dh: int, rep: int, device: torch.device) -> int:
    """Blocks of the paged kernel one SM of ``device`` keeps resident."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib().paged_attention_resident(int(int8), dh, rep,
                                              ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"paged attention occupancy query failed: CUDA "
                           f"error {err}, {blocks.value} blocks")
    return blocks.value


_WORKSPACES: dict = {}


def split_workspace(cache: dict, key, n_part: int, n_counts: int, make):
    """The workspace of split attention kept in ``cache`` under ``key`` (on
    the card: (device index, stream)): at least ``n_part`` float32 partials
    and ``n_counts`` int32 merge counters, zero when made. Each launch
    leaves its counters 0 (the block that merges a (slot, KV head) sets its
    counter back), so the launches of one stream, which run in order, share
    a workspace, and another stream gets its own. A buffer is made anew, by
    ``make(n, dtype)``, only when a call needs more than it holds.
    → (partials, counters)."""
    part, count = cache.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = make(n_part, torch.float32)
    if count is None or count.numel() < n_counts:
        count = make(n_counts, torch.int32)
    cache[key] = (part, count)
    return part, count


def _workspace(device: torch.device, stream: int, n_part: int,
               n_counts: int) -> tuple:
    return split_workspace(
        _WORKSPACES, (device.index, stream), n_part, n_counts,
        lambda n, dtype: torch.zeros((n,), dtype=dtype, device=device))


_MAPS: dict = {}


def _pool_map(pools: torch.Tensor, box: int) -> int:
    """Host address of the tensor map of the stacked pools [L, P, page,
    Hkv, Dh] (bf16 or int8), viewed as [L * P * page, Hkv, Dh] with TMA
    boxes of [box, 1, Dh]: encoded once a pool and box, then cached (a map
    holds the address, shape and strides only, so a pool that takes a
    freed one's address and shape has the same map)."""
    key = (pools.data_ptr(), tuple(pools.shape), pools.dtype, box)
    buf = _MAPS.get(key)
    if buf is None:
        layers, n_pages, page, hkv, dh = pools.shape
        buf = ctypes.create_string_buffer(128)
        err = _lib().paged_attention_encode(
            pools.data_ptr(), int(pools.dtype == torch.int8),
            layers * n_pages * page, hkv, dh, box, buf)
        if err != 0:
            raise RuntimeError(f"paged attention tensor map failed: CUDA "
                               f"error {err}")
        _MAPS[key] = buf
    return ctypes.addressof(buf)


def _launch(q, k_pools, v_pools, layer, tables, lens, k_scales=None,
            v_scales=None, k_new=None, v_new=None, page_idx=None, off=None,
            split=None) -> torch.Tensor:
    """Layer ``layer`` of the stacked pools [L, P, page, Hkv, Dh] (bf16, or
    int8 with scales [L, P, Hkv]); the fused write when ``k_new`` is
    given. ``split`` (positions) overrides ``paged_split``'s, for the card
    tests and chip_smoke.py, which check and time other splits."""
    k_pool, v_pool = _layer(k_pools, layer), _layer(v_pools, layer)
    if q.dim() != 3:
        raise ValueError("q must be [S, Hq, Dh]")
    s, hq, dh = q.shape
    n_layers, n_pages, page, hkv, _ = k_pools.shape
    maxp = tables.shape[-1]
    int8 = k_scales is not None
    pool_dtype = torch.int8 if int8 else torch.bfloat16
    need(q, "q", torch.bfloat16, (s, hq, dh))
    need(k_pools, "k_pools", pool_dtype, (n_layers, n_pages, page, hkv, dh))
    need(v_pools, "v_pools", pool_dtype, (n_layers, n_pages, page, hkv, dh))
    need(tables, "tables", torch.int32, (s, maxp))
    need(lens, "lens", torch.int32, (s,))
    k_scale = v_scale = None
    if int8:
        k_scale, v_scale = k_scales[layer], v_scales[layer]
        need(k_scale, "k_scale", torch.float32, (n_pages, hkv))
        need(v_scale, "v_scale", torch.float32, (n_pages, hkv))
    if k_new is not None:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            need(t, name, torch.bfloat16, (s, hkv, dh))
        need(page_idx, "page_idx", torch.int32, (s,))
        need(off, "off", torch.int32, (s,))
    if hkv < 1 or hq % hkv or hq // hkv not in (1, 2, 4, 8):
        raise ValueError(f"Hq={hq} over Hkv={hkv}: the kernel takes a ratio "
                         f"of 1, 2, 4 or 8")
    if dh not in (64, 128):
        raise ValueError(f"head dim {dh} not in (64, 128)")
    rows = n_layers * n_pages * page
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} pool rows: TMA row coordinates are int32")
    rep = hq // hkv
    split = split or paged_split(s, hkv, maxp, page, sm_count(q.device),
                                 _resident(int8, dh, rep, q.device))
    box = math.gcd(page, 64, split)     # rows a TMA box: one page at most
    if box * dh * k_pools.element_size() % 128:
        raise ValueError(f"page {page} and split {split} give TMA boxes of "
                         f"{box} rows, not a multiple of 128 bytes")
    n_split = -(-maxp * page // split)
    out = torch.empty_like(q)
    lib = _lib()
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    maps = (_pool_map(k_pools, box), _pool_map(v_pools, box),
            layer * n_pages * page)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = count = None
        if n_split > 1:
            part, count = _workspace(q.device, stream,
                                     s * hkv * n_split * rep * (dh + 2),
                                     s * hkv)
        if int8:
            err = lib.paged_attention_int8(
                q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
                v_pool.data_ptr(), v_scale.data_ptr(), *maps,
                tables.data_ptr(), lens.data_ptr(), s, hq, hkv, dh, page,
                maxp, split, box, ptr(part), ptr(count), out.data_ptr(),
                stream)
        else:
            err = lib.paged_attention_bf16(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *maps,
                tables.data_ptr(), lens.data_ptr(), ptr(k_new), ptr(v_new),
                ptr(page_idx), ptr(off), s, hq, hkv, dh, page, maxp, split,
                box, ptr(part), ptr(count), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"paged attention launch failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------- wrappers


def paged_decode_attention_dma(q: torch.Tensor, k_pools: torch.Tensor,
                               v_pools: torch.Tensor, tables: torch.Tensor,
                               lens: torch.Tensor, layer: int, worklist=None,
                               chunk: int = 1) -> torch.Tensor:
    """Paged decode attention over layer ``layer`` of the stacked pools
    [L, P, page, Hkv, Dh] → [S, Hq, Dh]."""
    if on_cpu(q, k_pools, v_pools, tables, lens):
        return paged_decode_attention_xla(q, _layer(k_pools, layer),
                                          _layer(v_pools, layer), tables, lens)
    out = _launch(q, k_pools, v_pools, layer, tables, lens)
    paged_decode_attention_dma.launches += 1
    return out


def paged_decode_attention_dma_scatter(q, k_new, v_new, page_idx, off,
                                       k_pools, v_pools, tables, lens,
                                       layer: int, worklist=None,
                                       chunk: int = 1, batched: bool = False):
    """Write this step's rows k_new/v_new [S, Hkv, Dh] at (page_idx[s],
    off[s]) of layer ``layer``, then attend as ``paged_decode_attention_dma``;
    → (out [S, Hq, Dh], k_pools, v_pools). The pools are updated IN PLACE,
    as the JAX kernel aliases them. (page_idx[s], off[s]) must be position
    lens[s] - 1 of slot s, and active slots must write distinct rows (the
    engine's idle slots all write row 0 of the null page 0, which only they
    read): the kernel's block for slot s takes that row from k_new/v_new.
    ``batched`` (the TPU's cross-slot iterations) changes nothing."""
    if on_cpu(q, k_new, v_new, page_idx, off, k_pools, v_pools, tables, lens):
        kp, vp = _layer(k_pools, layer), _layer(v_pools, layer)
        kp[page_idx.long(), off.long()] = k_new.to(kp.dtype)
        vp[page_idx.long(), off.long()] = v_new.to(vp.dtype)
        return paged_decode_attention_xla(q, kp, vp, tables, lens), k_pools, v_pools
    out = _launch(q, k_pools, v_pools, layer, tables, lens, k_new=k_new,
                  v_new=v_new, page_idx=page_idx, off=off)
    paged_decode_attention_dma_scatter.launches += 1
    return out, k_pools, v_pools


def paged_decode_attention_dma_kv_int8(q, k_pools_q, k_scales, v_pools_q,
                                       v_scales, tables, lens, layer: int,
                                       worklist=None,
                                       chunk: int = 1) -> torch.Tensor:
    """Paged decode attention over int8 pools [L, P, page, Hkv, Dh] with
    page-granular scales [L, P, Hkv] → [S, Hq, Dh]."""
    if on_cpu(q, k_pools_q, k_scales, v_pools_q, v_scales, tables, lens):
        return paged_decode_attention_xla_kv_int8(
            q, _layer(k_pools_q, layer), k_scales[layer],
            _layer(v_pools_q, layer), v_scales[layer], tables, lens)
    out = _launch(q, k_pools_q, v_pools_q, layer, tables, lens,
                  k_scales=k_scales, v_scales=v_scales)
    paged_decode_attention_dma_kv_int8.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lens: torch.Tensor) -> torch.Tensor:
    """Alias over one layer's pool [P, page, Hkv, Dh] (the TPU's
    (slot, page) grid schedule of the same function)."""
    if on_cpu(q, k_pool, v_pool, tables, lens):
        return paged_decode_attention_xla(q, k_pool, v_pool, tables, lens)
    out = _launch(q, k_pool[None], v_pool[None], 0, tables, lens)
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention_pooled(q: torch.Tensor, k_pools: torch.Tensor,
                                  v_pools: torch.Tensor, tables: torch.Tensor,
                                  lens: torch.Tensor,
                                  layer: int) -> torch.Tensor:
    """Alias over layer ``layer`` of the stacked pools (the TPU's worklist
    schedule of the same function)."""
    if on_cpu(q, k_pools, v_pools, tables, lens):
        return paged_decode_attention_xla(q, _layer(k_pools, layer),
                                          _layer(v_pools, layer), tables, lens)
    out = _launch(q, k_pools, v_pools, layer, tables, lens)
    paged_decode_attention_pooled.launches += 1
    return out


def slot_tables(s: int, cap: int, maxp_slot: int, base0: int = 1,
                device=None) -> torch.Tensor:
    """The partitioned block table [S, cap]: slot s's logical page j is
    physical page ``base0 + s * maxp_slot + j``."""
    rows = torch.arange(s, device=device, dtype=torch.int32)[:, None]
    return base0 + rows * maxp_slot + torch.arange(
        cap, device=device, dtype=torch.int32)[None, :]


def paged_decode_attention_slot_plain(q, k_pool, v_pool, lens, cap: int,
                                      maxp_slot: int,
                                      base0: int = 1) -> torch.Tensor:
    """Twin of the slot-major kernel: the gather golden over the partitioned
    table of ``cap`` pages (positions past ``cap * page`` do not exist)."""
    tables = slot_tables(q.shape[0], cap, maxp_slot, base0, q.device)
    return paged_decode_attention_xla(q, k_pool, v_pool, tables, lens)


def attention_splits(positions: int, split: int) -> int:
    """Splits a (slot, KV head) is given when it may hold up to
    ``positions`` positions (the kernels' ``live_splits``: at least one)."""
    if not 1 <= split <= 128:
        raise ValueError(f"split {split} not in [1, 128]")
    return max(1, -(-positions // split))


def split_scratch(s: int, hkv: int, rep: int, dh: int, positions: int,
                  split: int) -> tuple[int, tuple, int]:
    """Grid and scratch of split attention over S slots of at most
    ``positions`` positions: → (n_split, the shape of the partials
    [S, Hkv, n_split, rep, Dh + 2] float32 (each split's m, l and
    accumulator), the number of int32 counters, one a (slot, KV head))."""
    n_split = attention_splits(positions, split)
    return n_split, (s, hkv, n_split, rep, dh + 2), s * hkv


def paged_decode_attention_split_plain(q, k_pool, v_pool, tables, lens,
                                       split: int, k_scale=None, v_scale=None,
                                       k_new=None, v_new=None) -> torch.Tensor:
    """Plain model of split attention (tests only): the context of each
    slot (``tables`` [S, maxp] over one layer's pool, positions < lens) cut
    into splits of ``split`` positions; each split's max m_j, sum l_j of
    e^(s - m_j) and accumulator acc_j in float32 (m_j = -inf, l_j = 0 and
    acc_j = 0 for a split past the length), then merged in split order:
    o = sum_j e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j, 1e-30). Rows
    past the length are not weighted (NaN there stays out). int8 pages
    carry scales [P, Hkv] (``k_scale``, ``v_scale``): a score is
    (q . k_int8) * k_scale / sqrt(Dh) and p * v_scale weighs v_int8, as the
    kernels fold them. With ``k_new``/``v_new`` [S, Hkv, Dh] the row of
    position lens - 1 is taken from them, never from the pool (the scatter
    kernel's fused write). → [S, Hq, Dh] in q.dtype."""
    s, hq, dh = q.shape
    _, page, hkv, _ = k_pool.shape
    rep = hq // hkv
    positions = tables.shape[1] * page
    if split < 1:
        raise ValueError(f"split {split} < 1")
    n = -(-positions // split) or 1
    width = n * split
    t = tables.long()
    last = lens.long() - 1
    fused = torch.nonzero((last >= 0) & (last < positions))[:, 0]

    def context(pool, new):
        ctx = pool[t].reshape(s, -1, hkv, dh).float()
        if new is not None:                               # this step's row
            ctx[fused, last[fused]] = new[fused].float()
        ctx = torch.nn.functional.pad(ctx, (0, 0, 0, 0, 0,
                                            width - ctx.shape[1]))
        return torch.repeat_interleave(ctx, rep, dim=2)   # [S, W, Hq, Dh]

    def scales(scale):                                    # → [S, Hq, W]
        if scale is None:
            return torch.ones((s, hq, width), device=q.device)
        sc = scale[t][:, :, None, :].expand(-1, -1, page, -1)
        sc = torch.nn.functional.pad(sc.reshape(s, positions, hkv).float(),
                                     (0, 0, 0, width - positions), value=1.0)
        return torch.repeat_interleave(sc, rep, dim=2).transpose(1, 2)
    pos = torch.arange(width, device=q.device)
    live = pos[None, :] < lens.long().clamp(max=positions)[:, None]
    k_ctx = torch.where(live[:, :, None, None], context(k_pool, k_new), 0.0)
    v_ctx = torch.where(live[:, :, None, None], context(v_pool, v_new), 0.0)
    scores = (torch.einsum("shd,swhd->shw", q.float(), k_ctx)
              * scales(k_scale) / math.sqrt(dh))
    scores = torch.where(live[:, None, :], scores, -math.inf)
    scores = scores.reshape(s, hq, n, split)
    m = scores.amax(dim=-1)                               # [S, Hq, n]
    p = torch.where(scores == -math.inf, 0.0,
                    torch.exp(scores - m[..., None]))
    l = p.sum(dim=-1)
    acc = torch.einsum("shnw,snwhd->shnd",
                       p * scales(v_scale).reshape(s, hq, n, split),
                       v_ctx.reshape(s, n, split, hq, dh))
    big = m.amax(dim=-1)                                  # [S, Hq]
    num = torch.zeros((s, hq, dh), dtype=torch.float32, device=q.device)
    den = torch.zeros((s, hq), dtype=torch.float32, device=q.device)
    for j in range(n):                                    # split order
        w = torch.where(m[..., j] == -math.inf, 0.0,
                        torch.exp(m[..., j] - big))
        num = num + w[..., None] * acc[:, :, j]
        den = den + w * l[..., j]
    return (num / den.clamp(min=1e-30)[..., None]).to(q.dtype)


def _slot_lib() -> ctypes.CDLL:
    lib = cuda_build.library("slot_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slot_attention_bf16.argtypes = [p] * 4 + [i] * 10 + [p] * 4
        lib.slot_attention_bf16.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_attention_shape(hq: int, hkv: int, dh: int) -> None:
    if hkv < 1 or hq % hkv or not 1 <= hq // hkv <= 8:
        raise ValueError(f"Hq={hq} over Hkv={hkv}: the kernel takes a ratio "
                         f"of 1 to 8")
    if dh not in (64, 128):
        raise ValueError(f"head dim {dh} not in (64, 128)")


def paged_decode_attention_dma_slot(q: torch.Tensor, k_pools: torch.Tensor,
                                    v_pools: torch.Tensor, lens: torch.Tensor,
                                    layer: int, cap: int, maxp_slot: int,
                                    base0: int = 1,
                                    n_buf: int = 2) -> torch.Tensor:
    """Slot-major decode attention over layer ``layer`` of the stacked pools
    [L, P, page, Hkv, Dh] in the partitioned layout → [S, Hq, Dh]; slot s
    attends over its first ``min(lens[s], cap * page)`` positions, cut into
    splits of ``ATTN_SPLIT`` on the card. ``n_buf`` is the TPU kernel's DMA
    depth and changes nothing here."""
    if on_cpu(q, k_pools, v_pools, lens):
        return paged_decode_attention_slot_plain(
            q, _layer(k_pools, layer), _layer(v_pools, layer), lens, cap,
            maxp_slot, base0)
    kl, vl = _layer(k_pools, layer), _layer(v_pools, layer)
    if q.dim() != 3:
        raise ValueError("q must be [S, Hq, Dh]")
    s, hq, dh = q.shape
    n_pages, page, hkv, _ = kl.shape
    need(q, "q", torch.bfloat16, (s, hq, dh))
    need(kl, "k_pool", torch.bfloat16, (n_pages, page, hkv, dh))
    need(vl, "v_pool", torch.bfloat16, (n_pages, page, hkv, dh))
    need(lens, "lens", torch.int32, (s,))
    check_attention_shape(hq, hkv, dh)
    if cap < 1 or base0 < 0 or base0 + (s - 1) * maxp_slot + cap > n_pages:
        raise ValueError(f"{s} partitions of {maxp_slot} pages from page "
                         f"{base0}, cap {cap}, overrun a pool of {n_pages}")
    split = ATTN_SPLIT
    n_split, part_shape, n_counts = split_scratch(s, hkv, hq // hkv, dh,
                                                  cap * page, split)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = count = None
        if n_split > 1:
            part, count = _workspace(q.device, stream, math.prod(part_shape),
                                     n_counts)
        err = _slot_lib().slot_attention_bf16(
            q.data_ptr(), kl.data_ptr(), vl.data_ptr(), lens.data_ptr(), s,
            hq, hkv, dh, page, cap, maxp_slot, base0, split, n_split,
            None if part is None else part.data_ptr(),
            None if count is None else count.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"slot attention launch failed: CUDA error {err}")
    paged_decode_attention_dma_slot.launches += 1
    return out


def paged_decode_attention_dma_batched(q: torch.Tensor, k_pools: torch.Tensor,
                                       v_pools: torch.Tensor,
                                       tables: torch.Tensor,
                                       lens: torch.Tensor, layer: int,
                                       worklist=None, chunk: int = 8,
                                       n_buf: int = 4) -> torch.Tensor:
    """Alias of ``paged_decode_attention_dma`` (the TPU's cross-slot
    batched schedule of the same function) → [S, Hq, Dh]; ``worklist``,
    ``chunk`` and ``n_buf`` are TPU schedule and change nothing."""
    if on_cpu(q, k_pools, v_pools, tables, lens):
        return paged_decode_attention_xla(q, _layer(k_pools, layer),
                                          _layer(v_pools, layer), tables, lens)
    out = _launch(q, k_pools, v_pools, layer, tables, lens)
    paged_decode_attention_dma_batched.launches += 1
    return out


WRAPPERS = (paged_decode_attention_dma, paged_decode_attention_dma_scatter,
            paged_decode_attention_dma_kv_int8, paged_decode_attention,
            paged_decode_attention_pooled, paged_decode_attention_dma_slot,
            paged_decode_attention_dma_batched)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


reset_launches()
