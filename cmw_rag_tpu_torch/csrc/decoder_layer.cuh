// The decoder-layer decode megakernel's device code, shared by
// csrc/decoder_layer.cu (bf16 KV pages) and csrc/decoder_layer_kv8.cu (int8
// KV pages): each source instantiates the kernel for its pool type only, so
// the two compile in parallel. The build hashes this header,
// weight_phases.cuh, hopper.cuh and int8_decode.cuh with each
// (ops/cuda_build.py).
//
// One int8-weight decoder layer, for one new token per slot, in ONE launch
// (Hopper, sm_90a). Function, per slot s: y = bf16(x * rsqrt(mean(x^2) +
// eps) * attn_norm); qkv = (y @ wqkv) * wqkv_s in float32; per head, t *
// rsqrt(mean(t^2) + eps) * {q,k}_norm, then rotate-half RoPE n * c2 +
// roll(n, Dh / 2) * s2 (c2, s2 from make_rope_maps), q kept in float32, k
// and v written as bf16 into row off[s] of page page_idx[s] of this layer's
// pools (IN PLACE: the TPU kernel aliases them); attention over positions <
// lens[s], slot-major over the partitioned pool (slot_cap > 0: cap pages
// from slot_base + s * slot_maxp) or paged over tables [S, maxp]; then
// x1 = x + (bf16(attention) @ wo) * wo_s, y2 = bf16(x1 * rsqrt(mean(x1^2)
// + eps) * ffn_norm), h = bf16(silu(g) * u) with [g | u] = (y2 @ w_gateup)
// * gateup_s, out = bf16(x1 + (h @ w_down) * down_s).
//
// What bounds it: bytes. The layer's int8 weights are 15.7 MB at
// qwen3guard-0.6b's width (4.7 us at 3.35 TB/s), each used S times; the
// attention reads K and V of the real positions once. At decode's few rows
// the time goes to latency: the weights' first bytes, and the round trips
// of the phases that depend on each other.
//
// Design: the weight phases of csrc/weight_phases.cuh (one persistent
// cooperative launch, one block a SM of eight consumer warps and a producer
// warp that puts the block's weight stages of all four products in flight
// by TMA at entry; mma.sync bf16 products; splits merged by the last to
// arrive; the host plan is ops/weight_phases.py layer_plan), with the
// megakernel's own pieces:
// - The QKV merge writes q after its head norm and RoPE (float32) and the
//   K/V rows (phase 2 of the TPU kernel, folded in). A block that takes a
//   QKV item reads its row tile's rows of x whole for the attention norm.
// - Three grid-wide waits a layer, where every block needs every other's
//   output: attention -> wo, wo -> the FFN norm, gate/up -> down. The QKV
//   merges release a counter a (row tile, KV head group); an attention item
//   of (slot, KV head, split) waits (acquire) until all of its group's
//   rep + 2 heads are merged. Every block is resident, so the waits end.
// - Attention is attend_split() of csrc/int8_decode.cuh, one (slot, KV
//   head, split) item at a time, in the activations' and tile buffer's
//   shared memory; the last split of a (slot, KV head) to finish merges the
//   others' partials (attn_part) in split order and sets its counter
//   (attn_count) back to 0. Only the live items (those under the slot's
//   length) are handed out, numbered densely, so that an item past a
//   length takes no block's turn: with one block a SM, fewer rounds of
//   items.
// Counters live in the wrapper's per-(device, stream) workspace: zero when
// made, and every launch leaves them 0 (the block that reads a counter last
// resets it; the head-group counters are reset after the first grid-wide
// wait). The caller guarantees that active slots write distinct rows; idle
// slots write row 0 of the null page, whose output nobody samples. A launch
// whose grid cannot be co-resident fails, and the failure is returned.
//
// The ablation "noattn" (the TPU kernels' ablate argument, diagnosis only:
// wrong outputs on purpose) skips attention; wo reads q as its input.

#pragma once

#include "weight_phases.cuh"

namespace {

using namespace i8d;

constexpr float kKvHeadroom = 1.25f / 127.0f;  // KV_HEADROOM / 127

static_assert(attend_smem(128) <= 8 * kActRow * 2 + 8 * kTW * 4,
              "attention's scratch fits the activations and tile buffer");

struct alignas(64) LayerArgs {
  // the weight phases: x, the scales and norms, S, D, A, F, eps; part: the
  // partial tiles; h [S, F] bf16; x1 [S, D]; out [S, D]; wo_in: the
  // attention output (noattn: q)
  WeightArgs w;
  const float* c2;  // [S, Dh] RoPE maps
  const float* s2;
  const float* wqkv_s;
  const float* qn;  // [Dh]
  const float* kn;
  const int* page_idx;  // [S]
  const int* off;
  void* k_pool;  // this layer: [P, page, Hkv, Dh], bf16 or int8
  void* v_pool;
  float* k_scale;  // this layer: [P, Hkv] (int8 pools) or null
  float* v_scale;
  const int* lens;    // [S], this step's token included
  const int* tables;  // [S, maxp] (paged route) or null
  int hq, hkv, page, maxp, slot_cap, slot_maxp, slot_base, noattn;
  int attn_split, n_split;  // positions a split; splits a (slot, KV head)
  float* attn_part;  // [S, Hkv, n_split, Hq / Hkv, Dh + 2] split partials
  int* attn_count;   // [S, Hkv] splits written, left 0
  float* qbuf;       // [S, Hq, Dh]
  float* aout;       // [S, Hq, Dh]
  int* ready;        // [row tiles, Hkv] heads merged, reset after wait 1
};

// Spins (one thread) until *c reaches target; a wait that never ends traps
// instead of hanging the card.
__device__ void wait_count(const int* c, int target) {
  for (unsigned spins = 0; ld_acquire(c) < target; ++spins) {
    __nanosleep(64);
    if (spins == (1u << 26)) __trap();
  }
}

// Slots (of s) with more than j live splits of `split` positions, their
// lengths capped at cap (every lane of the warp gets it; each warp counts
// alike).
__device__ int slots_past(const int* lens, int s, int cap, int split, int j,
                          int lane) {
  int n = 0;
  for (int c = 0; c < s; c += 32) {
    const int si = c + lane;
    const bool live =
        si < s && live_splits(min(__ldg(lens + si), cap), split) > j;
    n += __popc(__ballot_sync(0xffffffffu, live));
  }
  return n;
}

// The k-th (from 0) of those slots, in slot order.
__device__ int nth_slot_past(const int* lens, int s, int cap, int split,
                             int j, int k, int lane) {
  for (int c = 0; c < s; c += 32) {
    const int si = c + lane;
    const bool live =
        si < s && live_splits(min(__ldg(lens + si), cap), split) > j;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    const int n = __popc(mask);
    if (k < n) return c + __fns(mask, 0, k + 1);
    k -= n;
  }
  return s;  // not reached: k is under slots_past
}

// One K or V row of DH values, EL = DH / 32 a lane, into an int8 pool row
// `dst` against the page's scale `*scale` (set from the row when fresh):
// the rounding points of the TPU kernel (bf16 first, then the amax).
template <int EL>
__device__ __forceinline__ void store_row(const float* t, bool fresh,
                                          float* scale, int8_t* dst,
                                          int lane) {
  float r[EL], amax = 0.f;
#pragma unroll
  for (int e = 0; e < EL; ++e) {
    r[e] = bf16r(t[e]);
    amax = fmaxf(amax, fabsf(r[e]));
  }
  amax = warp_max(amax);
  const float sc = fresh ? fmaxf(amax, 1e-8f) * kKvHeadroom : __ldcg(scale);
  if (fresh && lane == 0) *scale = sc;
#pragma unroll
  for (int e = 0; e < EL; ++e)
    dst[e] = static_cast<int8_t>(
        __float2int_rn(fmaxf(fminf(rintf(r[e] / sc), 127.f), -127.f)));
}

__device__ __forceinline__ void store_row_bf16(const float* t, int el,
                                               __nv_bfloat16* dst) {
  for (int e = 0; e < el; ++e) dst[e] = __float2bfloat16(t[e]);
}


template <int F, int DH, typename TP>
__global__ void __launch_bounds__(kBlock, 1)
decoder_layer_kernel(const __grid_constant__ LayerArgs p) {
  constexpr int MT = 8 * F;
  constexpr bool kInt8 = sizeof(TP) == 1;
  constexpr int EL = DH / 32;
  constexpr int kHeads = kCols / DH;  // heads a QKV column tile
  extern __shared__ unsigned char smem_raw[];
  const WeightArgs& w = p.w;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* act =
      reinterpret_cast<__nv_bfloat16*>(ring + w.ring * kStage);
  float* tb = reinterpret_cast<float*>(act + MT * kActRow);
  __shared__ uint64_t full[kMaxRing];
  __shared__ float rstd[MT];
  __shared__ int flag;
  __shared__ Product plan[4];
  TP* const k_pool = static_cast<TP*>(p.k_pool);
  TP* const v_pool = static_cast<TP*>(p.v_pool);
  cg::grid_group grid = cg::this_grid();
  const int s = w.s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = p.hq + 2 * p.hkv, rep = p.hq / p.hkv;

  if (warp == kWarps) {
    produce(w, plan, ring, full);
    return;
  }
  Walk walk;  // consumer thread 0 refills the ring past its first stages
  const bool refill = consume_start(w, plan, walk);
  Block<F> blk{w, plan, ring, act, tb, full, rstd, &flag, walk, 0, refill,
               tid, lane, warp};

  // 1-2. the QKV items; each tile's merge: head norms, RoPE, q out, k and v
  // into the pools, then the head groups' counters
  {
    const Product& q = plan[kQkv];
    int have_mt = -1;
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      const int len = (t.s1 - t.s0) * kRows;
      // 8-row tiles: the first chunk in flight across the norm (16 rows
      // have no registers for it)
      typename Block<F>::Chunk first;
      if constexpr (F == 1)
        blk.load_chunk(kQkv, t.mt * MT, t.s0 * kRows, len / 8, tid, first);
      csync();  // act and rstd are free
      if (t.mt != have_mt) {
        blk.x_rstd(t.mt * MT);
        csync();
        have_mt = t.mt;
      }
      blk.form(kQkv, t.mt * MT, t.s0 * kRows, len, first, F == 1);
      csync();
      blk.template mma_item<1>(t);
      // a warp's (row, head) of the tile: its scales, RoPE maps, norm
      // weights and pool row
      struct Head {
        float ws[EL], c2[EL], s2[EL], nw[EL];
        int pg, off;
      };
      auto head_of = [&](int wi, Head& hd) {
        const int r = wi / kHeads, h = t.ct * kHeads + wi % kHeads;
        const int si = t.mt * MT + r;
        const bool in = wi < MT * kHeads && si < s && h < nh;
        const float* nw = h < p.hq ? p.qn : p.kn;
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int dd = lane * EL + e;
          hd.ws[e] = in ? p.wqkv_s[h * DH + dd] : 0.f;
          hd.c2[e] = in ? p.c2[si * DH + dd] : 0.f;
          hd.s2[e] = in ? p.s2[si * DH + dd] : 0.f;
          hd.nw[e] = in ? nw[dd] : 0.f;
        }
        hd.pg = in ? p.page_idx[si] : 0;
        hd.off = in ? p.off[si] : 0;
      };
      if (!blk.arrive(q, t)) continue;
      Head head0;  // in flight with the splits' loads (8-row tiles)
      if constexpr (F == 1) head_of(warp, head0);
      blk.gather(q, t);
      for (int wi = warp; wi < MT * kHeads; wi += kWarps) {
        const int r = wi / kHeads, h = t.ct * kHeads + wi % kHeads;
        const int si = t.mt * MT + r;
        if (si >= s || h >= nh) continue;
        Head hd;
        if (F == 1 && wi == warp)
          hd = head0;
        else
          head_of(wi, hd);
        float tv[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int col = h * DH + lane * EL + e;
          tv[e] = tb[r * kTW + (col - t.ct * kCols)] * hd.ws[e];
        }
        const int pg = hd.pg;
        const bool fresh = hd.off == 0;
        const int64_t row =
            (static_cast<int64_t>(pg) * p.page + hd.off) * p.hkv * DH;
        if (h >= p.hq + p.hkv) {
          const int gv = h - p.hq - p.hkv;
          if constexpr (kInt8)
            store_row<EL>(tv, fresh,
                          p.v_scale + static_cast<int64_t>(pg) * p.hkv + gv,
                          v_pool + row + gv * DH + lane * EL, lane);
          else
            store_row_bf16(tv, EL, v_pool + row + gv * DH + lane * EL);
          continue;
        }
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) ss += tv[e] * tv[e];
        const float rn = rsqrtf(warp_sum(ss) / static_cast<float>(DH) + w.eps);
        float n[EL], o[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e) n[e] = tv[e] * rn * hd.nw[e];
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const float partner = __shfl_xor_sync(0xffffffffu, n[e], 16);
          o[e] = n[e] * hd.c2[e] + partner * hd.s2[e];
        }
        if (h < p.hq) {
          float* dst =
              p.qbuf + (static_cast<int64_t>(si) * p.hq + h) * DH + lane * EL;
#pragma unroll
          for (int e = 0; e < EL; ++e) dst[e] = o[e];
        } else {
          const int gk = h - p.hq;
          if constexpr (kInt8)
            store_row<EL>(o, fresh,
                          p.k_scale + static_cast<int64_t>(pg) * p.hkv + gk,
                          k_pool + row + gk * DH + lane * EL, lane);
          else
            store_row_bf16(o, EL, k_pool + row + gk * DH + lane * EL);
        }
      }
      csync();  // the tile's rows are written: release them
      if (tid == 0) {
        for (int hh = 0; hh < kHeads; ++hh) {
          const int h = t.ct * kHeads + hh;
          if (h >= nh) break;
          const int grp = h < p.hq ? h / rep
                        : h < p.hq + p.hkv ? h - p.hq : h - p.hq - p.hkv;
          red_release(p.ready + t.mt * p.hkv + grp, 1);
        }
      }
    }
  }

  // 3. attention: the live items (split j, slot, KV head) with j under
  // the slot's live splits, numbered densely, splits slowest (so that each
  // split's items spread over the grid), slots, then KV heads; block b takes
  // live items b, b + grid, ...: an item past a slot's length takes no
  // block's turn. Each waits for its head group's QKV merges.
  const int cap_pos = (p.slot_cap > 0 ? p.slot_cap : p.maxp) * p.page;
  int j = 0, base = 0;  // the walk's split and its first live number
  int in_j = p.noattn ? 0 : p.hkv * slots_past(p.lens, s, cap_pos,
                                                p.attn_split, 0, lane);
  for (int L = blockIdx.x; !p.noattn; L += gridDim.x) {
    while (j < p.n_split && L >= base + in_j) {
      base += in_j;
      ++j;
      in_j = j < p.n_split ? p.hkv * slots_past(p.lens, s, cap_pos,
                                                p.attn_split, j, lane)
                           : 0;
    }
    if (j >= p.n_split) break;
    const int si = nth_slot_past(p.lens, s, cap_pos, p.attn_split, j,
                                 (L - base) / p.hkv, lane);
    const int g = (L - base) % p.hkv, pair = si * p.hkv + g;
    const int len = min(p.lens[si], cap_pos);
    csync();  // attention's scratch (act, tb) is free
    if (tid == 0) wait_count(p.ready + (si / MT) * p.hkv + g, rep + 2);
    csync();
    const int64_t head = static_cast<int64_t>(si) * p.hq * DH;
    const Meet meet{p.attn_part + static_cast<int64_t>(pair) * p.n_split *
                                      rep * (DH + 2),
                    p.attn_count + pair};
    float* sm = reinterpret_cast<float*>(act);
    if (p.slot_cap > 0) {
      attend_split<DH>(
          p.qbuf + head, g, rep, k_pool, v_pool, p.hkv, p.page,
          SlotPages{p.slot_base + static_cast<int64_t>(si) * p.slot_maxp},
          len, p.attn_split, j, meet, p.aout + head, sm);
    } else {
      attend_split<DH>(
          p.qbuf + head, g, rep, k_pool, v_pool, p.hkv, p.page,
          TablePages{p.tables + static_cast<int64_t>(si) * p.maxp}, len,
          p.attn_split, j, meet, p.aout + head, sm, p.k_scale, p.v_scale);
    }
  }
  grid.sync();  // wait 1: wo reads every head of the attention output
  if (blockIdx.x == 0)
    for (int i = tid; i < w.mtiles * p.hkv; i += kThreads) p.ready[i] = 0;

  blk.wo_phase();  // 4. x1 = x + (attn @ wo) * wo_s
  grid.sync();     // wait 2: the FFN norm needs every column of x1
  blk.gu_phase();  // 5. h = bf16(silu(g) * u)
  grid.sync();     // wait 3: down reads every column of h
  blk.dn_phase();  // 6. out = x1 + (h @ down) * down_s
}

template <int F, int DH, typename TP>
int blocks_for() {
  constexpr int MT = 8 * F;
  // the attribute at the most the plan may ask for, once
  static const int blocks = resident_blocks(
      decoder_layer_kernel<F, DH, TP>, layer_smem(MT, max_ring(MT)));
  return blocks;
}

template <int F, int DH, typename TP>
int launch(const LayerArgs& p, int grid, cudaStream_t stream) {
  const int blocks = blocks_for<F, DH, TP>();
  if (blocks <= 0)
    return blocks < 0 ? -blocks
                      : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (grid > blocks || p.w.ring > max_ring(8 * F))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<LayerArgs*>(&p)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decoder_layer_kernel<F, DH, TP>),
      dim3(grid), dim3(kBlock), args, layer_smem(8 * F, p.w.ring), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename TP>
int by_rows(const LayerArgs& p, int grid, cudaStream_t stream) {
  return frags_of(p.w.s) == 1 ? launch<1, DH, TP>(p, grid, stream)
                              : launch<2, DH, TP>(p, grid, stream);
}

template <typename TP, int DH>
int blocks_dh(int mt) {
  return frags_of(mt) == 1 ? blocks_for<1, DH, TP>() : blocks_for<2, DH, TP>();
}

template <typename TP>
int blocks_by_tile(int mt, int dh) {
  if (mt != 4 && mt != 8 && mt != 16 && mt != 32)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return blocks_dh<TP, 64>(mt);
  if (dh == 128) return blocks_dh<TP, 128>(mt);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The C entry of either source: checks the arguments, then launches the
// kernel for pool type TP (int8 pools come with scale planes). See
// csrc/decoder_layer.cu for the arguments.
template <typename TP>
int run_layer(
    const void* x, const float* c2, const float* s2, const float* attn_norm,
    const int8_t* wqkv_q, const float* wqkv_s, const float* q_norm,
    const float* k_norm, const int8_t* wo_q, const float* wo_s,
    const float* ffn_norm, const int8_t* gateup_q, const float* gateup_s,
    const int8_t* down_q, const float* down_s, const int* page_idx,
    const int* off, void* k_pool, void* v_pool, const int* lens,
    const int* tables, float* part_a, int s, int d, int hq, int hkv, int dh,
    int f, int page, int maxp, int slot_cap, int slot_maxp, int slot_base,
    float eps, int ks_qkv, int ks_wo, int ks_gu, int ks_dn, float* part_b,
    float* qbuf, float* aout, float* x1, float* y, void* out, float* k_scale,
    float* v_scale, int noattn, int attn_split, int n_split,
    float* attn_part, int* attn_count, const void* maps, int* counts,
    int ring, int grid, void* stream) {
  constexpr bool kv8 = sizeof(TP) == 1;
  const int a = hq * dh;
  if (s < 1 || s > kMaxRows || hkv < 1 || hq % hkv != 0 ||
      hq / hkv > kMaxRep || page < 1 || d % kRows != 0 || a % kRows != 0 ||
      f % kRows != 0 || d < kRows || f < kRows ||
      (slot_cap <= 0 && (tables == nullptr || maxp < 1)) ||
      kv8 != (k_scale != nullptr) || kv8 != (v_scale != nullptr) ||
      (kv8 && slot_cap > 0) || attn_split < 1 || attn_split > kMaxSplit ||
      n_split != live_splits((slot_cap > 0 ? slot_cap : maxp) * page,
                             attn_split) ||
      attn_part == nullptr || attn_count == nullptr || maps == nullptr ||
      counts == nullptr || ring < 2 || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int a3 = (hq + 2 * hkv) * dh;
  // columns, boxes a stage, splits, contraction rows, box 1's offset
  const int spec[4][5] = {{a3, 1, ks_qkv, d, 0},
                          {d, 1, ks_wo, a, 0},
                          {f, 2, ks_gu, d, f},
                          {d, 1, ks_dn, f, 0}};
  LayerArgs p;
  memset(&p, 0, sizeof(p));
  WeightArgs& w = p.w;
  w.s = s;
  const int most_tiles = set_products(w, spec, maps, ring);
  if (most_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  w.x = static_cast<const __nv_bfloat16*>(x);
  w.anorm = attn_norm;
  w.wo_in = noattn ? qbuf : aout;
  w.wo_s = wo_s;
  w.fnw = ffn_norm;
  w.gu_s = gateup_s;
  w.dn_s = down_s;
  w.part = part_a;
  w.h = reinterpret_cast<__nv_bfloat16*>(part_b);
  w.x1 = x1;
  w.out = static_cast<__nv_bfloat16*>(out);
  w.tile_count = counts;
  w.d = d;
  w.a = a;
  w.f = f;
  w.eps = eps;
  p.c2 = c2;
  p.s2 = s2;
  p.wqkv_s = wqkv_s;
  p.qn = q_norm;
  p.kn = k_norm;
  p.page_idx = page_idx;
  p.off = off;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.lens = lens;
  p.tables = tables;
  p.hq = hq;
  p.hkv = hkv;
  p.page = page;
  p.maxp = maxp;
  p.slot_cap = slot_cap;
  p.slot_maxp = slot_maxp;
  p.slot_base = slot_base;
  p.noattn = noattn;
  p.attn_split = attn_split;
  p.n_split = n_split;
  p.attn_part = attn_part;
  p.attn_count = attn_count;
  p.qbuf = qbuf;
  p.aout = aout;
  p.ready = counts + most_tiles;
  (void)wqkv_q, (void)wo_q, (void)gateup_q, (void)down_q, (void)y;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dh == 64 ? by_rows<64, TP>(p, grid, st) : by_rows<128, TP>(p, grid, st);
}

}  // namespace
