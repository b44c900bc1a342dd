// The decoder-layer decode megakernel's device code, shared by
// csrc/decoder_layer.cu (bf16 KV pages) and csrc/decoder_layer_kv8.cu (int8
// KV pages): each source instantiates the kernel for its pool type only, so
// the two compile in parallel. The build hashes this header with each
// (ops/cuda_build.py).
//
// One int8-weight decoder layer, for one new token per slot, in ONE launch
// (Hopper, sm_90a). Function, per slot s: y = bf16(x * rsqrt(mean(x^2) +
// eps) * attn_norm); qkv = (y @ wqkv) * wqkv_s in float32; per head, t * rsqrt(mean(t^2) + eps) * {q,k}_norm, then
// rotate-half RoPE n * c2 + roll(n, Dh / 2) * s2 (c2, s2 from
// make_rope_maps), q kept in float32, k and v written as bf16 into row
// off[s] of page page_idx[s] of this layer's pools (IN PLACE: the TPU
// kernel aliases them); attention over positions < lens[s], slot-major over
// the partitioned pool (slot_cap > 0: cap pages from slot_base + s *
// slot_maxp) or paged over tables [S, maxp]; then the fused MLP of
// csrc/fused_mlp.cu on bf16(attention output). Output x in bf16.
//
// What bounds it: bytes. The layer's int8 weights are 15.7 MB at
// qwen3guard-0.6b's width (4.7 us at 3.35 TB/s), each used S times; the
// attention reads K and V of the real positions once.
//
// Design: ONE cooperative launch (cudaLaunchCooperativeKernel, every block
// resident, the grid sized by the occupancy query). A TPU grid runs its
// steps in order on one core, which the TPU kernel relies on (attention in
// grid step 0, MLP blocks after); a GPU grid runs in no order, so phases
// separated by grid barriers take its place:
//   1. the attention norm (each block computes the row norms itself) and
//      the fused QKV product, split over columns and the contraction into
//      float32 partial sums;
//   2. one warp per (slot, head): the partial sums added, head norm, RoPE,
//      q to a float32 buffer, k and v written into the pools;
//   3. attention (attend_split() in csrc/int8_decode.cuh) into a float32
//      buffer, over S x Hkv x n_split work items, one (slot, KV head,
//      split of attn_split positions) each, handed out over the whole grid
//      on both routes: items past a slot's length return at once, a slot of
//      one split writes its output itself, the last split of a (slot, KV
//      head) to finish merges the others' partials (attn_part) in split
//      order. Its counters (attn_count) are zeroed in phase 1, two barriers
//      before they are bumped, so the phase needs no barrier of its own;
//   4-8. the fused MLP phases (mlp_phases()).
// Data written in the launch (partial sums, q, this step's K/V rows, the
// attention output, x1) is read back with ld.global.cg. The caller
// guarantees that active slots write distinct rows; idle slots write row 0
// of the null page, whose output nobody samples. A launch whose grid cannot
// be co-resident fails, and the failure is returned. The shared memory is
// the weight tiles' (tile_smem): attention's splits of at most 128
// positions need less. Fewer barriers are later work.
//
// The ablation "noattn" (the TPU kernels' ablate argument, diagnosis only:
// wrong outputs on purpose) replaces phase 3 with a copy of q into the
// attention output.

#pragma once

#include "int8_decode.cuh"

namespace {

using namespace i8d;

constexpr float kKvHeadroom = 1.25f / 127.0f;  // KV_HEADROOM / 127

struct LayerArgs {
  const float* c2;  // [S, Dh] RoPE maps
  const float* s2;
  const float* anorm;  // [D]
  const int8_t* wqkv_q;  // [D, (Hq + 2 Hkv) Dh]
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
  int hq, hkv, page, maxp, slot_cap, slot_maxp, slot_base, ks_qkv, noattn;
  int attn_split, n_split;  // positions a split; splits a (slot, KV head)
  float* attn_part;  // [S, Hkv, n_split, Hq / Hkv, Dh + 2] split partials
  int* attn_count;   // [S, Hkv] splits written, zeroed in phase 1
  float* qbuf;  // [S, Hq, Dh]
  float* aout;  // [S, Hq, Dh]
  MlpArgs mlp;  // x, the MLP weights, S, D, A, F, eps, scratch, out
};

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

// Two blocks a SM up to 8 rows, one past that: without the bound ptxas may
// give the 8-row tile more than 128 registers and halve the grid.
template <int MT, int DH, typename TP>
__global__ void __launch_bounds__(kThreads, MT <= 8 ? 2 : 1)
decoder_layer_kernel(const LayerArgs p) {
  constexpr bool kInt8 = sizeof(TP) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  TP* const k_pool = static_cast<TP*>(p.k_pool);
  TP* const v_pool = static_cast<TP*>(p.v_pool);
  __shared__ float rstd[kMaxRows];
  cg::grid_group grid = cg::this_grid();
  const MlpArgs& m = p.mlp;
  const int s = m.s, d = m.d, a = m.a;
  const int a3 = (p.hq + 2 * p.hkv) * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. attention norm + fused QKV partial sums; phase 3's counters zeroed
  for (int i = blockIdx.x * kThreads + tid; i < s * p.hkv;
       i += gridDim.x * kThreads)
    p.attn_count[i] = 0;
  row_rstd(m.x, s, d, m.eps, rstd);
  __syncthreads();
  auto load_y = [&](int r, int k) {
    return bf16r(to_f(m.x[static_cast<int64_t>(r) * d + k]) * rstd[r] *
                 p.anorm[k]);
  };
  const Split qkv = make_split(s, MT, a3, d, p.ks_qkv);
  for (int it = blockIdx.x; it < qkv.items(); it += gridDim.x)
    split_item<MT>(qkv, it, p.wqkv_q, a3, s, load_y, m.part_a, smem);
  grid.sync();

  // 2. head norms, RoPE, q out, k and v into the pools
  constexpr int EL = DH / 32;
  const int nh = p.hq + 2 * p.hkv;
  for (int item = blockIdx.x * kWarps + warp; item < s * nh;
       item += gridDim.x * kWarps) {
    const int si = item / nh, h = item % nh;
    float t[EL];
#pragma unroll
    for (int e = 0; e < EL; ++e) {
      const int col = h * DH + lane * EL + e;
      t[e] = split_sum(m.part_a, p.ks_qkv, s, a3, si, col) * p.wqkv_s[col];
    }
    const int pg = p.page_idx[si];
    const bool fresh = p.off[si] == 0;
    const int64_t row = (static_cast<int64_t>(pg) * p.page + p.off[si]) *
                        p.hkv * DH;
    if (h >= p.hq + p.hkv) {
      const int g = h - p.hq - p.hkv;
      if constexpr (kInt8)
        store_row<EL>(t, fresh, p.v_scale + static_cast<int64_t>(pg) * p.hkv + g,
                      v_pool + row + g * DH + lane * EL, lane);
      else
        store_row_bf16(t, EL, v_pool + row + g * DH + lane * EL);
      continue;
    }
    const float* w = h < p.hq ? p.qn : p.kn;
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) ss += t[e] * t[e];
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(DH) + m.eps);
    float n[EL], o[EL];
#pragma unroll
    for (int e = 0; e < EL; ++e) n[e] = t[e] * r * w[lane * EL + e];
#pragma unroll
    for (int e = 0; e < EL; ++e) {
      const float partner = __shfl_xor_sync(0xffffffffu, n[e], 16);  // Dh/2 on
      const int dd = lane * EL + e;
      o[e] = n[e] * p.c2[si * DH + dd] + partner * p.s2[si * DH + dd];
    }
    if (h < p.hq) {
      float* dst = p.qbuf + (static_cast<int64_t>(si) * p.hq + h) * DH + lane * EL;
#pragma unroll
      for (int e = 0; e < EL; ++e) dst[e] = o[e];
    } else {
      const int g = h - p.hq;
      if constexpr (kInt8)
        store_row<EL>(o, fresh, p.k_scale + static_cast<int64_t>(pg) * p.hkv + g,
                      k_pool + row + g * DH + lane * EL, lane);
      else
        store_row_bf16(o, EL, k_pool + row + g * DH + lane * EL);
    }
  }
  grid.sync();

  // 3. attention, one item per (slot, KV head, split), splits slowest so
  // that the live items come first; "noattn": a copy of q
  const int rep = p.hq / p.hkv;
  if (p.noattn) {
    const int64_t total = static_cast<int64_t>(s) * a;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
         i < total; i += static_cast<int64_t>(gridDim.x) * kThreads)
      p.aout[i] = __ldcg(p.qbuf + i);
  }
  const int pairs = s * p.hkv;
  for (int it = blockIdx.x; !p.noattn && it < pairs * p.n_split;
       it += gridDim.x) {
    const int j = it / pairs, pair = it % pairs;
    const int si = pair / p.hkv, g = pair % p.hkv;
    const int64_t head = static_cast<int64_t>(si) * p.hq * DH;
    const Meet meet{p.attn_part + static_cast<int64_t>(pair) * p.n_split *
                                      rep * (DH + 2),
                    p.attn_count + pair};
    float* sm = reinterpret_cast<float*>(smem);
    if (p.slot_cap > 0) {
      attend_split<DH>(
          p.qbuf + head, g, rep, k_pool, v_pool, p.hkv, p.page,
          SlotPages{p.slot_base + static_cast<int64_t>(si) * p.slot_maxp},
          min(p.lens[si], p.slot_cap * p.page), p.attn_split, j, meet,
          p.aout + head, sm);
    } else {
      attend_split<DH>(
          p.qbuf + head, g, rep, k_pool, v_pool, p.hkv, p.page,
          TablePages{p.tables + static_cast<int64_t>(si) * p.maxp},
          min(p.lens[si], p.maxp * p.page), p.attn_split, j, meet,
          p.aout + head, sm, p.k_scale, p.v_scale);
    }
  }
  grid.sync();

  // 4-8. wo, residual, norm, gate/up, SiLU * up, down, residual
  auto load_attn = [&](int r, int k) {
    return bf16r(__ldcg(p.aout + static_cast<int64_t>(r) * a + k));
  };
  mlp_phases<MT>(m, load_attn, smem, grid);
}

// The kernel's shared memory is its weight tiles' (tile_smem).
static_assert(attend_smem(64) <= tile_smem(4) &&
                  attend_smem(128) <= tile_smem(4),
              "the megakernel's shared memory is set by its weight tiles");

template <int MT, int DH, typename TP>
int launch(const LayerArgs& p, cudaStream_t stream) {
  const int smem = tile_smem(MT);
  auto kern = decoder_layer_kernel<MT, DH, TP>;
  static const int blocks = cooperative_blocks(kern, smem);  // once
  if (blocks <= 0)
    return blocks < 0 ? -blocks
                      : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<LayerArgs*>(&p)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(blocks), dim3(kThreads), args,
      smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename TP>
int by_rows(const LayerArgs& p, cudaStream_t stream) {
  const int s = p.mlp.s;
  if (s <= 4) return launch<4, DH, TP>(p, stream);
  if (s <= 8) return launch<8, DH, TP>(p, stream);
  if (s <= 16) return launch<16, DH, TP>(p, stream);
  return launch<32, DH, TP>(p, stream);
}

template <int MT, typename TP>
int blocks_for(int dh) {
  if (dh == 64)
    return cooperative_blocks(decoder_layer_kernel<MT, 64, TP>,
                              tile_smem(MT));
  if (dh == 128)
    return cooperative_blocks(decoder_layer_kernel<MT, 128, TP>,
                              tile_smem(MT));
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <typename TP>
int blocks_by_tile(int mt, int dh) {
  switch (mt) {
    case 4: return blocks_for<4, TP>(dh);
    case 8: return blocks_for<8, TP>(dh);
    case 16: return blocks_for<16, TP>(dh);
    case 32: return blocks_for<32, TP>(dh);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
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
    float* attn_part, int* attn_count, void* stream) {
  constexpr bool kv8 = sizeof(TP) == 1;
  const int a = hq * dh;
  if (s < 1 || s > kMaxRows || hkv < 1 || hq % hkv != 0 ||
      hq / hkv > kMaxRep || page < 1 || d % (kBK * ks_qkv) != 0 ||
      a % (kBK * ks_wo) != 0 || d % (kBK * ks_gu) != 0 ||
      f % (kBK * ks_dn) != 0 || ks_qkv < 1 || ks_wo < 1 || ks_gu < 1 ||
      ks_dn < 1 || (slot_cap <= 0 && (tables == nullptr || maxp < 1)) ||
      kv8 != (k_scale != nullptr) || kv8 != (v_scale != nullptr) ||
      (kv8 && slot_cap > 0) || attn_split < 1 || attn_split > kMaxSplit ||
      n_split != live_splits((slot_cap > 0 ? slot_cap : maxp) * page,
                             attn_split) ||
      attn_part == nullptr || attn_count == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const LayerArgs p{
      c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, page_idx, off,
      k_pool, v_pool, k_scale, v_scale, lens, tables, hq, hkv, page, maxp,
      slot_cap, slot_maxp, slot_base, ks_qkv, noattn, attn_split, n_split,
      attn_part, attn_count, qbuf, aout,
      MlpArgs{static_cast<const __nv_bfloat16*>(x), wo_q, wo_s, ffn_norm,
              gateup_q, gateup_s, down_q, down_s, s, d, a, f, eps, ks_wo,
              ks_gu, ks_dn, part_a, part_b, x1, y,
              static_cast<__nv_bfloat16*>(out)}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return by_rows<64, TP>(p, st);
    case 128: return by_rows<128, TP>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
