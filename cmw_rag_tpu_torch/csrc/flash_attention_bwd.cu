// Flash attention backward for Hopper (sm_90a): dQ, and dK with dV, on TMA
// rings, wgmma and warp specialisation.
//
// Replaces the two TPU kernels of cmw_rag_tpu/ops/flash_attention.py:365
// _fa_bwd_rule, the backward of the custom VJP flash_attention_trainable:
// the dQ pallas_call at :388 (body _flash_bwd_dq_kernel :202) and the dK/dV
// pallas_call at :418 (body _flash_bwd_dkv_kernel :251).
//
// Function, per batch*head, over bf16 q, k, v, dO [BH, L, D], the key mask
// [B, L] (b = bh / H), the forward's lse and delta = sum(dO * O) [BH, L]
// (float32, computed outside the kernels as JAX computes it):
//   s = (q . k) * (1/sqrt(D)) in fp32; s = -1e30 where key_mask[b, key] <= 0
//   and, when causal, where key > query (never -inf: a fully masked row then
//   gets p = 1, as in JAX, and not NaN);
//   p = exp(s - lse); dp = dO . v in fp32; ds = p * (dp - delta) * scale;
//   dQ = sum over keys of bf16(ds) * k;
//   dK = sum over queries of bf16(ds) * q;
//   dV = sum over queries of p * dO, p kept to ~16 bits as bf16 hi + lo;
// fp32 sums, bf16 outputs. Causal (query tile, key tile) pairs wholly above
// the diagonal are skipped, as both TPU kernels skip them; the twin that
// skips as a kernel does runs over that kernel's tiles
// (flash_attention_bwd_tiles): (128, 128) for dQ, (64, 64) for dK/dV.
//
// What bounds it: the tensor cores. At the trainer's shape (B 8, H 16,
// L 1024, D 128, causal, lengths U[512, 1024]) the work over the visible
// real (query, key) pairs is 3 products of 2 D operations a pair for dQ
// (S, dP, dS K: bound 0.0466 ms at 989 TFLOP/s) and 4 for dK/dV (S, dP,
// dS^T Q, P^T dO: 0.0621 ms), ~550 operations per byte moved, above the
// H100's ~295. The kernels run 3 and 6 products (below), 0.129 and 0.243
// ms on an NVIDIA H100 80GB HBM3 at 700 W (36% and 26% of the bounds;
// chip_smoke.py phase 11 has the numbers of a run).
//
// Why two kernels and not one: each output tile is then summed by one block
// in a fixed order, with no atomics and no float32 dQ scratch, so dQ is
// deterministic, as JAX's is. FA3's single kernel adds every block's dQ
// into a float32 buffer with atomics: fewer products, but a summation
// order that changes from run to run.
//
// Design (helpers in hopper.cuh, the skeleton of flash_attention.cu):
//   * Both kernels: two consumer warpgroups and one producer warpgroup, of
//     which one thread issues every copy; setmaxnreg gives the consumers 232
//     registers and the producer 40. The stationary operands land once by
//     TMA (3-D maps [BH, L, D], 128-byte swizzle, 64-byte for D = 32), the
//     streamed ones through a ring of full/empty mbarriers in dynamic shared
//     memory; no __syncthreads() in the streamed loop. Every product is a
//     wgmma; none sits on a path only some warps of a warpgroup take (ptxas
//     then serializes them all, C7518).
//   * dQ (flash_bwd_dq_kernel): one block per (128-row query tile,
//     batch*head), 64 rows a warpgroup; Q and dO stationary, K and V through
//     a ring of 128-key stages (2 at D = 128, 4 below), each taken as two
//     64-key blocks. Per block S = Q K^T and dP = dO V^T are wgmma m64n64k16
//     with both operands in shared memory (K-major); p and ds are computed
//     on the accumulator layout with the rows' lse and delta in registers;
//     bf16(ds) packs in place into the register A operand of dQ += dS K,
//     wgmma m64nDk16 with K's descriptor MN-major (as the forward's P V
//     reads V). The two warpgroups take turns to issue (named barriers,
//     ping-pong). Query tiles run heaviest first (causal). Registers at
//     D = 128: dQ 64, S 32, dP 32, dS 16; ptxas (CUDA 12.9) allocates near
//     168 there and spills 84 bytes (a few values around the products),
//     none at D = 64 and 32.
//   * dK/dV (flash_bwd_dkv_kernel): roles swapped. One block per pair of
//     64-key tiles (tile t and L/64 - 1 - t, so that every causal block
//     runs L/64 + 1 query stages) of a batch*head; K and V of both tiles
//     stationary (the second lands while the first is worked on), Q, dO and
//     their rows' lse and delta (cp.async.bulk, on the same barrier) through
//     a ring of 4 stages of 64 queries; the first tile's copies are issued
//     before the mask is read. The two warpgroups share the tile's keys and
//     split its outputs: one sums dV, one dK. Both compute S^T = K Q^T
//     (wgmma m64n64k16, both operands K-major), so that P^T lands in the A
//     layout of dV += P^T dO (p as bf16 hi and lo, two products); the dK
//     one also computes dP^T = V dO^T, and dS^T feeds dK += dS^T Q; dO's
//     and Q's descriptors are MN-major there. Each warpgroup issues three
//     products a stage, independently of the other (turns measured 5%
//     slower here). Registers at D = 128: one [64, D] accumulator (64),
//     S^T 32 (+ dP^T 32) and 16 to 32 of A operands; ptxas: 44 bytes of
//     spill stores at D = 128, none at 64 and 32. Why not one warpgroup
//     per 64 keys holding both dK and dV (five products, not six): with 128
//     accumulator registers plus S^T and dP^T, ptxas allocated under ~R192
//     although setmaxnreg gave 240, spilled S^T and dP^T around every
//     product and serialized the wgmmas (C7512): 0.77 ms at the trainer's
//     shape, against 0.24 for this design.
//   * The key mask: before the roles split, the dQ block turns the mask row
//     up to the causal limit into bits in shared memory with the first
//     non-real and the last real key (the forward's prologue), the dK/dV
//     block finds the last real key and whether its tiles hold a non-real
//     one. Tiles wholly real skip the mask, and the causal mask is applied
//     on the diagonal tile only. On such tiles p = 2^(s c - lse log2 e),
//     c = scale log2 e: one FFMA and one ex2 a score (25% faster than expf
//     on the card, within the same tolerance of the twin); other tiles mask
//     to -1e30 and take 2^((s - lse) log2 e), which is exactly 0 for a row
//     that has a real key and exactly 1 for a row that has none.
//   * Exact ragged-key skipping. When the batch row has a real key, every
//     key past its last real key j_last contributes nothing to either
//     kernel, and its tiles are not processed. A query row that has seen a
//     real key has a finite lse, so p = exp(-1e30 - lse) = 0 and ds = 0 on
//     every masked key. A row that has seen none takes p = 1 over the keys
//     of the tiles processed for it (as in JAX): without causality such a
//     row exists only when the batch row has no real key at all; with
//     causality it is a row q < j_first <= j_last, and the tiles processed
//     for it end at its own diagonal tile, which is at or before j_last's
//     (dQ: 128-row tiles, 128-key stages; dK/dV: 64 keys, 64 queries). So
//     dQ's key loop ends at the stage holding j_last, and a dK/dV tile whose
//     64 keys all lie past j_last loads nothing and writes zeros. A batch
//     row with no real key processes every tile. The skip depends on each
//     kernel's tiles, which is why the twin runs at each kernel's own.
// Takes D in {32, 64, 128} and L a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;          // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kWarps = kThreads / 32;
constexpr int kProducerThread = kConsumers * 128;
constexpr int kTurn = 1;               // named barriers kTurn, kTurn + 1
constexpr float kMaskVal = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kQRows = 128;    // dQ: query rows a block
constexpr int kKStage = 128;   // dQ: keys a ring stage
constexpr int kQStage = 64;    // dK/dV: query rows a ring stage
constexpr int kBlk = 64;       // dQ: rows a warpgroup, keys a block; dK/dV:
                               // keys a block

template <int D>
struct Cfg {
  static constexpr int kSpan = D * 2 >= 128 ? 128 : D * 2;  // swizzle bytes
  static constexpr int kChunkCols = kSpan / 2;               // bf16 per chunk
  static constexpr int kChunks = D / kChunkCols;
  static constexpr int kAcc = D / 2;          // an m64nD accumulator's floats
  static constexpr int kDqStages = D == 128 ? 2 : 4;
  static constexpr int kDkvStages = 4;
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, as __expf uses it
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(s scale - lse) on a tile of real, visible keys: one FFMA and one
// ex2 (c = scale log2 e, nl = -lse log2 e)
__device__ __forceinline__ float p_fast(float s, float c, float nl) {
  return ex2(fmaf(s, c, nl));
}
// p = exp(x - lse) where x may be -1e30: exactly 0 when lse is finite,
// exactly 1 when lse is -1e30 too
__device__ __forceinline__ float p_masked(float x, float lse) {
  return ex2((x - lse) * kLog2e);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats from shared memory at byte address `addr` (8-byte aligned).
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A [Rows, D] tile at row `row` of batch*head `bh`, one box a column chunk
// (the caller has set the barrier's expected bytes).
template <int D, int Rows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int bh) {
  using C = Cfg<D>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
    tma_load_3d(dst + c * Rows * C::kChunkCols, map, bar, c * C::kChunkCols,
                row, bh);
}

// A warpgroup's m64nD accumulator as bf16 rows r0 + row and r0 + row + 8
// (row = 16 (warp % 4) + lane / 4) of `out`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           int64_t r0, int row, int quad,
                                           const float (&acc)[D / 2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* orow = out + (r0 + row + 8 * h) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// ------------------------------------------------------------------- dQ

template <int S>
struct __align__(16) DqBars {
  Ring<S> kv;          // full: K and V of the stage landed
  uint64_t q_full;     // Q and dO landed
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const int* __restrict__ mask,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int heads, int L,
                    int causal, float scale, __nv_bfloat16* __restrict__ dq) {
  using C = Cfg<D>;
  constexpr int S = C::kDqStages;
  constexpr int kTileBytes = kQRows * D * 2;   // Q, dO, or K or V of a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* do_sh = q_sh + kQRows * D;
  __nv_bfloat16* k_sh = do_sh + kQRows * D;
  __nv_bfloat16* v_sh = k_sh + S * kKStage * D;
  DqBars<S>* bars = reinterpret_cast<DqBars<S>*>(v_sh + S * kKStage * D);
  uint32_t* bits = reinterpret_cast<uint32_t*>(bars + 1);   // L / 32 words
  __shared__ int warp_first_zero[kWarps], warp_last_real[kWarps];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tile first
  const int bh = blockIdx.y, b = bh / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int limit = causal ? (qt + 1) * kQRows : L;   // keys this tile sees

  if (tid == kProducerThread) {
    mbar_init(&bars->q_full, 1);
    bars->kv.init(kConsumers * 4);   // empty: every consumer warp arrives
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    // Q, dO and key stage 0 are always needed: they land while the mask is
    // read
    mbar_arrive_expect_tx(&bars->q_full, 2 * kTileBytes);
    load_tile<D, kQRows>(q_sh, &q_map, &bars->q_full, qt * kQRows, bh);
    load_tile<D, kQRows>(do_sh, &do_map, &bars->q_full, qt * kQRows, bh);
    mbar_arrive_expect_tx(&bars->kv.full[0], 2 * kTileBytes);
    load_tile<D, kKStage>(k_sh, &k_map, &bars->kv.full[0], 0, bh);
    load_tile<D, kKStage>(v_sh, &v_map, &bars->kv.full[0], 0, bh);
  }

  // the mask row up to `limit` as bits (word w holds keys 32w .. 32w + 31),
  // with the first non-real and the last real key
  {
    const int* mrow = mask + static_cast<int64_t>(b) * L;
    int first_zero = limit, last_real = -1;
#pragma unroll 2
    for (int c = warp; c < limit / 128; c += kWarps) {
      int m[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) m[w] = mrow[c * 128 + 32 * w + lane];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t real = __ballot_sync(0xffffffffu, m[w] > 0);
        const int k0 = c * 128 + 32 * w;
        if (lane == 0) bits[c * 4 + w] = real;
        if (real != 0u) last_real = max(last_real, k0 + 31 - __clz(real));
        if (real != 0xffffffffu)
          first_zero = min(first_zero, k0 + __ffs(~real) - 1);
      }
    }
    if (lane == 0) {
      warp_first_zero[warp] = first_zero;
      warp_last_real[warp] = last_real;
    }
  }
  __syncthreads();
  int first_zero = limit, last_real = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first_zero = min(first_zero, warp_first_zero[w]);
    last_real = max(last_real, warp_last_real[w]);
  }
  int n_kt = limit / kKStage;
  if (last_real >= 0) n_kt = min(n_kt, last_real / kKStage + 1);  // exact
  const int masked_from = first_zero / kKStage;   // stages before: all real

  if (warp >= kConsumers * 4) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kProducerThread) {
      for (int kt = 1; kt < n_kt; ++kt) {
        const int s = Ring<S>::stage(kt);
        if (kt >= S) bars->kv.wait_empty(kt);
        mbar_arrive_expect_tx(&bars->kv.full[s], 2 * kTileBytes);
        load_tile<D, kKStage>(k_sh + s * kKStage * D, &k_map,
                              &bars->kv.full[s], kt * kKStage, bh);
        load_tile<D, kKStage>(v_sh + s * kKStage * D, &v_map,
                              &bars->kv.full[s], kt * kKStage, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid >> 7;
    const int wrow = (warp & 3) * 16 + (lane >> 2);   // row in the warpgroup
    const int row = wg * kBlk + wrow;                 // and row + 8
    const int quad = lane & 3;

    // Q and dO rows of this warpgroup (A, K-major); K and V of stage 0 (B,
    // K-major for S and dP; K MN-major for dS K)
    const uint64_t q_desc = smem_desc(q_sh + wg * kBlk * C::kChunkCols, 16,
                                      8 * C::kSpan, C::kSpan);
    const uint64_t do_desc = smem_desc(do_sh + wg * kBlk * C::kChunkCols, 16,
                                       8 * C::kSpan, C::kSpan);
    const uint64_t k_desc0 = smem_desc(k_sh, 16, 8 * C::kSpan, C::kSpan);
    const uint64_t v_desc0 = smem_desc(v_sh, 16, 8 * C::kSpan, C::kSpan);
    const uint64_t kt_desc0 = smem_desc(k_sh, kKStage * C::kSpan,
                                        8 * C::kSpan, C::kSpan);

    float acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
    const int64_t r0 = static_cast<int64_t>(bh) * L + qt * kQRows;
    float lse_r[2], dl_r[2], nl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_r[h] = lse[r0 + row + 8 * h];
      dl_r[h] = delta[r0 + row + 8 * h];
      nl[h] = -lse_r[h] * kLog2e;
    }
    const float c = scale * kLog2e;

    if (wg == 1) named_bar_arrive(kTurn, 256);   // warpgroup 0 issues first
    mbar_wait(&bars->q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = Ring<S>::stage(kt);
      const uint32_t stage_off = s * kTileBytes;
      const bool key_mask = kt >= masked_from;
      const bool diag = causal && kt == qt;
      uint32_t words[4] = {~0u, ~0u, ~0u, ~0u};
      bars->kv.wait_full(kt);
      if (key_mask) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(bits + kt * 4);
        words[0] = w4.x; words[1] = w4.y; words[2] = w4.z; words[3] = w4.w;
      }
#pragma unroll
      for (int blk = 0; blk < kKStage / kBlk; ++blk) {
        // S = Q K^T and dP = dO V^T over the block's 64 keys, D in k16 steps
        float sc[kBlk / 2], dp[kBlk / 2];
        named_bar_sync(kTurn + wg, 256);      // this warpgroup's turn
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int chunk = ks * 16 / C::kChunkCols;
          const uint32_t within = (ks * 16 % C::kChunkCols) * 2;
          const uint32_t b_off = stage_off + chunk * kKStage * C::kSpan +
                                 blk * kBlk * C::kSpan + within;
          wgmma_ss(sc, desc_advance(q_desc, chunk * kQRows * C::kSpan + within),
                   desc_advance(k_desc0, b_off), ks > 0 ? 1 : 0);
        }
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int chunk = ks * 16 / C::kChunkCols;
          const uint32_t within = (ks * 16 % C::kChunkCols) * 2;
          const uint32_t b_off = stage_off + chunk * kKStage * C::kSpan +
                                 blk * kBlk * C::kSpan + within;
          wgmma_ss(dp,
                   desc_advance(do_desc, chunk * kQRows * C::kSpan + within),
                   desc_advance(v_desc0, b_off), ks > 0 ? 1 : 0);
        }
        wgmma_commit();
        named_bar_arrive(kTurn + 1 - wg, 256);  // the other's turn
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // p, ds = p (dp - delta) scale, packed as bf16 into the A operand
        // of dS K. Register i: row `row` + 8 ((i / 2) % 2), key
        // 64 blk + 8 (i / 4) + 2 quad + i % 2 of the stage
        uint32_t da[kBlk / 16][4];
        if (!key_mask && !diag) {
#pragma unroll
          for (int i = 0; i < kBlk / 2; i += 2) {
            const int h = (i >> 1) & 1;
            const float p0 = p_fast(sc[i], c, nl[h]);
            const float p1 = p_fast(sc[i + 1], c, nl[h]);
            da[i >> 3][(i >> 1) & 3] =
                pack_bf16x2(p0 * (dp[i] - dl_r[h]) * scale,
                            p1 * (dp[i + 1] - dl_r[h]) * scale);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kBlk / 2; i += 2) {
            const int h = (i >> 1) & 1;
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = blk * kBlk + 8 * (i >> 2) + 2 * quad + e;
              const uint32_t wv = words[blk * 2 + (i >> 4)];
              float x = sc[i + e] * scale;
              if (!((wv >> (col & 31)) & 1u)) x = kMaskVal;
              if (diag && col > row + 8 * h) x = kMaskVal;
              ds[e] = p_masked(x, lse_r[h]) * (dp[i + e] - dl_r[h]) * scale;
            }
            da[i >> 3][(i >> 1) & 3] = pack_bf16x2(ds[0], ds[1]);
          }
        }

        // dQ += dS K over the block's keys in k16 steps
        named_bar_sync(kTurn + wg, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlk / 16; ++kk)
          wgmma_rs_tb(acc, da[kk],
                      desc_advance(kt_desc0, stage_off +
                                                 (blk * kBlk + kk * 16) *
                                                     C::kSpan));
        wgmma_commit();
        named_bar_arrive(kTurn + 1 - wg, 256);
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) bars->kv.release(kt);
    }
    if (wg == 0) named_bar_sync(kTurn, 256);   // warpgroup 1's last turn
    store_rows<D>(dq, r0 + wg * kBlk, wrow, quad, acc);
  }
}

// ---------------------------------------------------------------- dK/dV

template <int S>
struct __align__(16) DkvBars {
  Ring<S> q;           // full: Q, dO, lse and delta of the stage landed
  uint64_t kv_full[2]; // K and V of the block's first, second tile landed
};

// One consumer warpgroup of the dK/dV block over one key tile's n_use query
// stages (ring uses i0 .. i0 + n_use - 1): dK (kIsK) or dV of its 64 keys.
// Both recompute S^T = K Q^T for p; the dK warpgroup also computes dP^T =
// V dO^T for ds and sums dS^T Q, the dV one sums P^T dO (p as bf16 hi +
// lo). The two issue their products independently (turns, as dQ takes
// them, measured 5% slower here).
template <int D, bool kIsK, int S>
__device__ __forceinline__ void dkv_consume(
    DkvBars<S>* bars, uint64_t* kv_full, const __nv_bfloat16* k_sh,
    const __nv_bfloat16* v_sh, const __nv_bfloat16* q_sh,
    const __nv_bfloat16* do_sh, const float* lse_sh, const float* dl_sh,
    int i0, int n_use, int j0, int kb,
    bool causal, bool all_real, const bool (&keep)[2], int wrow, int quad,
    int lane, float scale, float (&acc)[D / 2]) {
  using C = Cfg<D>;
  constexpr int kStageBytes = kQStage * D * 2;
  // K and V (A, K-major); Q and dO of stage 0 (B: K-major for S^T and dP^T,
  // MN-major for dS^T Q and P^T dO)
  const uint64_t k_desc = smem_desc(k_sh, 16, 8 * C::kSpan, C::kSpan);
  const uint64_t v_desc = smem_desc(v_sh, 16, 8 * C::kSpan, C::kSpan);
  const uint64_t q_desc0 = smem_desc(q_sh, 16, 8 * C::kSpan, C::kSpan);
  const uint64_t do_desc0 = smem_desc(do_sh, 16, 8 * C::kSpan, C::kSpan);
  const uint64_t mn_desc0 = smem_desc(kIsK ? q_sh : do_sh, kQStage * C::kSpan,
                                      8 * C::kSpan, C::kSpan);
  const float c = scale * kLog2e;

  mbar_wait(kv_full, 0);
  for (int i = i0; i < i0 + n_use; ++i) {
    const int s = Ring<S>::stage(i), j = j0 + i - i0;
    const bool diag = causal && j == kb;
    const bool fast = all_real && !diag;
    const uint32_t stage_off = s * kStageBytes;
    bars->q.wait_full(i);

    // S^T = K Q^T (and dP^T = V dO^T) over the stage's 64 queries
    float st[kQStage / 2], dpt[kQStage / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int chunk = ks * 16 / C::kChunkCols;
      const uint32_t within = (ks * 16 % C::kChunkCols) * 2;
      wgmma_ss(st, desc_advance(k_desc, chunk * kBlk * C::kSpan + within),
               desc_advance(q_desc0, stage_off + chunk * kQStage * C::kSpan +
                                         within),
               ks > 0 ? 1 : 0);
    }
    if constexpr (kIsK) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int chunk = ks * 16 / C::kChunkCols;
        const uint32_t within = (ks * 16 % C::kChunkCols) * 2;
        wgmma_ss(dpt, desc_advance(v_desc, chunk * kBlk * C::kSpan + within),
                 desc_advance(do_desc0, stage_off +
                                            chunk * kQStage * C::kSpan +
                                            within),
                 ks > 0 ? 1 : 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if constexpr (kIsK) fence_regs(dpt);

    // p in place of S^T, then dV's bf16 hi and lo of p or dK's bf16(ds),
    // packed into the A operands of the stage's products. Register i: key
    // `wrow` + 8 ((i / 2) % 2) of the tile, query 8 (i / 4) + 2 quad + i % 2
    // of the stage
    const uint32_t lse_a = smem_u32(lse_sh + s * kQStage) + 8 * quad;
    if (fast) {
#pragma unroll
      for (int i2 = 0; i2 < kQStage / 2; i2 += 4) {
        const float2 l = lds_f2(lse_a + 32 * (i2 >> 2));
        const float n0 = -l.x * kLog2e, n1 = -l.y * kLog2e;
#pragma unroll
        for (int r = 0; r < 4; r += 2) {
          st[i2 + r] = p_fast(st[i2 + r], c, n0);
          st[i2 + r + 1] = p_fast(st[i2 + r + 1], c, n1);
        }
      }
    } else {
#pragma unroll
      for (int i2 = 0; i2 < kQStage / 2; i2 += 4) {
        const float2 l = lds_f2(lse_a + 32 * (i2 >> 2));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r >> 1, col = 8 * (i2 >> 2) + 2 * quad + (r & 1);
          float x = st[i2 + r] * scale;
          if (!keep[h]) x = kMaskVal;
          if (diag && wrow + 8 * h > col) x = kMaskVal;
          st[i2 + r] = p_masked(x, (r & 1) ? l.y : l.x);
        }
      }
    }
    uint32_t a0[kQStage / 16][4], a1[kQStage / 16][4];
    const uint32_t dl_a = smem_u32(dl_sh + s * kQStage) + 8 * quad;
#pragma unroll
    for (int i2 = 0; i2 < kQStage / 2; i2 += 2) {
      if constexpr (kIsK) {
        const float2 dl = lds_f2(dl_a + 32 * (i2 >> 2));
        a0[i2 >> 3][(i2 >> 1) & 3] =
            pack_bf16x2(st[i2] * (dpt[i2] - dl.x) * scale,
                        st[i2 + 1] * (dpt[i2 + 1] - dl.y) * scale);
      } else {
        const float hi0 = bf16_round(st[i2]), hi1 = bf16_round(st[i2 + 1]);
        a0[i2 >> 3][(i2 >> 1) & 3] = pack_bf16x2(hi0, hi1);
        a1[i2 >> 3][(i2 >> 1) & 3] =
            pack_bf16x2(st[i2] - hi0, st[i2 + 1] - hi1);
      }
    }

    // dK += dS^T Q, or dV += P^T dO (hi, then lo), over the 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQStage / 16; ++kk) {
      const uint64_t b = desc_advance(mn_desc0, stage_off + kk * 16 * C::kSpan);
      wgmma_rs_tb(acc, a0[kk], b);
      if constexpr (!kIsK) wgmma_rs_tb(acc, a1[kk], b);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) bars->q.release(i);
  }
}

// K and V of the 64-key tile at `k0` into k_sh, v_sh, on `bar`.
template <int D>
__device__ __forceinline__ void load_kv(__nv_bfloat16* k_sh,
                                        __nv_bfloat16* v_sh,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        uint64_t* bar, int k0, int bh) {
  mbar_arrive_expect_tx(bar, 2 * kBlk * D * 2);
  load_tile<D, kBlk>(k_sh, k_map, bar, k0, bh);
  load_tile<D, kBlk>(v_sh, v_map, bar, k0, bh);
}

// Ring use i of the dK/dV block: Q, dO, lse and delta of query tile j.
template <int D, int S>
__device__ __forceinline__ void load_stage(
    DkvBars<S>* bars, __nv_bfloat16* q_sh, __nv_bfloat16* do_sh,
    float* lse_sh, float* dl_sh, const CUtensorMap* q_map,
    const CUtensorMap* do_map, const float* lse, const float* delta, int i,
    int j, int bh, int L) {
  const int s = Ring<S>::stage(i);
  uint64_t* full = &bars->q.full[s];
  mbar_arrive_expect_tx(full, 2 * kQStage * D * 2 + 2 * kQStage * 4);
  load_tile<D, kQStage>(q_sh + s * kQStage * D, q_map, full, j * kQStage, bh);
  load_tile<D, kQStage>(do_sh + s * kQStage * D, do_map, full, j * kQStage,
                        bh);
  const int64_t r = static_cast<int64_t>(bh) * L + j * kQStage;
  bulk_load(lse_sh + s * kQStage, lse + r, kQStage * 4, full);
  bulk_load(dl_sh + s * kQStage, delta + r, kQStage * 4, full);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const int* __restrict__ mask,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int heads, int L,
                     int causal, float scale, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv) {
  using C = Cfg<D>;
  constexpr int S = C::kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* k_sh = reinterpret_cast<__nv_bfloat16*>(base);  // 2 tiles
  __nv_bfloat16* v_sh = k_sh + 2 * kBlk * D;
  __nv_bfloat16* q_sh = v_sh + 2 * kBlk * D;
  __nv_bfloat16* do_sh = q_sh + S * kQStage * D;
  float* lse_sh = reinterpret_cast<float*>(do_sh + S * kQStage * D);
  float* dl_sh = lse_sh + S * kQStage;
  DkvBars<S>* bars = reinterpret_cast<DkvBars<S>*>(dl_sh + S * kQStage);
  __shared__ int warp_last_real[kWarps], warp_nonreal[kWarps];

  // the block's two key tiles: a heavy and a light one (causal), so that
  // every block runs L / 64 + 1 query stages
  const int tile0 = blockIdx.x, tile1 = L / kBlk - 1 - tile0;
  const int bh = blockIdx.y, b = bh / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the first tile's K, V and query stages are needed unless every key of
  // the block lies past the last real key: they land while the mask is read
  // (and are waited for, unused, if it does)
  const int pre = min(S, L / kQStage - (causal ? tile0 : 0));
  if (tid == kProducerThread) {
    mbar_init(&bars->kv_full[0], 1);
    mbar_init(&bars->kv_full[1], 1);
    bars->q.init(kConsumers * 4);   // empty: every consumer warp arrives
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    load_kv<D>(k_sh, v_sh, &k_map, &v_map, &bars->kv_full[0], tile0 * kBlk,
               bh);
    for (int u = 0; u < pre; ++u)
      load_stage<D, S>(bars, q_sh, do_sh, lse_sh, dl_sh, &q_map, &do_map,
                       lse, delta, u, (causal ? tile0 : 0) + u, bh, L);
  }

  // the batch row's last real key, and which of the two tiles hold a
  // non-real key (bits 0, 1)
  {
    const int4* m4 = reinterpret_cast<const int4*>(
        mask + static_cast<int64_t>(b) * L);
    int last = -1, nonreal = 0;
    for (int c = tid; c < L / 4; c += kThreads) {
      const int4 m = m4[c];
      const int k = 4 * c;
      if (m.x > 0) last = k;
      if (m.y > 0) last = k + 1;
      if (m.z > 0) last = k + 2;
      if (m.w > 0) last = k + 3;
      if (m.x <= 0 || m.y <= 0 || m.z <= 0 || m.w <= 0)
        nonreal |= (k / kBlk == tile0 ? 1 : 0) | (k / kBlk == tile1 ? 2 : 0);
    }
    last = __reduce_max_sync(0xffffffffu, last);
    nonreal = __reduce_or_sync(0xffffffffu, nonreal);
    if (lane == 0) {
      warp_last_real[warp] = last;
      warp_nonreal[warp] = nonreal;
    }
  }
  __syncthreads();
  int last_real = -1, nonreal = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    last_real = max(last_real, warp_last_real[w]);
    nonreal |= warp_nonreal[w];
  }
  // per tile: query tiles of 64 from its diagonal (causal) to the end; none
  // when every key of the tile lies past the last real key (exact: its dK
  // and dV stay 0)
  auto first_query_tile = [&](int tile) { return causal ? tile : 0; };
  auto stages = [&](int tile) {
    return last_real >= 0 && tile * kBlk > last_real
               ? 0 : L / kQStage - first_query_tile(tile);
  };

  if (warp >= kConsumers * 4) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kProducerThread) {
      if (stages(tile0) == 0) {   // so is tile1's: drain the early copies
        mbar_wait(&bars->kv_full[0], 0);
        for (int u = 0; u < pre; ++u) bars->q.wait_full(u);
      }
      int i = 0;   // ring uses, across both tiles
      for (int t = 0; t < 2; ++t) {
        const int tile = t ? tile1 : tile0, n_use = stages(tile);
        if (n_use == 0) continue;
        if (t == 1)
          load_kv<D>(k_sh + kBlk * D, v_sh + kBlk * D, &k_map, &v_map,
                     &bars->kv_full[1], tile1 * kBlk, bh);
        for (int u = 0; u < n_use; ++u, ++i) {
          if (t == 0 && u < pre) continue;   // issued before the mask scan
          if (i >= S) bars->q.wait_empty(i);
          load_stage<D, S>(bars, q_sh, do_sh, lse_sh, dl_sh, &q_map, &do_map,
                           lse, delta, i, first_query_tile(tile) + u, bh, L);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wrow = (warp & 3) * 16 + (lane >> 2);   // key in the tile
    const int quad = lane & 3;
    int i0 = 0;
    for (int t = 0; t < 2; ++t) {
      const int tile = t ? tile1 : tile0, n_use = stages(tile);
      const int k0 = tile * kBlk;
      bool keep[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        keep[h] = mask[static_cast<int64_t>(b) * L + k0 + wrow + 8 * h] > 0;
      const bool all_real = !((nonreal >> t) & 1);
      float acc[C::kAcc];
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
      const int64_t r0 = static_cast<int64_t>(bh) * L + k0;
      if (warp < 4) {
        if (n_use > 0)
          dkv_consume<D, false, S>(bars, &bars->kv_full[t],
                                   k_sh + t * kBlk * D, v_sh + t * kBlk * D,
                                   q_sh, do_sh, lse_sh, dl_sh, i0, n_use,
                                   first_query_tile(tile), tile, causal,
                                   all_real, keep, wrow, quad, lane, scale,
                                   acc);
        store_rows<D>(dv, r0, wrow, quad, acc);
      } else {
        if (n_use > 0)
          dkv_consume<D, true, S>(bars, &bars->kv_full[t],
                                  k_sh + t * kBlk * D, v_sh + t * kBlk * D,
                                  q_sh, do_sh, lse_sh, dl_sh, i0, n_use,
                                  first_query_tile(tile), tile, causal,
                                  all_real, keep, wrow, quad, lane, scale,
                                  acc);
        store_rows<D>(dk, r0, wrow, quad, acc);
      }
      i0 += n_use;
    }
  }
}

// ------------------------------------------------------------------ host

template <int D>
size_t dq_smem_bytes(int L) {
  constexpr int S = Cfg<D>::kDqStages;
  return 1024 + static_cast<size_t>(2 + 2 * S) * kQRows * D * 2 +
         sizeof(DqBars<S>) + static_cast<size_t>(L / 32) * 4;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int S = Cfg<D>::kDkvStages;
  return 1024 + 4 * static_cast<size_t>(kBlk) * D * 2 +
         static_cast<size_t>(S) * (2 * kQStage * D * 2 + 2 * kQStage * 4) +
         sizeof(DkvBars<S>);
}

// Allows `bytes` of dynamic shared memory for `kernel` (once per size).
template <typename K>
int allow_smem(K kernel, size_t bytes, size_t& enabled) {
  if (bytes <= enabled) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  enabled = bytes;
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout;
  const int* mask;
  const float *lse, *delta;
  int bh, heads, L, causal;
};

// Maps over q, k, v, dO ([bh, L, D] bf16) with boxes of `q_rows` rows for
// q and dO and `k_rows` for k and v.
template <int D>
int encode_maps(const Args& a, int q_rows, int k_rows, CUtensorMap (&maps)[4]) {
  using C = Cfg<D>;
  const void* srcs[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {q_rows, k_rows, k_rows, q_rows};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper_host::encode_bf16_3d(
        &maps[i], srcs[i], D, a.L, a.bh, C::kChunkCols, rows[i], C::kSpan);
    if (err != 0) return err;
  }
  return 0;
}

template <int D>
int launch_dq(const Args& a, void* dq, cudaStream_t st) {
  CUtensorMap maps[4];
  int err = encode_maps<D>(a, kQRows, kKStage, maps);
  if (err != 0) return err;
  const size_t bytes = dq_smem_bytes<D>(a.L);
  static size_t enabled = 0;
  err = allow_smem(flash_bwd_dq_kernel<D>, bytes, enabled);
  if (err != 0) return err;
  const dim3 grid(a.L / kQRows, a.bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], a.mask, a.lse, a.delta, a.heads,
      a.L, a.causal, 1.0f / sqrtf(static_cast<float>(D)),
      static_cast<__nv_bfloat16*>(dq));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  CUtensorMap maps[4];
  int err = encode_maps<D>(a, kQStage, kBlk, maps);
  if (err != 0) return err;
  constexpr size_t bytes = dkv_smem_bytes<D>();
  static size_t enabled = 0;
  err = allow_smem(flash_bwd_dkv_kernel<D>, bytes, enabled);
  if (err != 0) return err;
  const dim3 grid(a.L / kBlk / 2, a.bh);   // two key tiles a block
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], a.mask, a.lse, a.delta, a.heads,
      a.L, a.causal, 1.0f / sqrtf(static_cast<float>(D)),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(const Args& a) {
  const uintptr_t stats = reinterpret_cast<uintptr_t>(a.lse) |
                          reinterpret_cast<uintptr_t>(a.delta) |
                          reinterpret_cast<uintptr_t>(a.mask);
  return a.bh < 1 || a.bh > 65535 || a.heads < 1 || a.bh % a.heads != 0 ||
         a.L < kQRows || a.L % kQRows != 0 || stats % 16 != 0;
}

}  // namespace

extern "C" {

// The tiles that the twin must run at to skip and round as each kernel
// does: (block_q, block_k) of dQ, then of dK/dV. L must be a multiple of
// the largest (128).
void flash_attention_bwd_tiles(int* dq_block_q, int* dq_block_k,
                               int* dkv_block_q, int* dkv_block_k) {
  *dq_block_q = kQRows;
  *dq_block_k = kKStage;
  *dkv_block_q = kQStage;
  *dkv_block_k = kBlk;
}

// q, k, v, dout, dq [bh, L, d] bf16, 16-byte aligned; mask [bh / heads, L]
// int32 (> 0 = real key); lse, delta [bh, L] f32; mask, lse and delta
// 16-byte aligned. Returns the CUDA error code of the launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const int* mask, const void* dout, const float* lse,
                           const float* delta, int bh, int heads, int L, int d,
                           int causal, void* dq, void* stream) {
  const Args a{q, k, v, dout, mask, lse, delta, bh, heads, L, causal};
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dq<32>(a, dq, st);
    case 64: return launch_dq<64>(a, dq, st);
    case 128: return launch_dq<128>(a, dq, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As flash_attention_bwd_dq, writing dk and dv [bh, L, d] bf16.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const int* mask, const void* dout,
                            const float* lse, const float* delta, int bh,
                            int heads, int L, int d, int causal, void* dk,
                            void* dv, void* stream) {
  const Args a{q, k, v, dout, mask, lse, delta, bh, heads, L, causal};
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32>(a, dk, dv, st);
    case 64: return launch_dkv<64>(a, dk, dv, st);
    case 128: return launch_dkv<128>(a, dk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
