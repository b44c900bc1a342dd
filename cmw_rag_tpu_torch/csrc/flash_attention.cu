// Flash attention forward for Hopper (sm_90a): TMA ring, wgmma, warp
// specialisation.
//
// Replaces the TPU kernels cmw_rag_tpu/ops/flash_attention.py:306 _fa_forward
// (body _flash_fwd_kernel) and :92 flash_attention (body _flash_kernel, the
// same function without the log-sum-exp).
//
// Function, per (batch*head, query row), over bf16 q, k, v [BH, L, D]:
//   s = (q . k) * (1/sqrt(D)) in fp32; s = -1e30 where key_mask[b, key] <= 0
//   (b = bh / H) and, when causal, where key > query;
//   online softmax over key blocks of 64: m_new = max(m, rowmax(s)),
//   p = exp(s - m_new), alpha = exp(m - m_new), l = alpha*l + rowsum(p),
//   acc = alpha*acc + bf16(p) . v (fp32 accumulate);
//   o = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30)) in fp32.
// The plain twin run with block_q = 128, block_k = 64 (flash_attention_tiles)
// rounds p against the same running maxima.
//
// What bounds it: 4*BH*L^2*D operations (halved when causal) against
// 2*3*BH*L*D bytes in and 2*BH*L*D out; at the rerank shape (BH = 512,
// L = 1024, D = 128) that is ~500 operations per byte, above the H100's
// ~295, so the tensor cores bound it: the design keeps them fed.
//
// Design (helpers in hopper.cuh):
//   * One block per (128-row query tile, batch*head): two consumer
//     warpgroups of 64 query rows each and one producer warpgroup, of which
//     one thread issues every copy. setmaxnreg gives the consumers 232
//     registers (a [64, D] float32 accumulator and a [64, 64] score tile
//     each) and the producer 40.
//   * Copies: the Q tile once, then K and V tiles of 128 keys through a ring
//     of 2 stages (D = 128) or 4 (D = 64, 32) in dynamic shared memory, by
//     TMA (cp.async.bulk.tensor over a 3-D map [BH, L, D], so a box never
//     crosses into the next batch*head) with a 128-byte swizzle (64-byte for
//     D = 32), on full/empty mbarrier pairs. K and V complete on barriers of
//     their own, so S = Q K^T starts while V is still landing. No
//     __syncthreads() in the key loop.
//   * Each 128-key stage is taken as two 64-key blocks, the softmax's
//     blocks: S = Q K^T is wgmma m64n64k16 with both operands in shared
//     memory (K-major). The online softmax runs in registers on S's
//     accumulator layout, whose pairs are the register A operand of P V: P
//     is rounded to bf16 in place and O += P V is wgmma m64nDk16 with V's
//     descriptor MN-major (transposed), so V is neither copied nor
//     ldmatrix'd. Why 64-key blocks: with 128 keys p rounds against other
//     running maxima, and the long-context scores of chip_smoke.py (full
//     width, random weights) land 0.054 from plain attention's, past that
//     check's 0.05; with 64 they land 0.022 away. Why each block's products
//     are waited for: two products in flight in one warpgroup (FA3's
//     intra-warpgroup overlap) made ptxas serialize the wgmmas and spill.
//   * The softmax is what competes with the tensor cores, so it is kept
//     short: on a tile whose keys are all real and visible, the row max is
//     taken over the raw scores (times the positive scale it is the max of
//     the scaled ones, exactly) and p = 2^(s c - m log2 e), c = scale
//     log2 e, is one FFMA and one ex2 a score; other tiles scale, mask to
//     -1e30 and take exp(s - m) of the difference, so that a row with no
//     real key yet gets exactly p = 1.
//   * Ping-pong: the two consumer warpgroups take turns to issue their
//     products (named barriers), so one's softmax runs while the other's
//     products keep the tensor cores busy.
//   * The key mask: before the roles split, the block turns the mask row
//     (up to the causal limit) into bits in shared memory, with the first
//     non-real key, the first and the last real key. Tiles wholly before
//     the first non-real key skip the mask, the causal mask is applied on
//     the diagonal tile only, and the ring never waits on the mask.
//   * Work skipping, exact: causal key tiles wholly above the diagonal are
//     not processed; key tiles wholly past the batch row's last real key are
//     not processed either when the first real key lies in tile 0. A row
//     that has seen a real key has m above -1e30, so a tile of masked keys
//     gives it p = exp(-1e30 - m) = 0 and alpha = 1 exactly: skipping it
//     changes nothing. A row that sees no real key takes p = 1 over every
//     processed key, as JAX does, so when the first real key is past tile 0
//     every tile is processed.
//   * Schedule: the query tile is gridDim.x - 1 - blockIdx.x, so the causal
//     tiles of a batch*head start heaviest first and the last blocks issued
//     are the lightest; the tiles of one batch*head run together and share
//     its K and V in L2.
// Takes D in {32, 64, 128} and L a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;            // query rows and keys per tile
constexpr int kConsumers = 2;         // warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kWarps = kThreads / 32;
constexpr int kProducerThread = kConsumers * 128;
constexpr float kMaskVal = -1e30f;
constexpr int kTurn = 1;              // named barriers kTurn, kTurn + 1

template <int D>
struct Cfg {
  static constexpr int kSpan = D * 2 >= 128 ? 128 : D * 2;  // swizzle bytes
  static constexpr int kChunkCols = kSpan / 2;               // bf16 per chunk
  static constexpr int kChunks = D / kChunkCols;
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kTileBytes = kTile * D * 2;           // Q, K or V tile
  static constexpr int kAcc = D / 2;                         // O registers
};

constexpr int kBlockK = 64;            // keys per online-softmax block
constexpr int kScoreRegs = kBlockK / 2;   // S registers: m64n64

// The K ring (full: K landed; empty: both warpgroups are done with K and V
// of the stage), V's own full barriers on the same parities, and Q's.
template <int S>
struct __align__(16) Bars {
  Ring<S> kv;
  uint64_t v_full[S];
  uint64_t q_full;
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {   // 2^x, as __expf uses it
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row, int bh) {
  using C = Cfg<D>;
  mbar_arrive_expect_tx(bar, C::kTileBytes);
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c)
    tma_load_3d(dst + c * kTile * C::kChunkCols, map, bar, c * C::kChunkCols,
                row, bh);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const int* __restrict__ mask, int heads, int L, int causal,
                 float scale, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* k_sh = q_sh + kTile * D;
  __nv_bfloat16* v_sh = k_sh + S * kTile * D;
  Bars<S>* bars = reinterpret_cast<Bars<S>*>(v_sh + S * kTile * D);
  uint32_t* bits = reinterpret_cast<uint32_t*>(bars + 1);   // L / 32 words
  __shared__ int warp_first_zero[kWarps], warp_first_real[kWarps],
      warp_last_real[kWarps];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tile first
  const int bh = blockIdx.y, b = bh / heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int limit = causal ? (qt + 1) * kTile : L;   // keys this tile sees

  if (tid == kProducerThread) {
    mbar_init(&bars->q_full, 1);
    bars->kv.init(kConsumers * 4);   // empty: every consumer warp arrives
    for (int s = 0; s < S; ++s) mbar_init(&bars->v_full[s], 1);
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    // Q and key tile 0 are always needed: they land while the mask is read
    load_tile<D>(q_sh, &q_map, &bars->q_full, qt * kTile, bh);
    load_tile<D>(k_sh, &k_map, &bars->kv.full[0], 0, bh);
    load_tile<D>(v_sh, &v_map, &bars->v_full[0], 0, bh);
  }

  // the mask row up to `limit` as bits (word w holds keys 32w .. 32w + 31),
  // with the first non-real key, the first and the last real key
  {
    const int* mrow = mask + static_cast<int64_t>(b) * L;
    int first_zero = limit, first_real = limit, last_real = -1;
#pragma unroll 2
    for (int c = warp; c < limit / kTile; c += kWarps) {
      int m[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) m[w] = mrow[c * kTile + 32 * w + lane];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t real = __ballot_sync(0xffffffffu, m[w] > 0);
        const int k0 = c * kTile + 32 * w;
        if (lane == 0) bits[c * 4 + w] = real;
        if (real != 0u) {
          first_real = min(first_real, k0 + __ffs(real) - 1);
          last_real = max(last_real, k0 + 31 - __clz(real));
        }
        if (real != 0xffffffffu)
          first_zero = min(first_zero, k0 + __ffs(~real) - 1);
      }
    }
    if (lane == 0) {
      warp_first_zero[warp] = first_zero;
      warp_first_real[warp] = first_real;
      warp_last_real[warp] = last_real;
    }
  }
  __syncthreads();
  int first_zero = limit, first_real = limit, last_real = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first_zero = min(first_zero, warp_first_zero[w]);
    first_real = min(first_real, warp_first_real[w]);
    last_real = max(last_real, warp_last_real[w]);
  }
  int n_kt = limit / kTile;
  if (first_real < kTile) n_kt = min(n_kt, last_real / kTile + 1);
  const int masked_from = first_zero / kTile;   // tiles before: all real

  if (warp >= kConsumers * 4) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kProducerThread) {
      for (int kt = 1; kt < n_kt; ++kt) {
        const int s = Ring<S>::stage(kt);
        if (kt >= S) bars->kv.wait_empty(kt);
        load_tile<D>(k_sh + s * kTile * D, &k_map, &bars->kv.full[s],
                     kt * kTile, bh);
        load_tile<D>(v_sh + s * kTile * D, &v_map, &bars->v_full[s],
                     kt * kTile, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid >> 7;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);   // and row + 8
    const int quad = lane & 3;

    // descriptors: Q rows of this warpgroup, K and V of stage 0
    const uint64_t q_desc = smem_desc(q_sh + wg * 64 * C::kChunkCols, 16,
                                      8 * C::kSpan, C::kSpan);
    const uint64_t k_desc0 = smem_desc(k_sh, 16, 8 * C::kSpan, C::kSpan);
    const uint64_t v_desc0 = smem_desc(v_sh, kTile * C::kSpan, 8 * C::kSpan,
                                       C::kSpan);

    float acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
    float m_run[2] = {kMaskVal, kMaskVal};
    float l_run[2] = {0.f, 0.f};   // this thread's columns only

    if (wg == 1) named_bar_arrive(kTurn, 256);   // warpgroup 0 issues first
    mbar_wait(&bars->q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = Ring<S>::stage(kt);
      const uint32_t stage_off = s * C::kTileBytes;
      const bool key_mask = kt >= masked_from;
      const bool diag = causal && kt == qt;
      uint32_t words[4] = {~0u, ~0u, ~0u, ~0u};
      bars->kv.wait_full(kt);
      if (key_mask) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(bits + kt * 4);
        words[0] = w4.x; words[1] = w4.y; words[2] = w4.z; words[3] = w4.w;
      }
#pragma unroll
      for (int blk = 0; blk < kTile / kBlockK; ++blk) {
        // S = Q K^T over the block's 64 keys, D in k16 steps
        float sc[kScoreRegs];
        named_bar_sync(kTurn + wg, 256);      // this warpgroup's turn
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int chunk = ks * 16 / C::kChunkCols;
          const uint32_t within = (ks * 16 % C::kChunkCols) * 2;
          wgmma_ss(sc,
                   desc_advance(q_desc, chunk * kTile * C::kSpan + within),
                   desc_advance(k_desc0, stage_off + chunk * kTile * C::kSpan +
                                             blk * kBlockK * C::kSpan + within),
                   ks > 0 ? 1 : 0);
        }
        wgmma_commit();
        named_bar_arrive(kTurn + 1 - wg, 256);  // the other's turn
        wgmma_wait<0>();
        fence_regs(sc);

        // row max, alpha, p. Register i: row `row` + 8 ((i / 2) % 2), key
        // 64 blk + 8 (i / 4) + 2 quad + i % 2 of the tile
        float alpha[2];
        uint32_t pa[kBlockK / 16][4];
        if (!key_mask && !diag) {
          // every key real and visible: the max of the raw scores times the
          // (positive) scale is the max of the scaled ones, exactly, and
          // p = 2^(s c - m log2 e), c = scale log2 e, is one FFMA and one
          // ex2 a score
          float mx[2] = {sc[0], sc[2]};
#pragma unroll
          for (int i = 0; i < kScoreRegs; ++i)
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
          float mb[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            const float m_new = fmaxf(m_run[h], mx[h] * scale);
            alpha[h] = __expf(m_run[h] - m_new);
            m_run[h] = m_new;
            l_run[h] *= alpha[h];
            mb[h] = -m_new * kLog2e;
          }
          const float c = scale * kLog2e;
#pragma unroll
          for (int i = 0; i < kScoreRegs; i += 2) {
            const int h = (i >> 1) & 1;
            const float p0 = ex2(fmaf(sc[i], c, mb[h]));
            const float p1 = ex2(fmaf(sc[i + 1], c, mb[h]));
            l_run[h] += p0 + p1;
            pa[i >> 3][(i >> 1) & 3] = pack_bf16x2(p0, p1);
          }
        } else {
          // masked scores are exactly -1e30 and p = exp(s - m) takes the
          // difference first, so a row with no real key so far gets p = 1
          float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
          for (int i = 0; i < kScoreRegs; ++i) {
            const int h = (i >> 1) & 1;
            const int col = blk * kBlockK + 8 * (i >> 2) + 2 * quad + (i & 1);
            float x = sc[i] * scale;
            const uint32_t wv = (i >> 4) ? (blk ? words[3] : words[1])
                                         : (blk ? words[2] : words[0]);
            if (!((wv >> (col & 31)) & 1u)) x = kMaskVal;
            if (diag && col > row + 8 * h) x = kMaskVal;
            sc[i] = x;
            mx[h] = fmaxf(mx[h], x);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            alpha[h] = __expf(m_run[h] - mx[h]);
            m_run[h] = mx[h];
            l_run[h] *= alpha[h];
          }
#pragma unroll
          for (int i = 0; i < kScoreRegs; i += 2) {
            const int h = (i >> 1) & 1;
            const float p0 = __expf(sc[i] - m_run[h]);
            const float p1 = __expf(sc[i + 1] - m_run[h]);
            l_run[h] += p0 + p1;
            pa[i >> 3][(i >> 1) & 3] = pack_bf16x2(p0, p1);
          }
        }
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) acc[i] *= alpha[(i >> 1) & 1];

        // acc += P V over the block's keys in k16 steps
        if (blk == 0) mbar_wait(&bars->v_full[s], Ring<S>::parity(kt));
        named_bar_sync(kTurn + wg, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk)
          wgmma_rs_tb(acc, pa[kk],
                      desc_advance(v_desc0, stage_off +
                                                (blk * kBlockK + kk * 16) *
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

    // o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
    const int64_t q0 = static_cast<int64_t>(bh) * L + qt * kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int64_t r = q0 + row + 8 * h;
      __nv_bfloat16* orow = o + r * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16x2(acc[4 * j + 2 * h] / l, acc[4 * j + 2 * h + 1] / l);
      if (lse != nullptr && quad == 0) lse[r] = m_run[h] + logf(l);
    }
  }
}

template <int D>
size_t smem_bytes(int L) {
  using C = Cfg<D>;
  return 1024 + static_cast<size_t>(1 + 2 * C::kStages) * C::kTileBytes +
         sizeof(Bars<C::kStages>) + static_cast<size_t>(L / 32) * 4;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           int bh, int heads, int L, int causal, void* o, float* lse,
           cudaStream_t st) {
  using C = Cfg<D>;
  CUtensorMap maps[3];
  const void* srcs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper_host::encode_bf16_3d(&maps[i], srcs[i], D, L, bh,
                                                C::kChunkCols, kTile, C::kSpan);
    if (err != 0) return err;
  }
  const size_t bytes = smem_bytes<D>(L);
  static size_t enabled = 0;   // dynamic shared memory allowed so far
  if (bytes > enabled) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    enabled = bytes;
  }
  const dim3 grid(L / kTile, bh);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, st>>>(
      maps[0], maps[1], maps[2], mask, heads, L, causal,
      1.0f / sqrtf(static_cast<float>(D)), static_cast<__nv_bfloat16*>(o),
      lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Query rows (and keys) per tile: L must be a multiple of this.
int flash_attention_tile() { return kTile; }

// The twin's blocks that round p as the kernel does: block_q = 128 query
// rows, block_k = 64 keys (the online softmax's block).
void flash_attention_tiles(int* block_q, int* block_k) {
  *block_q = kTile;
  *block_k = kBlockK;
}

// q, k, v, o [bh, L, d] bf16 (16-byte aligned); mask [bh / heads, L] int32
// (> 0 = real key); lse [bh, L] f32 or null. Returns the CUDA error code of
// the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* mask, int bh, int heads, int L, int d,
                        int causal, void* o, float* lse, void* stream) {
  if (bh < 1 || bh > 65535 || heads < 1 || bh % heads != 0 || L < kTile ||
      L % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, mask, bh, heads, L, causal, o, lse, st);
    case 64: return launch<64>(q, k, v, mask, bh, heads, L, causal, o, lse, st);
    case 128: return launch<128>(q, k, v, mask, bh, heads, L, causal, o, lse, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
