// Flash attention backward for Hopper (sm_90a): dQ, and dK with dV.
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
//   dV = sum over queries of p * dO, with p kept in float32;
// fp32 sums, bf16 outputs. Causal (query tile, key tile) pairs wholly above
// the diagonal are skipped, as both TPU kernels skip them.
//
// What bounds it: five products of 2*L^2*D operations per head (S, dP, dQ,
// dK, dV; halved when causal) against 2*(4 in + 3 out)*BH*L*D bytes; at the
// trainer's shape (BH = 128, L = 1024, D = 128) ~550 operations per byte,
// above the H100's ~295, so the tensor cores bound it. The dQ kernel
// recomputes S and dP, so the two kernels together run seven products.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   * Two kernels, as JAX has, so that each output tile is summed by one
//     block and no atomics are needed. Blocks of 4 warps, 64-row tiles.
//   * dQ: one block per (64-row query tile, batch*head). Each warp owns 16
//     query rows; their Q and dO fragments (the A operands of S = Q K^T and
//     dP = dO V^T), lse, delta and the [16, D] fp32 dQ accumulator stay in
//     registers over the key loop. Per 64-key tile K and V go to shared
//     memory (16-byte loads, +8 bf16 row padding: conflict-free 32-bit
//     fragment reads); per 16 keys S and dP come from mma.sync m16n8k16
//     (bf16 in, fp32 out), ds is rounded to bf16 and reused in registers as
//     the A operand of dS K (the accumulator layout of two m16n8 tiles is
//     the A layout of one m16k16 step), K's B fragments from ldmatrix.trans.
//   * dK/dV: one block per (64-key tile, batch*head); each warp owns 16
//     keys and computes the transposed tiles S^T = K Q^T and dP^T = V dO^T,
//     so that P^T and dS^T land in registers in the A layout of
//     dV += P^T dO and dK += dS^T Q. The block's K and V tiles stay in
//     shared memory (their A fragments are read from there, which keeps the
//     two [16, D] fp32 accumulators in registers), Q, dO, lse and delta of
//     each 64-query tile are staged beside them: 70 KB of dynamic shared
//     memory at D = 128.
//   * dV keeps p in float32 as JAX does: p = hi + lo with hi = bf16(p) and
//     lo = bf16(p - hi), two bf16 MMAs, about 16 bits of p.
//   * expf, not __expf, so that p is as torch.exp's on the twin.
// Takes D in {32, 64, 128} and L a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;   // query rows and keys per tile
constexpr float kMaskVal = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two transposed 8x8 bf16 matrices from shared memory: lane i < 16 gives the
// address of row i (rows 0-7 the first matrix, 8-15 the second); each lane
// receives (row 2t, 2t+1; column g) of each, the B layout of m16n8k16.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// A [64, D] bf16 tile from global rows (row stride D) into shared memory
// (row stride D + 8), 16 bytes a thread at a time.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sh,
                                          const __nv_bfloat16* g) {
  constexpr int kS = D + 8;
  for (int idx = threadIdx.x; idx < kTile * (D / 8); idx += kThreads) {
    const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(sh + r * kS + c8) =
        *reinterpret_cast<const uint4*>(g + static_cast<int64_t>(r) * D + c8);
  }
}

// Packs two m16n8 accumulator tiles (columns 0-7 and 8-15 of a 16-wide
// step) as the A operand of one m16n8k16 product: (row g, k 2t..),
// (row g+8, k 2t..), (row g, k 8+2t..), (row g+8, k 8+2t..).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    a[nt * 2 + 0] = pack_bf16x2(x[nt][0], x[nt][1]);
    a[nt * 2 + 1] = pack_bf16x2(x[nt][2], x[nt][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int heads, int L,
                    int causal, float scale, __nv_bfloat16* __restrict__ dq) {
  constexpr int kS = D + 8;          // bf16 per shared row of K and V
  constexpr int kDT = D / 8;         // n8 tiles over D
  constexpr int kKK = D / 16;        // k16 steps over D
  __shared__ __align__(16) __nv_bfloat16 k_sh[kTile * kS];
  __shared__ __align__(16) __nv_bfloat16 v_sh[kTile * kS];
  __shared__ int m_sh[kTile];

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(bh) * L * D;
  const int row0 = qt * kTile + warp * 16;   // this warp's first query row

  uint32_t qa[kKK][4], da[kKK][4];
#pragma unroll
  for (int kk = 0; kk < kKK; ++kk) {
    const int64_t off0 =
        base + static_cast<int64_t>(row0 + g) * D + kk * 16 + 2 * t;
    const int64_t off1 = off0 + 8 * D;
    qa[kk][0] = ld32(q + off0);
    qa[kk][1] = ld32(q + off1);
    qa[kk][2] = ld32(q + off0 + 8);
    qa[kk][3] = ld32(q + off1 + 8);
    da[kk][0] = ld32(dout + off0);
    da[kk][1] = ld32(dout + off1);
    da[kk][2] = ld32(dout + off0 + 8);
    da[kk][3] = ld32(dout + off1 + 8);
  }
  float lse_r[2], dl_r[2];   // rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = static_cast<int64_t>(bh) * L + row0 + g + 8 * h;
    lse_r[h] = lse[r];
    dl_r[h] = delta[r];
  }
  float acc[kDT][4];
#pragma unroll
  for (int nd = 0; nd < kDT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  // with equal query and key tiles, key tile kt has a key at or below the
  // diagonal of query tile qt exactly when kt <= qt
  const int n_kt = causal ? qt + 1 : L / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_sh, k + base + static_cast<int64_t>(kt) * kTile * D);
    load_tile<D>(v_sh, v + base + static_cast<int64_t>(kt) * kTile * D);
    for (int idx = threadIdx.x; idx < kTile; idx += kThreads)
      m_sh[idx] = mask[static_cast<int64_t>(b) * L + kt * kTile + idx];
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kTile / 16; ++c) {   // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        const __nv_bfloat16* kr = k_sh + (c * 16 + nt * 8 + g) * kS + 2 * t;
        const __nv_bfloat16* vr = v_sh + (c * 16 + nt * 8 + g) * kS + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kKK; ++kk) {
          mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                   ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
          mma_bf16(dp[nt], da[kk][0], da[kk][1], da[kk][2], da[kk][3],
                   ld32(vr + kk * 16), ld32(vr + kk * 16 + 8));
        }
      }
      // element e of tile nt: query row0 + g + 8*(e/2), key
      // kt*64 + c*16 + nt*8 + 2t + (e%2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = c * 16 + nt * 8 + 2 * t + (e & 1);
          float x = s[nt][e] * scale;
          if (m_sh[kl] <= 0) x = kMaskVal;
          if (causal && kt * kTile + kl > row0 + g + (e >> 1) * 8) x = kMaskVal;
          const float p = expf(x - lse_r[e >> 1]);
          s[nt][e] = p * (dp[nt][e] - dl_r[e >> 1]) * scale;   // ds
        }
      uint32_t dsa[4];
      pack_a(dsa, s);
      // dQ += dS K over these 16 keys: B[key][d] = K[key][d]
#pragma unroll
      for (int nd = 0; nd < kDT; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, k_sh + (c * 16 + (lane & 15)) * kS + nd * 8);
        mma_bf16(acc[nd], dsa[0], dsa[1], dsa[2], dsa[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* orow =
        dq + base + static_cast<int64_t>(row0 + g + 8 * h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDT; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16x2(acc[nd][2 * h], acc[nd][2 * h + 1]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * kTile * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16)) +
         2 * kTile * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int heads, int L,
                     int causal, float scale, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv) {
  constexpr int kS = D + 8;
  constexpr int kDT = D / 8;
  constexpr int kKK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_sh = k_sh + kTile * kS;
  __nv_bfloat16* q_sh = v_sh + kTile * kS;
  __nv_bfloat16* do_sh = q_sh + kTile * kS;
  float* lse_sh = reinterpret_cast<float*>(do_sh + kTile * kS);
  float* dl_sh = lse_sh + kTile;

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(bh) * L * D;
  const int key0 = kt * kTile + warp * 16;   // this warp's first key

  load_tile<D>(k_sh, k + base + static_cast<int64_t>(kt) * kTile * D);
  load_tile<D>(v_sh, v + base + static_cast<int64_t>(kt) * kTile * D);
  bool keep[2];   // keys g and g + 8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h)
    keep[h] = mask[static_cast<int64_t>(b) * L + key0 + g + 8 * h] > 0;

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int nd = 0; nd < kDT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // this warp's K and V rows g and g + 8 (A operands read from shared)
  const __nv_bfloat16* kr = k_sh + (warp * 16 + g) * kS + 2 * t;
  const __nv_bfloat16* vr = v_sh + (warp * 16 + g) * kS + 2 * t;

  // query tiles that end before this key tile see none of its keys
  for (int qt = causal ? kt : 0; qt < L / kTile; ++qt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(q_sh, q + base + static_cast<int64_t>(qt) * kTile * D);
    load_tile<D>(do_sh, dout + base + static_cast<int64_t>(qt) * kTile * D);
    for (int idx = threadIdx.x; idx < kTile; idx += kThreads) {
      const int64_t r = static_cast<int64_t>(bh) * L + qt * kTile + idx;
      lse_sh[idx] = lse[r];
      dl_sh[idx] = delta[r];
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kTile / 16; ++c) {   // 16 queries at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        const int o = kk * 16;
        const uint32_t a0 = ld32(kr + o), a1 = ld32(kr + 8 * kS + o),
                       a2 = ld32(kr + o + 8), a3 = ld32(kr + 8 * kS + o + 8);
        const uint32_t w0 = ld32(vr + o), w1 = ld32(vr + 8 * kS + o),
                       w2 = ld32(vr + o + 8), w3 = ld32(vr + 8 * kS + o + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* qr = q_sh + (c * 16 + nt * 8 + g) * kS + 2 * t;
          const __nv_bfloat16* dr = do_sh + (c * 16 + nt * 8 + g) * kS + 2 * t;
          mma_bf16(s[nt], a0, a1, a2, a3, ld32(qr + o), ld32(qr + o + 8));
          mma_bf16(dp[nt], w0, w1, w2, w3, ld32(dr + o), ld32(dr + o + 8));
        }
      }
      // element e of tile nt: key key0 + g + 8*(e/2), query
      // qt*64 + c*16 + nt*8 + 2t + (e%2)
      float p_hi[2][4], p_lo[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c * 16 + nt * 8 + 2 * t + (e & 1);
          float x = s[nt][e] * scale;
          if (!keep[e >> 1]) x = kMaskVal;
          if (causal && key0 + g + (e >> 1) * 8 > qt * kTile + ql) x = kMaskVal;
          const float p = expf(x - lse_sh[ql]);
          const float hi = __bfloat162float(__float2bfloat16_rn(p));
          p_hi[nt][e] = hi;
          p_lo[nt][e] = p - hi;
          s[nt][e] = p * (dp[nt][e] - dl_sh[ql]) * scale;   // ds
        }
      uint32_t pa_hi[4], pa_lo[4], dsa[4];
      pack_a(pa_hi, p_hi);
      pack_a(pa_lo, p_lo);
      pack_a(dsa, s);
      // dV += P^T dO and dK += dS^T Q over these 16 queries
#pragma unroll
      for (int nd = 0; nd < kDT; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          do_sh + (c * 16 + (lane & 15)) * kS + nd * 8);
        mma_bf16(dv_acc[nd], pa_hi[0], pa_hi[1], pa_hi[2], pa_hi[3], b0, b1);
        mma_bf16(dv_acc[nd], pa_lo[0], pa_lo[1], pa_lo[2], pa_lo[3], b0, b1);
        ldmatrix_x2_trans(b0, b1, q_sh + (c * 16 + (lane & 15)) * kS + nd * 8);
        mma_bf16(dk_acc[nd], dsa[0], dsa[1], dsa[2], dsa[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t off =
        base + static_cast<int64_t>(key0 + g + 8 * h) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDT; ++nd) {
      *reinterpret_cast<uint32_t*>(dk + off + nd * 8) =
          pack_bf16x2(dk_acc[nd][2 * h], dk_acc[nd][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + nd * 8) =
          pack_bf16x2(dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const int* mask;
  const float *lse, *delta;
  int bh, heads, L, causal;
};

template <int D>
int launch_dq(const Args& a, void* dq, cudaStream_t st) {
  const dim3 grid(a.L / kTile, a.bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, st>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.lse, a.delta, a.heads, a.L, a.causal,
      1.0f / sqrtf(static_cast<float>(D)), static_cast<__nv_bfloat16*>(dq));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D>();
  const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(a.L / kTile, a.bh);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.lse, a.delta, a.heads, a.L, a.causal,
      1.0f / sqrtf(static_cast<float>(D)), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const int* mask,
               const void* dout, const float* lse, const float* delta,
               int bh, int heads, int L, int causal) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              mask, lse, delta, bh, heads, L, causal};
}

bool bad_shape(int bh, int heads, int L) {
  return bh < 1 || heads < 1 || bh % heads != 0 || L < kTile || L % kTile != 0;
}

}  // namespace

extern "C" {

// Query rows, and keys, per tile: L must be a multiple of this.
int flash_attention_bwd_tile() { return kTile; }

// q, k, v, dout, dq [bh, L, d] bf16; mask [bh / heads, L] int32 (> 0 = real
// key); lse, delta [bh, L] f32. Returns the CUDA error code of the launch.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const int* mask, const void* dout, const float* lse,
                           const float* delta, int bh, int heads, int L, int d,
                           int causal, void* dq, void* stream) {
  if (bad_shape(bh, heads, L)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, mask, dout, lse, delta, bh, heads, L,
                           causal);
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
  if (bad_shape(bh, heads, L)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, mask, dout, lse, delta, bh, heads, L,
                           causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dkv<32>(a, dk, dv, st);
    case 64: return launch_dkv<64>(a, dk, dv, st);
    case 128: return launch_dkv<128>(a, dk, dv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
