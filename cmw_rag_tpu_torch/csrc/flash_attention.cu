// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels cmw_rag_tpu/ops/flash_attention.py:306 _fa_forward
// (body _flash_fwd_kernel) and :92 flash_attention (body _flash_kernel, the
// same function without the log-sum-exp).
//
// Function, per (batch*head, query row), over bf16 q, k, v [BH, L, D]:
//   s = (q . k) * (1/sqrt(D)) in fp32; s = -1e30 where key_mask[b, key] <= 0
//   (b = bh / H) and, when causal, where key > query;
//   online softmax over key tiles: m_new = max(m, rowmax(s)),
//   p = exp(s - m_new), alpha = exp(m - m_new), l = alpha*l + rowsum(p),
//   acc = alpha*acc + bf16(p) . v (fp32 accumulate);
//   o = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30)) in fp32.
// Causal key tiles wholly above the diagonal are skipped, not masked.
//
// What bounds it: 4*BH*L^2*D operations (halved when causal) against
// 2*3*BH*L*D bytes in and 2*BH*L*D out; at the rerank shape (BH = 512,
// L = 1024, D = 128) that is ~500 operations per byte, above the H100's
// ~295, so the tensor cores bound it.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   * One block of 4 warps per (64-row query tile, batch*head). Each warp
//     owns 16 query rows; their Q fragments stay in registers for the whole
//     key loop, as do the running max, the running sum (per thread, summed
//     over the row's 4 lanes at the end) and the [16, D] fp32 accumulator.
//   * Per 64-key tile: K and V are copied to shared memory with 16-byte
//     loads; S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32 out), B
//     fragments read as 32-bit words from row-major K (conflict-free with
//     the +8 padding); P is rounded to bf16 and reused in registers as the
//     A operand of P V (the accumulator layout of an m16n8 tile is the A
//     layout of an m16k16 one); V's B fragments come from ldmatrix.trans.
//   * The optional LSE write (lse != nullptr) makes one kernel serve both
//     TPU functions.
// Takes D in {32, 64, 128} and L a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;   // query rows per block
constexpr int kBK = 64;            // keys per tile
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ mask, int heads, int L, int causal,
                 float scale, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse) {
  constexpr int kS = D + 8;          // bf16 per shared row of K and V
  constexpr int kDT = D / 8;         // n8 tiles over D
  __shared__ __align__(16) __nv_bfloat16 k_sh[kBK * kS];
  __shared__ __align__(16) __nv_bfloat16 v_sh[kBK * kS];
  __shared__ int m_sh[kBK];

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(bh) * L * D;
  const int row0 = qt * kBQ + warp * 16;   // this warp's first query row

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = q + base + static_cast<int64_t>(row0 + g) * D +
                              kk * 16 + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * D;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float acc[kDT][4];
#pragma unroll
  for (int nd = 0; nd < kDT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m_run[2] = {kMaskVal, kMaskVal};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};             // this thread's columns only

  // with kBQ == kBK, key tile kt has a key at or below the diagonal of query
  // tile qt exactly when kt <= qt
  const int n_kt = causal ? qt + 1 : L / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBK * (D / 8); idx += kThreads) {
      const int r = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
      const int64_t off = base + static_cast<int64_t>(kt * kBK + r) * D + c8;
      *reinterpret_cast<uint4*>(k_sh + r * kS + c8) =
          *reinterpret_cast<const uint4*>(k + off);
      *reinterpret_cast<uint4*>(v_sh + r * kS + c8) =
          *reinterpret_cast<const uint4*>(v + off);
    }
    for (int idx = threadIdx.x; idx < kBK; idx += kThreads)
      m_sh[idx] = mask[static_cast<int64_t>(b) * L + kt * kBK + idx];
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 n8 tiles
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kr = k_sh + (nt * 8 + g) * kS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b0, b1);
      }
    }

    // scale, mask, row max; element e of tile nt: row g + 8*(e/2), key
    // nt*8 + 2t + (e%2)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (m_sh[kl] <= 0) x = kMaskVal;
        if (causal && kt * kBK + kl > row0 + g + (e >> 1) * 8) x = kMaskVal;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = __expf(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int nd = 0; nd < kDT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

    // p = exp(s - m) in fp32 for the sum, rounded to bf16 for P V
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(s[nt][e] - m_run[e >> 1]);
        l_run[e >> 1] += p[e];
      }
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16x2(p[0], p[1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }

    // acc += P V: k16 steps over keys, n8 tiles over D
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const __nv_bfloat16* vr = v_sh + (kk * 16 + (lane & 15)) * kS;
#pragma unroll
      for (int nd = 0; nd < kDT; ++nd) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + nd * 8);
        // A: (row g, keys 2t..) (row g+8, keys 2t..) (row g, keys 8+2t..)
        // (row g+8, keys 8+2t..)
        mma_bf16(acc[nd], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], b0, b1);
      }
    }
  }

  float l_fin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_fin[h] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    __nv_bfloat16* orow = o + base + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kDT; ++nd)
      *reinterpret_cast<uint32_t*>(orow + nd * 8) =
          pack_bf16x2(acc[nd][2 * h] / l_fin[h], acc[nd][2 * h + 1] / l_fin[h]);
    if (lse != nullptr && t == 0)
      lse[static_cast<int64_t>(bh) * L + row] = m_run[h] + logf(l_fin[h]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           int bh, int heads, int L, int causal, void* o, float* lse,
           cudaStream_t st) {
  const dim3 grid(L / kBQ, bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, heads, L, causal,
      1.0f / sqrtf(static_cast<float>(D)), static_cast<__nv_bfloat16*>(o),
      lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Query and key rows per tile: L must be a multiple of this.
int flash_attention_tile() { return kBQ; }

// q, k, v, o [bh, L, d] bf16; mask [bh / heads, L] int32 (> 0 = real key);
// lse [bh, L] f32 or null. Returns the CUDA error code of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* mask, int bh, int heads, int L, int d,
                        int causal, void* o, float* lse, void* stream) {
  if (bh < 1 || heads < 1 || bh % heads != 0 || L < kBQ || L % kBQ != 0)
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
