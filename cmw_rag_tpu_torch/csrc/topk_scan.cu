// Exact scan top-k with int8 queries over an int8 corpus, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cmw_rag_tpu/ops/topk.py:290 topk_pallas_int8mxu
// (body _fused_topk_int8mxu_kernel :255). The flat scans with bf16 queries
// (topk.py:164 topk_pallas, :210 topk_pallas_int8) run on the persistent
// scan and exact selection of csrc/ivf_scan.cu; this kernel is reached
// only from tests, as in the JAX package.
//
// Function: the queries are quantized per row by the wrapper
// (quantize_rows_int8, outside the kernel as in the JAX package); scores
// [q, n] = (float(acc) * q_scale[q]) * scale[n], where acc is the int8 x
// int8 dot product with an exact int32 sum (at most 5,120 x 127^2 =
// 8.3e7), the TPU kernel's order; rows with id < 0 never surface; each
// query keeps its k best rows ordered by (score descending, id ascending);
// slots with no valid row hold (-3e38, -1). The [Q, N] score matrix never
// reaches device memory.
//
// What bounds it: the int8 corpus and its scales, N * (D + 8) bytes,
// against 2*Q*N*D operations; at Q <= 32 and D = 5120 that is far under
// the H100's ~590 int8 operations a byte, so the scan is bound by
// device-memory bandwidth.
//
// Design (simple; its redesign on the TMA-fed scan is later work):
//   * Launch 1 (scan_kernel): a grid of (row blocks x query groups of 32).
//     Each block walks a contiguous range of 256-row tiles. Its 8 warps each
//     own 32 rows (two m16 tiles) and compute the 32 x 32 score tile with
//     mma.sync m16n8k32 (s8 in, s32 accumulate), corpus fragments read
//     straight from device memory 8 bytes at a time: a thread loads 8
//     consecutive bytes of a row, the first 4 as logical k 4t..4t+3 and the
//     next 4 as 4t+16..4t+19, for both operands. The int8 query block is
//     staged over D in 256-column chunks in shared memory.
//   * The score tile goes to shared memory; one warp per query folds it into
//     that query's running top-k (sorted in shared memory) under a threshold
//     gate: a row is inserted only if it beats the current k-th entry.
//   * Each block writes its sorted partial lists to [n_blocks, Q, k].
//   * k > 128 (kLarge): each query's running list lives in global memory,
//     in the [n_blocks, Q, k] partial buffer itself and a second buffer of
//     the same shape, used in turn. A tile's candidates are compacted in
//     shared memory; every candidate and every running entry computes its
//     rank in the union and those with rank < k are written to the other
//     buffer.
//   * Launch 2 (merge_kernel): one block per query does a k-way merge of the
//     n_blocks sorted lists. Order is by (score, id) alone, so the result
//     does not depend on block scheduling.
// Ids must be unique (the pipeline passes row slots).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 32;                      // queries per block: 4 n8 tiles
constexpr int kNT = kQT / 8;
constexpr int kMT = 2;                       // m16 tiles per warp
constexpr int kRows = kWarps * kMT * 16;     // 256 rows per tile
constexpr int kDC = 256;                     // query columns staged per chunk
constexpr int kQStride = kDC + 32;           // staged row stride
constexpr int kScStride = kRows + 4;         // floats per score row
constexpr int kMaxK = 128;                  // largest k kept in shared memory
constexpr int kMergeLists = 4 * kThreads;    // lists one merge block handles
constexpr float kNegInf = -3.0e38f;

// (score desc, id asc); an entry with id < 0 ranks below every valid one.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  if (i2 < 0) return i1 >= 0;
  if (i1 < 0) return false;
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8 consecutive int8 values of `row` from column `col`, raw (zeros past the
// last row or column).
__device__ __forceinline__ uint2 load_raw8(const int8_t* corpus, int64_t row,
                                           int col, int64_t n, int d) {
  if (row < n && col < d)
    return __ldg(reinterpret_cast<const uint2*>(corpus + row * d + col));
  return make_uint2(0u, 0u);
}

// Large-k fold of one tile into query qc's running list (one warp): rs/ri
// is the current sorted list of k entries, ns/ni receives the merged one.
// cs/ci is this warp's candidate staging area (kRows entries).
__device__ __forceinline__ void fold_large(
    const float* sc_row, int64_t row0, int64_t n, const int* ids, int k,
    const float* rs, const int* ri, float* ns, int* ni, float* cs, int* ci,
    int lane) {
  const float th_s = rs[k - 1];
  const int th_i = ri[k - 1];
  int nc = 0;
  for (int base = 0; base < kRows; base += 32) {
    const int64_t r = row0 + base + lane;
    const float s = sc_row[base + lane];
    const int id = r < n ? ids[r] : -1;
    const bool cand = id >= 0 && s > 0.5f * kNegInf &&
                      better(s, id, th_s, th_i);
    const unsigned m = __ballot_sync(0xffffffffu, cand);
    if (cand) {
      const int p = nc + __popc(m & ((1u << lane) - 1u));
      cs[p] = s;
      ci[p] = id;
    }
    nc += __popc(m);
  }
  __syncwarp();
  // candidates: rank = #better candidates + #better running entries
  for (int j = lane; j < nc; j += 32) {
    const float s = cs[j];
    const int id = ci[j];
    int r = 0;
    for (int u = 0; u < nc; ++u) r += better(cs[u], ci[u], s, id) ? 1 : 0;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(rs[mid], ri[mid], s, id)) lo = mid + 1; else hi = mid;
    }
    r += lo;
    if (r < k) { ns[r] = s; ni[r] = id; }
  }
  // running entries: rank = own index + #better candidates
  for (int j = lane; j < k; j += 32) {
    const float s = rs[j];
    const int id = ri[j];
    int r = j;
    for (int u = 0; u < nc && r < k; ++u)
      r += better(cs[u], ci[u], s, id) ? 1 : 0;
    if (r < k) { ns[r] = s; ni[r] = id; }
  }
  __syncwarp();
}

// int8 queries [nq, d] with float32 row scales q_scale over an int8
// corpus [n, d] with float32 row scales.
template <bool kLarge>
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const int8_t* __restrict__ queries8,
            const int8_t* __restrict__ corpus, const float* __restrict__ scales,
            const int* __restrict__ ids, int nq, int64_t n, int d, int k,
            float* part_s, int* part_i, float* alt_s, int* alt_i,
            const float* __restrict__ q_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* q8_sh = reinterpret_cast<int8_t*>(smem);  // [kQT][kQStride]
  float* sc = reinterpret_cast<float*>(smem + kQT * kQStride * 2);
  // small k: sorted running lists [kQT, k]; large k: candidate staging
  // [kWarps, kRows] (the running lists are in part_* / alt_*)
  float* run_s = sc + kQT * kScStride;
  int* run_i = reinterpret_cast<int*>(run_s + (kLarge ? kWarps * kRows : kQT * k));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * kQT;
  const int nqb = min(kQT, nq - q0);
  const int64_t n_tiles = (n + kRows - 1) / kRows;
  const int64_t tile_begin = n_tiles * blockIdx.x / gridDim.x;
  const int64_t tile_end = n_tiles * (blockIdx.x + 1) / gridDim.x;

  // bit qc / kWarps: the running list of query qc is in alt_* (large k)
  unsigned parity = 0;
  if constexpr (kLarge) {
    for (int qc = warp; qc < nqb; qc += kWarps) {
      const int64_t o = (static_cast<int64_t>(blockIdx.x) * nq + q0 + qc) * k;
      for (int j = lane; j < k; j += 32) {
        part_s[o + j] = kNegInf;
        part_i[o + j] = -1;
      }
    }
    __syncwarp();
  } else {
    for (int i = threadIdx.x; i < kQT * k; i += kThreads) {
      run_s[i] = kNegInf;
      run_i[i] = -1;
    }
  }

  for (int64_t tile = tile_begin; tile < tile_end; ++tile) {
    const int64_t row0 = tile * kRows + warp * (kMT * 16);
    int acc[kMT][kNT][4];   // exact int32 sums
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

    for (int dc = 0; dc < d; dc += kDC) {
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      for (int v = threadIdx.x; v < kQT * (kDC / 8); v += kThreads) {
        const int qr = v / (kDC / 8), c8 = (v % (kDC / 8)) * 8;
        uint2 val = make_uint2(0u, 0u);
        if (qr < nqb && dc + c8 < d)
          val = *reinterpret_cast<const uint2*>(
              queries8 + static_cast<int64_t>(q0 + qr) * d + dc + c8);
        *reinterpret_cast<uint2*>(q8_sh + qr * kQStride + c8) = val;
      }
      __syncthreads();
      const int width = min(kDC, d - dc);
#pragma unroll 2
      for (int st = 0; st * 32 < width; ++st) {
        const int col = dc + st * 32 + t * 8;
        uint2 a[kMT][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = load_raw8(corpus, row0 + mt * 16 + g + h * 8, col, n,
                                 d);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              q8_sh + (nt * 8 + g) * kQStride + st * 32 + t * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            mma_s8(acc[mt][nt], a[mt][0].x, a[mt][1].x, a[mt][0].y,
                   a[mt][1].y, b.x, b.y);
        }
      }
    }

    // accumulator (row g [+8], query 2t [+1]) -> sc[query][local row]
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = warp * (kMT * 16) + mt * 16 + g + h * 8;
        const int64_t r = tile * kRows + rl;
        const float scale = r < n ? scales[r] : 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = nt * 8 + 2 * t + e;
            const float qs = qc < nqb ? q_scale[q0 + qc] : 0.f;
            sc[qc * kScStride + rl] =
                (static_cast<float>(acc[mt][nt][h * 2 + e]) * qs) * scale;
          }
      }
    __syncthreads();

    if constexpr (kLarge) {
      for (int qc = warp; qc < nqb; qc += kWarps) {
        const int64_t o =
            (static_cast<int64_t>(blockIdx.x) * nq + q0 + qc) * k;
        const unsigned bit = 1u << (qc / kWarps);
        const bool in_alt = (parity & bit) != 0;
        fold_large(sc + qc * kScStride, tile * kRows, n, ids, k,
                   (in_alt ? alt_s : part_s) + o, (in_alt ? alt_i : part_i) + o,
                   (in_alt ? part_s : alt_s) + o, (in_alt ? part_i : alt_i) + o,
                   run_s + warp * kRows, run_i + warp * kRows, lane);
        parity ^= bit;
      }
      continue;
    }

    // one warp per query: fold the tile into the sorted running top-k
    for (int qc = warp; qc < nqb; qc += kWarps) {
      float* rs = run_s + qc * k;
      int* ri = run_i + qc * k;
      for (int base = 0; base < kRows; base += 32) {
        const int64_t r = tile * kRows + base + lane;
        const float s = sc[qc * kScStride + base + lane];
        const int id = r < n ? ids[r] : -1;
        const bool cand = id >= 0 && s > 0.5f * kNegInf &&
                          better(s, id, rs[k - 1], ri[k - 1]);
        unsigned todo = __ballot_sync(0xffffffffu, cand);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const float cs = __shfl_sync(0xffffffffu, s, src);
          const int cid = __shfl_sync(0xffffffffu, id, src);
          if (!better(cs, cid, rs[k - 1], ri[k - 1])) continue;  // warp-uniform
          int pos = 0;
          for (int j0 = 0; j0 < k; j0 += 32) {
            const int j = j0 + lane;
            pos += __popc(__ballot_sync(
                0xffffffffu, j < k && better(rs[j], ri[j], cs, cid)));
          }
          float mv_s[kMaxK / 32];
          int mv_i[kMaxK / 32];
#pragma unroll
          for (int u = 0; u < kMaxK / 32; ++u) {
            const int j = lane + 32 * u;
            if (j >= pos && j < k - 1) { mv_s[u] = rs[j]; mv_i[u] = ri[j]; }
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < kMaxK / 32; ++u) {
            const int j = lane + 32 * u;
            if (j >= pos && j < k - 1) { rs[j + 1] = mv_s[u]; ri[j + 1] = mv_i[u]; }
          }
          __syncwarp();
          if (lane == 0) { rs[pos] = cs; ri[pos] = cid; }
          __syncwarp();
        }
      }
    }
  }

  if constexpr (kLarge) {
    // lists that ended in alt_* move to part_*, where the merge reads them
    for (int qc = warp; qc < nqb; qc += kWarps) {
      if (!(parity & (1u << (qc / kWarps)))) continue;
      const int64_t o = (static_cast<int64_t>(blockIdx.x) * nq + q0 + qc) * k;
      for (int j = lane; j < k; j += 32) {
        part_s[o + j] = alt_s[o + j];
        part_i[o + j] = alt_i[o + j];
      }
    }
    return;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nqb * k; i += kThreads) {
    const int qc = i / k, j = i % k;
    const int64_t o = (static_cast<int64_t>(blockIdx.x) * nq + q0 + qc) * k + j;
    part_s[o] = run_s[qc * k + j];
    part_i[o] = run_i[qc * k + j];
  }
}

// One block per query: k-way merge of n_lists sorted lists of length k.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             int n_lists, int nq, int k, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  constexpr int kLPT = kMergeLists / kThreads;
  __shared__ float ws[kWarps];
  __shared__ int wi[kWarps], wl[kWarps];
  __shared__ int winner;
  const int q = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int ptr[kLPT];
  float hs[kLPT];
  int hi[kLPT];
#pragma unroll
  for (int u = 0; u < kLPT; ++u) {
    const int l = threadIdx.x + u * kThreads;
    ptr[u] = 0;
    hs[u] = kNegInf;
    hi[u] = -1;
    if (l < n_lists) {
      const int64_t o = (static_cast<int64_t>(l) * nq + q) * k;
      hs[u] = part_s[o];
      hi[u] = part_i[o];
    }
  }
  for (int j = 0; j < k; ++j) {
    float bs = kNegInf;
    int bi = -1, bl = -1;
#pragma unroll
    for (int u = 0; u < kLPT; ++u)
      if (better(hs[u], hi[u], bs, bi)) {
        bs = hs[u]; bi = hi[u]; bl = threadIdx.x + u * kThreads;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; bl = ol; }
    }
    if (lane == 0) { ws[warp] = bs; wi[warp] = bi; wl[warp] = bl; }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = ws[0];
      int i = wi[0], l = wl[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(ws[w], wi[w], s, i)) { s = ws[w]; i = wi[w]; l = wl[w]; }
      out_s[static_cast<int64_t>(q) * k + j] = i >= 0 ? s : kNegInf;
      out_i[static_cast<int64_t>(q) * k + j] = i;
      winner = i >= 0 ? l : -1;
    }
    __syncthreads();
    const int wlst = winner;
#pragma unroll
    for (int u = 0; u < kLPT; ++u)
      if (threadIdx.x + u * kThreads == wlst) {
        ++ptr[u];
        hs[u] = kNegInf;
        hi[u] = -1;
        if (ptr[u] < k) {
          const int64_t o = (static_cast<int64_t>(wlst) * nq + q) * k + ptr[u];
          hs[u] = part_s[o];
          hi[u] = part_i[o];
        }
      }
  }
}

size_t scan_smem_bytes(int k) {
  const int run = k > kMaxK ? kWarps * kRows : kQT * k;
  return static_cast<size_t>(kQT) * kQStride * 2 +
         static_cast<size_t>(kQT) * kScStride * 4 +
         static_cast<size_t>(run) * 8;
}

template <bool kLarge>
cudaError_t launch_scan(const int8_t* queries, const int8_t* corpus,
                        const float* scales, const int* ids, int nq,
                        long long n, int d, int k, int n_blocks, float* part_s,
                        int* part_i, float* alt_s, int* alt_i,
                        const float* q_scale, cudaStream_t st) {
  const size_t smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<kLarge>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (nq + kQT - 1) / kQT);
  scan_kernel<kLarge><<<grid, kThreads, smem, st>>>(
      queries, corpus, scales, ids, nq, static_cast<int64_t>(n), d, k, part_s,
      part_i, alt_s, alt_i, q_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per scan tile, the most partial lists the merge takes, and the
// largest k whose running lists stay in shared memory: the wrapper sizes the
// [n_blocks, Q, k] partial buffers from these, and passes a second buffer
// of that shape (alt_*) when k is larger (else null).
int topk_scan_tile_rows() { return kRows; }
int topk_scan_max_blocks() { return kMergeLists; }
int topk_scan_max_shared_k() { return kMaxK; }

// int8 queries [nq, d] with float32 row scales q_scale [nq] (quantized by
// the caller) over an int8 corpus [n, d] with f32 row scales [n], ids [n]
// int32 -> out_s [nq, k] f32, out_i [nq, k] int32, any k >= 1. Returns the
// CUDA error code of the launches.
int topk_scan_int8q(const void* queries, const void* corpus,
                    const float* q_scale, const float* scales, const int* ids,
                    int nq, long long n, int d, int k, int n_blocks,
                    float* part_s, int* part_i, float* alt_s, int* alt_i,
                    float* out_s, int* out_i, void* stream) {
  if (nq < 1 || n < 1 || d < 8 || d % 8 != 0 || k < 1 ||
      n_blocks < 1 || n_blocks > kMergeLists ||
      (k > kMaxK && (alt_s == nullptr || alt_i == nullptr)) ||
      q_scale == nullptr || scales == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* q8 = static_cast<const int8_t*>(queries);
  const int8_t* c8 = static_cast<const int8_t*>(corpus);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      k > kMaxK
          ? launch_scan<true>(q8, c8, scales, ids, nq, n, d, k, n_blocks,
                              part_s, part_i, alt_s, alt_i, q_scale, st)
          : launch_scan<false>(q8, c8, scales, ids, nq, n, d, k, n_blocks,
                               part_s, part_i, alt_s, alt_i, q_scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<nq, kThreads, 0, st>>>(part_s, part_i, n_blocks, nq, k,
                                        out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
