// Exact scan top-k over a bf16 or int8 corpus, for Hopper (sm_90a).
//
// Replaces the TPU kernels cmw_rag_tpu/ops/topk.py:164 topk_pallas
// (_fused_topk_kernel :97, merge _topk_merge_rounds :68) and
// cmw_rag_tpu/ops/topk.py:210 topk_pallas_int8 (_fused_topk_int8_kernel :131).
//
// Function: scores[q, n] = <queries[q], corpus[n]> accumulated in fp32
// (int8 rows are upcast to bf16 and the product is multiplied by the row's
// f32 scale); rows with id < 0 never surface; each query keeps its k best
// rows ordered by (score descending, id ascending); slots with no valid row
// hold (-3e38, -1). The [Q, N] score matrix never reaches device memory.
//
// What bounds it: the corpus is read once, 2*N*D bytes (bf16) or N*D + 4N
// (int8), against 2*Q*N*D operations; at the shipping shape (Q <= 32,
// D = 5120) that is ~32 operations per byte, far under the H100's ~295, so
// the scan is bound by device-memory bandwidth.
//
// Design (simple first; wgmma, TMA and a split-N persistent schedule are
// later work):
//   * Launch 1 (scan_kernel): a grid of (row blocks x query groups of 32).
//     Each block walks a contiguous range of 256-row tiles. Its 8 warps each
//     own 32 rows (two m16 tiles) and compute the 32 x 32 score tile with
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate). Corpus fragments are
//     read straight from device memory with 16-byte loads (8-byte for int8);
//     the K index inside each 32-wide step is permuted identically for both
//     operands, which leaves every dot product unchanged and lets a thread
//     load 8 consecutive elements of one row. The query block [32, D] does
//     not fit in shared memory (320 KB at D = 5120), so it is staged over D
//     in 256-column chunks, read from L2.
//   * The score tile goes to shared memory; one warp per query folds it into
//     that query's running top-k (sorted in shared memory) under a threshold
//     gate: a row is inserted only if it beats the current k-th entry, so
//     after warm-up almost no tile does any insertion work.
//   * Each block writes its sorted partial lists to [n_blocks, Q, k].
//   * k > 128 (kLarge): 32 running lists of k entries do not fit in shared
//     memory (256 KB at k = 1000), so each query's running list lives in
//     global memory, in the [n_blocks, Q, k] partial buffer itself and a
//     second buffer of the same shape, used in turn. A tile's candidates
//     (rows that beat the k-th entry) are compacted in shared memory; every
//     candidate and every running entry then computes its rank in the union
//     (a count over the candidates plus a binary search in the sorted list)
//     and those with rank < k are written to the other buffer. Ranks are
//     distinct because (score, id) order is total over unique ids and empty
//     entries keep their index order, so the write is a permutation.
//   * Launch 2 (merge_kernel): one block per query does a k-way merge of the
//     n_blocks sorted lists. Order is by (score, id) alone, so the result
//     does not depend on block scheduling.
// Ids must be unique (the pipeline passes row slots).
//
// int8 queries (topk_scan_int8mxu). Replaces cmw_rag_tpu/ops/topk.py:290
// topk_pallas_int8mxu (body _fused_topk_int8mxu_kernel :255): the queries
// are quantized per row by the wrapper (quantize_rows_int8, outside the
// kernel as in the JAX package), the product is int8 x int8 with an exact
// int32 sum (at most 5,120 x 127^2 = 8.3e7), and the score is
// (float(acc) * q_scale[q]) * scale[n], the TPU kernel's order. The same
// schedule as above, with the int8 query chunk staged in shared memory and
// one mma.sync m16n8k32 (s8 in, s32 accumulate) per 32-wide step: a thread
// loads 8 consecutive bytes of a row, the first 4 as logical k 4t..4t+3 and
// the next 4 as 4t+16..4t+19, for both operands. Bound: the int8 corpus
// and its scales, N * (D + 8) bytes, as the bf16-query int8 scan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 32;                      // queries per block: 4 n8 tiles
constexpr int kNT = kQT / 8;
constexpr int kMT = 2;                       // m16 tiles per warp
constexpr int kRows = kWarps * kMT * 16;     // 256 rows per tile
constexpr int kDC = 256;                     // query columns staged per chunk
constexpr int kQStride = kDC + 32;           // bf16 per staged row (+64 B)
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive corpus values of `row` from column `col`, as 4 bf16x2 words
// (zeros past the last row or column). D % 8 == 0 keeps loads aligned.
__device__ __forceinline__ void load_row8(const __nv_bfloat16* corpus,
                                          int64_t row, int col, int64_t n,
                                          int d, uint32_t (&w)[4]) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < n && col < d)
    v = __ldg(reinterpret_cast<const uint4*>(corpus + row * d + col));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void load_row8(const int8_t* corpus, int64_t row,
                                          int col, int64_t n, int d,
                                          uint32_t (&w)[4]) {
  uint2 v = make_uint2(0u, 0u);
  if (row < n && col < d)
    v = __ldg(reinterpret_cast<const uint2*>(corpus + row * d + col));
  const uint32_t u[2] = {v.x, v.y};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float e0 = static_cast<float>(static_cast<int8_t>(u[h] & 0xffu));
    const float e1 = static_cast<float>(static_cast<int8_t>((u[h] >> 8) & 0xffu));
    const float e2 = static_cast<float>(static_cast<int8_t>((u[h] >> 16) & 0xffu));
    const float e3 = static_cast<float>(static_cast<int8_t>(u[h] >> 24));
    w[2 * h] = pack_bf16x2(e0, e1);
    w[2 * h + 1] = pack_bf16x2(e2, e3);
  }
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

// kI8Q: int8 queries [nq, d] with float32 row scales q_scale (T int8).
template <typename T, bool kLarge, bool kI8Q = false>
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const void* __restrict__ queries_v,
            const T* __restrict__ corpus, const float* __restrict__ scales,
            const int* __restrict__ ids, int nq, int64_t n, int d, int k,
            float* part_s, int* part_i, float* alt_s, int* alt_i,
            const float* __restrict__ q_scale = nullptr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const __nv_bfloat16* queries =
      static_cast<const __nv_bfloat16*>(queries_v);
  const int8_t* queries8 = static_cast<const int8_t*>(queries_v);
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* q8_sh = reinterpret_cast<int8_t*>(smem);  // kI8Q: [kQT][kQStride]
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
    // exact int32 sums for int8 queries, float32 otherwise
    using Acc = typename std::conditional<kI8Q, int, float>::type;
    Acc acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

    if constexpr (kI8Q) {
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
    } else {
      for (int dc = 0; dc < d; dc += kDC) {
        __syncthreads();  // the previous chunk's (and tile's) readers are done
        for (int v = threadIdx.x; v < kQT * (kDC / 8); v += kThreads) {
          const int qr = v / (kDC / 8), c8 = (v % (kDC / 8)) * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (qr < nqb && dc + c8 < d)
            val = *reinterpret_cast<const uint4*>(
                queries + static_cast<int64_t>(q0 + qr) * d + dc + c8);
          *reinterpret_cast<uint4*>(q_sh + qr * kQStride + c8) = val;
        }
        __syncthreads();
        const int width = min(kDC, d - dc);
#pragma unroll 2
        for (int s = 0; s * 32 < width; ++s) {
          const int col = dc + s * 32 + t * 8;
          uint32_t a[kMT][2][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              load_row8(corpus, row0 + mt * 16 + g + h * 8, col, n, d, a[mt][h]);
          uint32_t b[kNT][4];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                q_sh + (nt * 8 + g) * kQStride + s * 32 + t * 8);
            b[nt][0] = v.x; b[nt][1] = v.y; b[nt][2] = v.z; b[nt][3] = v.w;
          }
          // Logical k (2t+e) <-> physical column 8t+e and (8+2t+e) <-> 8t+2+e
          // in the first mma; +4 physical columns in the second.
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              mma_bf16(acc[mt][nt], a[mt][0][0], a[mt][1][0], a[mt][0][1],
                       a[mt][1][1], b[nt][0], b[nt][1]);
              mma_bf16(acc[mt][nt], a[mt][0][2], a[mt][1][2], a[mt][0][3],
                       a[mt][1][3], b[nt][2], b[nt][3]);
            }
        }
      }
    }

    // accumulator (row g [+8], query 2t [+1]) -> sc[query][local row]
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = warp * (kMT * 16) + mt * 16 + g + h * 8;
        float scale = 1.f;
        if (scales != nullptr) {
          const int64_t r = tile * kRows + rl;
          scale = r < n ? scales[r] : 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = nt * 8 + 2 * t + e;
            if constexpr (kI8Q) {
              const float qs = qc < nqb ? q_scale[q0 + qc] : 0.f;
              sc[qc * kScStride + rl] =
                  (static_cast<float>(acc[mt][nt][h * 2 + e]) * qs) * scale;
            } else {
              sc[qc * kScStride + rl] = acc[mt][nt][h * 2 + e] * scale;
            }
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

template <typename T, bool kLarge, bool kI8Q>
cudaError_t launch_scan(const void* queries, const T* corpus,
                        const float* scales, const int* ids, int nq,
                        long long n, int d, int k, int n_blocks, float* part_s,
                        int* part_i, float* alt_s, int* alt_i,
                        const float* q_scale, cudaStream_t st) {
  const size_t smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, kLarge, kI8Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (nq + kQT - 1) / kQT);
  scan_kernel<T, kLarge, kI8Q><<<grid, kThreads, smem, st>>>(
      queries, corpus, scales, ids, nq, static_cast<int64_t>(n), d, k, part_s,
      part_i, alt_s, alt_i, q_scale);
  return cudaGetLastError();
}

template <typename T, bool kI8Q = false>
int launch(const void* queries, const T* corpus, const float* scales,
           const int* ids, int nq, long long n, int d, int k, int n_blocks,
           float* part_s, int* part_i, float* alt_s, int* alt_i, float* out_s,
           int* out_i, void* stream, const float* q_scale = nullptr) {
  if (nq < 1 || n < 1 || d < 8 || d % 8 != 0 || k < 1 ||
      n_blocks < 1 || n_blocks > kMergeLists ||
      (k > kMaxK && (alt_s == nullptr || alt_i == nullptr)) ||
      (kI8Q && q_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      k > kMaxK
          ? launch_scan<T, true, kI8Q>(queries, corpus, scales, ids, nq, n, d,
                                       k, n_blocks, part_s, part_i, alt_s,
                                       alt_i, q_scale, st)
          : launch_scan<T, false, kI8Q>(queries, corpus, scales, ids, nq, n,
                                        d, k, n_blocks, part_s, part_i, alt_s,
                                        alt_i, q_scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<nq, kThreads, 0, st>>>(part_s, part_i, n_blocks, nq, k,
                                        out_s, out_i);
  return static_cast<int>(cudaGetLastError());
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

// queries [nq, d] bf16, corpus [n, d] bf16, ids [n] int32 -> out_s [nq, k]
// f32, out_i [nq, k] int32, any k >= 1. Returns the CUDA error code of the
// launches.
int topk_scan_bf16(const void* queries, const void* corpus, const int* ids,
                   int nq, long long n, int d, int k, int n_blocks,
                   float* part_s, int* part_i, float* alt_s, int* alt_i,
                   float* out_s, int* out_i, void* stream) {
  return launch(queries, static_cast<const __nv_bfloat16*>(corpus), nullptr,
                ids, nq, n, d, k, n_blocks, part_s, part_i, alt_s, alt_i,
                out_s, out_i, stream);
}

// The same over an int8 corpus [n, d] with f32 row scales [n].
int topk_scan_int8(const void* queries, const void* corpus,
                   const float* scales, const int* ids, int nq, long long n,
                   int d, int k, int n_blocks, float* part_s, int* part_i,
                   float* alt_s, int* alt_i, float* out_s, int* out_i,
                   void* stream) {
  return launch(queries, static_cast<const int8_t*>(corpus), scales, ids, nq,
                n, d, k, n_blocks, part_s, part_i, alt_s, alt_i, out_s, out_i,
                stream);
}

// int8 queries [nq, d] with float32 row scales q_scale [nq] (quantized by
// the caller) over an int8 corpus [n, d] with f32 row scales [n].
// Otherwise as topk_scan_int8.
int topk_scan_int8q(const void* queries, const void* corpus,
                    const float* q_scale, const float* scales, const int* ids,
                    int nq, long long n, int d, int k, int n_blocks,
                    float* part_s, int* part_i, float* alt_s, int* alt_i,
                    float* out_s, int* out_i, void* stream) {
  return launch<int8_t, true>(queries, static_cast<const int8_t*>(corpus),
                              scales, ids, nq, n, d, k, n_blocks, part_s,
                              part_i, alt_s, alt_i, out_s, out_i, stream,
                              q_scale);
}

}  // extern "C"
