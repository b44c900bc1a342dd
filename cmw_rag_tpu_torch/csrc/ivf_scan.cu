// Exact top-k over a table of IVF blocks, bf16 or int8 corpus, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of cmw_rag_tpu/ops/ivf_scan.py:
//   :95  ivf_probed_scan       (_ivf_kernel :29)
//   :567 ivf_probed_scan_int8  (_ivf_int8_kernel :507)
//   :340 ivf_union_scan        (_ivf_union_kernel :282)
//   :452 ivf_union_scan_int8   (_ivf_union_int8_kernel :394)
// All four compute one function, so they are one kernel template over a
// block table: the union kernels give one row of block indices that every
// query scans (its first n_valid entries); the probed kernels give one row
// per query.
//
// Function: the corpus is n_blocks blocks of block_n rows. For each query,
// scores = <query, row> accumulated in fp32 over the rows of the blocks in
// its table row (int8 rows are upcast to bf16 and the product is multiplied
// by the row's f32 scale); rows with id < 0 never surface; a block listed
// twice gives its rows once; the k best rows are kept in (score descending,
// id ascending) order, exactly, over all rows scanned; slots with no valid
// row hold (-3e38, -1). A block index outside [0, n_blocks) scans nothing.
// (The TPU union kernel merges a block only when some score in the whole
// [Q, block_n] tile beats that query's k-th score, so a row that exactly
// ties the k-th score with a smaller id in a later block is kept out; this
// kernel keeps it, as the exact order demands.)
//
// What bounds it: every row read is read once, rows x (2D + 4) bytes for
// bf16 and rows x (D + 8) for int8 (row, scale, id), against 2*Q*rows*D
// operations. With Q <= 32 that is at most ~32 operations per byte, far
// under the H100's ~295, so the scan is bound by device-memory bandwidth.
// At Q = 1 a CTA reads one or two 512 KB tiles, so the latency of those
// reads, not the bandwidth, is what this simple design leaves exposed.
//
// Design: the structure of csrc/topk_scan.cu, with tiles reached through
// the table instead of by address.
//   * Launch 1 (ivf_scan_kernel): a grid of (CTAs x query groups). A group
//     is 32 queries sharing the union table row, or one query with its own
//     probed row (the m16n8k16 tile then wastes 31 of 32 query columns:
//     acceptable, the kernel waits on bytes). A block is ceil(block_n / 256)
//     tiles of 256 rows, the last masked at block_n; each CTA walks a
//     contiguous range of the group's (entry, tile) pairs, loading each
//     entry's block index itself. Its 8 warps each own 32 rows and compute
//     the 32 x 32 score tile with mma.sync (bf16 in, fp32 accumulate),
//     corpus fragments read straight from device memory with 16-byte loads
//     (8-byte for int8) and the query block staged in shared memory over D
//     in 256-column chunks.
//   * One warp per query folds the tile into that query's running top-k
//     (sorted, in shared memory) under a threshold gate: only a row that
//     beats the current k-th entry is inserted. An id already in the list
//     is skipped, so a repeated block adds nothing.
//   * k > 128 (kLarge): the running lists live in global memory, in the
//     [n_ctas, Q, k] partial buffer and a second buffer of that shape used
//     in turn; a tile's candidates are compacted in shared memory and every
//     entry computes its rank in the union (see topk_scan.cu). A candidate
//     equal to a running entry (same score and id: a repeated block scores
//     the same row with the same instructions) is dropped first.
//   * Launch 2 (merge_kernel): one block per query merges the n_ctas sorted
//     lists, skipping an entry equal to the one it just emitted (the same
//     row reached from a repeated block in another CTA).
// Ids must be unique across the corpus (the index stores row ids). The
// source is self-contained: its helpers repeat topk_scan.cu's (the
// tile loads take a row mask, the folds and the merge skip repeats), so
// neither library's build depends on the other's source.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = 32;                      // queries per group: 4 n8 tiles
constexpr int kNT = kQT / 8;
constexpr int kMT = 2;                       // m16 tiles per warp
constexpr int kRows = kWarps * kMT * 16;     // 256 rows per tile
constexpr int kDC = 256;                     // query columns staged per chunk
constexpr int kQStride = kDC + 32;           // bf16 per staged row (+64 B)
constexpr int kScStride = kRows + 4;         // floats per score row
constexpr int kMaxK = 128;                   // largest k kept in shared memory
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive values of corpus row `row` from column `col` as 4 bf16x2
// words, zeros unless `ok` and col < d. D % 8 == 0 keeps loads aligned.
__device__ __forceinline__ void load_row8(const __nv_bfloat16* corpus,
                                          int64_t row, int col, bool ok, int d,
                                          uint32_t (&w)[4]) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok && col < d)
    v = __ldg(reinterpret_cast<const uint4*>(corpus + row * d + col));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void load_row8(const int8_t* corpus, int64_t row,
                                          int col, bool ok, int d,
                                          uint32_t (&w)[4]) {
  uint2 v = make_uint2(0u, 0u);
  if (ok && col < d)
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

// Index of the first entry of the sorted list rs/ri (length k) that is not
// better than (s, id).
__device__ __forceinline__ int lower_rank(const float* rs, const int* ri,
                                          int k, float s, int id) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(rs[mid], ri[mid], s, id)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Large-k fold of one tile into one query's running list (one warp): rs/ri
// is the current sorted list of k entries, ns/ni receives the merged one.
// cs/ci is this warp's candidate staging area (kRows entries). tile_ids
// holds the tile's ids (-1 past the block's end).
__device__ __forceinline__ void fold_large(
    const float* sc_row, const int* tile_ids, int k, const float* rs,
    const int* ri, float* ns, int* ni, float* cs, int* ci, int lane) {
  const float th_s = rs[k - 1];
  const int th_i = ri[k - 1];
  int nc = 0;
  for (int base = 0; base < kRows; base += 32) {
    const float s = sc_row[base + lane];
    const int id = tile_ids[base + lane];
    bool cand = id >= 0 && s > 0.5f * kNegInf && better(s, id, th_s, th_i);
    if (cand) {  // a row already in the list (a repeated block) is no candidate
      const int at = lower_rank(rs, ri, k, s, id);
      cand = !(at < k && ri[at] == id && rs[at] == s);
    }
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
    r += lower_rank(rs, ri, k, s, id);
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

template <typename T, bool kLarge>
__global__ void __launch_bounds__(kThreads, 2)
ivf_scan_kernel(const __nv_bfloat16* __restrict__ queries,
                const T* __restrict__ corpus, const float* __restrict__ scales,
                const int* __restrict__ ids, const int* __restrict__ table,
                int table_cols, int per_query, const int* __restrict__ n_valid,
                int nq, int n_blocks, int d, int block_n, int k,
                float* part_s, int* part_i, float* alt_s, int* alt_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_sh = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sc = reinterpret_cast<float*>(smem + kQT * kQStride * 2);
  int* tid_sh = reinterpret_cast<int*>(sc + kQT * kScStride);  // tile ids
  // small k: sorted running lists [kQT, k]; large k: candidate staging
  // [kWarps, kRows] (the running lists are in part_* / alt_*)
  float* run_s = reinterpret_cast<float*>(tid_sh + kRows);
  int* run_i = reinterpret_cast<int*>(run_s + (kLarge ? kWarps * kRows : kQT * k));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = per_query ? blockIdx.y : blockIdx.y * kQT;
  const int nqb = per_query ? 1 : min(kQT, nq - q0);
  const int* row = table + (per_query ? static_cast<int64_t>(blockIdx.y) * table_cols : 0);
  int cols = table_cols;
  if (n_valid != nullptr) cols = max(0, min(cols, *n_valid));
  const int tpb = (block_n + kRows - 1) / kRows;       // tiles per block
  const int64_t n_tiles = static_cast<int64_t>(cols) * tpb;
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
    const int blk = row[tile / tpb];
    if (blk < 0 || blk >= n_blocks) continue;          // uniform over the CTA
    const int sub = static_cast<int>(tile % tpb) * kRows;
    const int lim = min(kRows, block_n - sub);         // rows of this tile
    const int64_t tile_row0 = static_cast<int64_t>(blk) * block_n + sub;
    const int rw0 = warp * (kMT * 16);                 // this warp's rows
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

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
      if (dc == 0)
        for (int r = threadIdx.x; r < kRows; r += kThreads)
          tid_sh[r] = r < lim ? ids[tile_row0 + r] : -1;
      __syncthreads();
      const int width = min(kDC, d - dc);
#pragma unroll 2
      for (int s = 0; s * 32 < width; ++s) {
        const int col = dc + s * 32 + t * 8;
        uint32_t a[kMT][2][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = rw0 + mt * 16 + g + h * 8;
            load_row8(corpus, tile_row0 + rl, col, rl < lim, d, a[mt][h]);
          }
        uint32_t b[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              q_sh + (nt * 8 + g) * kQStride + s * 32 + t * 8);
          b[nt][0] = v.x; b[nt][1] = v.y; b[nt][2] = v.z; b[nt][3] = v.w;
        }
        // Logical k (2t+e) <-> physical column 8t+e and (8+2t+e) <-> 8t+2+e
        // in the first mma; +4 physical columns in the second. The same
        // permutation on both operands leaves every dot product unchanged.
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

    // accumulator (row g [+8], query 2t [+1]) -> sc[query][local row]
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rw0 + mt * 16 + g + h * 8;
        float scale = 1.f;
        if (scales != nullptr) scale = rl < lim ? scales[tile_row0 + rl] : 0.f;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sc[(nt * 8 + 2 * t + e) * kScStride + rl] =
                acc[mt][nt][h * 2 + e] * scale;
      }
    __syncthreads();

    if constexpr (kLarge) {
      for (int qc = warp; qc < nqb; qc += kWarps) {
        const int64_t o =
            (static_cast<int64_t>(blockIdx.x) * nq + q0 + qc) * k;
        const unsigned bit = 1u << (qc / kWarps);
        const bool in_alt = (parity & bit) != 0;
        fold_large(sc + qc * kScStride, tid_sh, k,
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
        const float s = sc[qc * kScStride + base + lane];
        const int id = tid_sh[base + lane];
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
          bool dup = false;
          for (int j0 = 0; j0 < k; j0 += 32) {
            const int j = j0 + lane;
            pos += __popc(__ballot_sync(
                0xffffffffu, j < k && better(rs[j], ri[j], cs, cid)));
            dup |= __any_sync(0xffffffffu, j < k && ri[j] == cid);
          }
          if (dup) continue;  // warp-uniform: a repeated block's row
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

// One block per query: k-way merge of n_lists sorted lists of length k; an
// entry equal to the one just emitted (a repeated block's row that another
// CTA also kept) is consumed without being emitted.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             int n_lists, int nq, int k, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  constexpr int kLPT = kMergeLists / kThreads;
  __shared__ float ws[kWarps];
  __shared__ int wi[kWarps], wl[kWarps];
  __shared__ int winner, emitted;
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
  float last_s = 0.f;
  int last_i = -1;
  for (int j = 0; j < k;) {
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
      const bool again = i >= 0 && i == last_i && s == last_s;
      if (!again) {
        out_s[static_cast<int64_t>(q) * k + j] = i >= 0 ? s : kNegInf;
        out_i[static_cast<int64_t>(q) * k + j] = i;
        last_s = s;
        last_i = i;
      }
      emitted = again ? 0 : 1;
      winner = i >= 0 ? l : -1;
    }
    __syncthreads();
    const int wlst = winner;
    j += emitted;
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
         static_cast<size_t>(kRows) * 4 + static_cast<size_t>(run) * 8;
}

template <typename T, bool kLarge>
cudaError_t launch_scan(const void* queries, const T* corpus,
                        const float* scales, const int* ids, const int* table,
                        int table_cols, int per_query, const int* n_valid,
                        int nq, int n_blocks, int d, int block_n, int k,
                        int n_ctas, float* part_s, int* part_i, float* alt_s,
                        int* alt_i, cudaStream_t st) {
  const size_t smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel<T, kLarge>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_ctas, per_query ? nq : (nq + kQT - 1) / kQT);
  ivf_scan_kernel<T, kLarge><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(queries), corpus, scales, ids, table,
      table_cols, per_query, n_valid, nq, n_blocks, d, block_n, k, part_s,
      part_i, alt_s, alt_i);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* queries, const T* corpus, const float* scales,
           const int* ids, const int* table, int table_cols, int per_query,
           const int* n_valid, int nq, int n_blocks, int d, int block_n, int k,
           int n_ctas, float* part_s, int* part_i, float* alt_s, int* alt_i,
           float* out_s, int* out_i, void* stream) {
  if (nq < 1 || n_blocks < 1 || block_n < 1 || table_cols < 1 || d < 8 ||
      d % 8 != 0 || k < 1 || n_ctas < 1 || n_ctas > kMergeLists ||
      (per_query && nq > 65535) ||
      (k > kMaxK && (alt_s == nullptr || alt_i == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      k > kMaxK
          ? launch_scan<T, true>(queries, corpus, scales, ids, table,
                                 table_cols, per_query, n_valid, nq, n_blocks,
                                 d, block_n, k, n_ctas, part_s, part_i, alt_s,
                                 alt_i, st)
          : launch_scan<T, false>(queries, corpus, scales, ids, table,
                                  table_cols, per_query, n_valid, nq, n_blocks,
                                  d, block_n, k, n_ctas, part_s, part_i, alt_s,
                                  alt_i, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<nq, kThreads, 0, st>>>(part_s, part_i, n_ctas, nq, k, out_s,
                                        out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per tile, the most partial lists the merge takes, and the largest k
// whose running lists stay in shared memory: the wrapper sizes the
// [n_ctas, Q, k] partial buffers from these, and passes a second buffer of
// that shape (alt_*) when k is larger (else null).
int ivf_scan_tile_rows() { return kRows; }
int ivf_scan_max_ctas() { return kMergeLists; }
int ivf_scan_max_shared_k() { return kMaxK; }

// queries [nq, d] bf16; corpus [n_blocks * block_n, d] bf16; ids
// [n_blocks * block_n] int32; table [per_query ? nq : 1, table_cols] int32
// block indices; n_valid: null, or a device int32 that limits every table
// row to its first n_valid entries -> out_s [nq, k] f32, out_i [nq, k]
// int32, any k >= 1. Returns the CUDA error code of the launches.
int ivf_scan_bf16(const void* queries, const void* corpus, const int* ids,
                  const int* table, int table_cols, int per_query,
                  const int* n_valid, int nq, int n_blocks, int d, int block_n,
                  int k, int n_ctas, float* part_s, int* part_i, float* alt_s,
                  int* alt_i, float* out_s, int* out_i, void* stream) {
  return launch(queries, static_cast<const __nv_bfloat16*>(corpus), nullptr,
                ids, table, table_cols, per_query, n_valid, nq, n_blocks, d,
                block_n, k, n_ctas, part_s, part_i, alt_s, alt_i, out_s, out_i,
                stream);
}

// The same over an int8 corpus with f32 row scales [n_blocks * block_n].
int ivf_scan_int8(const void* queries, const void* corpus, const float* scales,
                  const int* ids, const int* table, int table_cols,
                  int per_query, const int* n_valid, int nq, int n_blocks,
                  int d, int block_n, int k, int n_ctas, float* part_s,
                  int* part_i, float* alt_s, int* alt_i, float* out_s,
                  int* out_i, void* stream) {
  return launch(queries, static_cast<const int8_t*>(corpus), scales, ids,
                table, table_cols, per_query, n_valid, nq, n_blocks, d,
                block_n, k, n_ctas, part_s, part_i, alt_s, alt_i, out_s, out_i,
                stream);
}

}  // extern "C"
