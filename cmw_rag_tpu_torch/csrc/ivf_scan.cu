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
// under the H100's ~295, so the scan is bound by device-memory bandwidth;
// what it must add is the scores it hands to the selection (4 bytes a row
// and query, ~1.6% of the rows' bytes at Q 8 and D 1024, written to and
// read back from L2 where they fit).
//
// Design (two launches a chunk of at most kChunk = 64 queries, the chunks
// in turn, so that the candidate workspace holds one chunk's scores and
// does not grow with the batch; a chunk's two groups of 32 read the same
// tiles at about the same time, so the second mostly finds them in L2):
//   * ivf_scan_kernel: a persistent grid of one CTA a SM (times query
//     groups), each walking the (table entry, 256-row tile) items
//     blockIdx.x, + gridDim.x, ... of its group; the number of entries is
//     read on the device (n_valid), so nothing is sized by the table's
//     padded width. A producer warp streams each tile's rows into a 4-stage
//     ring of mbarriers by TMA (a 2-D map over corpus [N, D], encoded once
//     per corpus tensor by the caller: boxes of 256 rows x 128 bytes with
//     the 128-byte swizzle, 32 KB a stage). The query group (8, 16 or 32
//     queries: one to four n8 tiles) stays in shared memory for the whole
//     CTA where it fits, loaded once by TMA in 64-column chunks; where it
//     does not (32 queries at D 5120), each stage carries its columns'
//     query chunks beside the rows. Eight consumer warps own 32 rows each
//     and compute the [256 rows x group] scores with mma.sync m16n8k16
//     (bf16 in, fp32 sums), fragments by ldmatrix from the swizzled
//     stages; int8 rows are widened to bf16 in registers (the 4 bytes a
//     thread holds are k 4t..4t+3; the query fragments are taken at the
//     same permutation of k, which leaves every dot product unchanged) and
//     multiplied by their scale after the product. A warp writes its rows'
//     scores for the group's queries, and (once, not per query) their ids,
//     into the selection's candidate workspace at the row's place in the
//     table (entry * block_n + row; the workspace holds ws_cols entries a
//     query, which the host sets to min(table_cols, n_blocks) when n_valid
//     is given, since the distinct entries it counts cannot exceed
//     n_blocks; entries past the ws_cols-th are not scanned). An entry
//     whose block is out of range or listed earlier in the same table row
//     scans nothing and writes ids of -1, so a repeated block's rows are
//     dropped before the selection counts. The CTAs also clear the
//     selection's histograms and counters.
//   * select_k::select_kernel (select_k.cuh): the exact selection over each
//     query's candidates (every row of its table row's first n_valid
//     entries), a radix select of the k-th key over several CTAs a query,
//     then a compaction and an ordered placement whose serial work does not
//     grow with k.
// Ids must be unique across the corpus (the index stores row ids).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "hopper.cuh"
#include "select_k.cuh"

namespace {

using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_bar_arrive;
using hopper::named_bar_sync;

constexpr int kWarps = 8;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // + the producer warp
constexpr int kRows = 256;                   // rows a tile, 32 a warp
constexpr int kSpan = 128;                   // bytes of a row a stage
constexpr int kStage = kRows * kSpan;        // 32 KB of rows a stage
constexpr int kRing = 4;
constexpr int kQCols = 64;                   // bf16 query columns a chunk
constexpr int kInitBar = 1;                  // named barrier: ring ready
constexpr int kMaxSmem = 232448 - 1024;      // dynamic, beside the static
constexpr int kChunk = 64;                   // queries a scan + selection

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
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

// Bytes 0, 1 and 2, 3 of four int8 values as two bf16x2 words, exactly
// and without conversion instructions: byte b ^ 0x80 (b + 128) under the
// float exponent of 2^23 is 2^23 + b + 128, less 2^23 + 128 is b, whose
// bf16 is its float's high half (|b| <= 128 needs 8 significant bits).
__device__ __forceinline__ void widen(uint32_t u, uint32_t& lo, uint32_t& hi) {
  const uint32_t x = u ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7550 + i)) -
           8388736.0f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Byte offset of 16-byte chunk `c` of row `r` in a 128-byte-swizzled tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kSpan + ((c ^ (r & 7)) << 4);
}

// Whether entry e of a table row scans its block: in range and not listed
// earlier in the row (warp-collective; the same answer in every lane).
__device__ __forceinline__ bool scans(const int* row, int e, int blk,
                                      int n_blocks, int lane) {
  if (blk < 0 || blk >= n_blocks) return false;
  bool seen = false;
  for (int j = lane; j < e; j += 32) seen |= __ldg(row + j) == blk;
  return !__any_sync(0xffffffffu, seen);
}

struct ScanArgs {
  const int* ids;         // [n_blocks * block_n]
  const float* scales;    // int8 rows' scales, else null
  const int* table;       // this chunk's: [per_query ? nq : 1, table_cols]
  int table_cols;         // entries scanned a row: the workspace's
  int per_query;
  const int* n_valid;     // null, or a device count of entries
  int nq, q_base;         // queries of this chunk, its first in the batch
  int n_blocks, d, block_n;
  int stream_q;           // the query chunks ride in the ring's stages
  float* cand_s;          // [nq, table_cols * block_n]
  int* cand_i;            // [per_query ? nq : 1, table_cols * block_n]
  uint32_t* hist;         // the selection's, cleared here
  uint32_t* counts;
};

// T: bf16 or int8 rows; NT: n8 query tiles of a group (8 * NT queries).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
ivf_scan_kernel(const __grid_constant__ CUtensorMap c_map,
                const __grid_constant__ CUtensorMap q_map, const ScanArgs a) {
  constexpr int QG = 8 * NT;                       // query rows of a group
  constexpr int EPS = kSpan / sizeof(T);           // row elements a stage
  constexpr int QC = EPS / kQCols;                 // query chunks a stage
  constexpr int kQChunk = QG * kSpan;              // bytes of a query chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ uint64_t full[kRing], empty[kRing], qbar;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stage_bytes = kStage + (a.stream_q ? QC * kQChunk : 0);
  unsigned char* q_sh = ring + kRing * stage_bytes;  // resident query
  const int n_steps = (a.d + EPS - 1) / EPS;
  const int n_chunks = n_steps * QC;               // the resident query's
  const int group = blockIdx.y;
  const int q0 = a.per_query ? group : group * QG;   // in this chunk
  const int nqb = a.per_query ? 1 : min(QG, a.nq - q0);
  const int* row = a.table + (a.per_query ? static_cast<int64_t>(group) * a.table_cols : 0);
  int cols = a.table_cols;
  if (a.n_valid != nullptr) cols = max(0, min(cols, *a.n_valid));
  const int tpb = (a.block_n + kRows - 1) / kRows;   // tiles a block
  const int items = cols * tpb;
  const int64_t width = static_cast<int64_t>(a.table_cols) * a.block_n;

  {  // clear the selection's histograms and counters
    const int64_t cta = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    select_k::clear(a.hist, a.counts, a.nq, cta * kThreads + tid,
                    static_cast<int64_t>(gridDim.x) * gridDim.y * kThreads);
  }

  if (warp == kWarps) {
    // producer: initialises the ring, loads the resident query, then
    // streams every stage of every item of this CTA, in order
    if (lane == 0) {
      hopper::prefetch_tensor_map(&c_map);
      hopper::prefetch_tensor_map(&q_map);
      for (int s = 0; s < kRing; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kWarps);
      }
      mbar_init(&qbar, 1);
      hopper::fence_barrier_init();
    }
    __syncwarp();
    named_bar_arrive(kInitBar, kThreads);
    const int q_row0 = a.q_base + q0;
    if (lane == 0 && !a.stream_q) {
      hopper::mbar_arrive_expect_tx(&qbar, n_chunks * kQChunk);
      for (int c = 0; c < n_chunks; ++c)
        hopper::tma_load_2d(q_sh + c * kQChunk, &q_map, &qbar, c * kQCols,
                            q_row0);
    }
    int use = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int e = it / tpb;
      const int blk = __ldg(row + e);
      if (!scans(row, e, blk, a.n_blocks, lane)) continue;
      const int r0 = blk * a.block_n + (it % tpb) * kRows;
      if (lane == 0) {
        for (int st = 0; st < n_steps; ++st) {
          const int u = use + st, slot = u % kRing;
          if (u >= kRing) mbar_wait(&empty[slot], ((u / kRing) - 1) & 1);
          unsigned char* dst = ring + slot * stage_bytes;
          hopper::mbar_arrive_expect_tx(&full[slot], stage_bytes);
          hopper::tma_load_2d(dst, &c_map, &full[slot], st * EPS, r0);
          if (a.stream_q)
            for (int c = 0; c < QC; ++c)
              hopper::tma_load_2d(dst + kStage + c * kQChunk, &q_map,
                                  &full[slot], (st * QC + c) * kQCols, q_row0);
        }
      }
      use += n_steps;
    }
    return;
  }

  // consumer warp w: rows 32w .. 32w + 31 of each tile
  named_bar_sync(kInitBar, kThreads);
  if (!a.stream_q) mbar_wait(&qbar, 0);
  const int g = lane >> 2, t = lane & 3;
  const int rw0 = warp * 32;
  const bool write_ids = a.per_query || group == 0;
  float* out_s = a.cand_s + static_cast<int64_t>(q0) * width;
  int* out_i = a.cand_i + (a.per_query ? static_cast<int64_t>(group) * width : 0);
  int use = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int e = it / tpb;
    const int blk = __ldg(row + e);
    const int sub = (it % tpb) * kRows;
    const int lim = min(kRows, a.block_n - sub);       // rows of this tile
    const int64_t slot0 = static_cast<int64_t>(e) * a.block_n + sub;
    if (!scans(row, e, blk, a.n_blocks, lane)) {
      if (write_ids && rw0 + lane < lim) out_i[slot0 + rw0 + lane] = -1;
      continue;
    }
    const int64_t r0 = static_cast<int64_t>(blk) * a.block_n + sub;
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    for (int st = 0; st < n_steps; ++st, ++use) {
      const int slot = use % kRing;
      mbar_wait(&full[slot], (use / kRing) & 1);
      const unsigned char* cs = ring + slot * stage_bytes;
      const unsigned char* qs =
          a.stream_q ? cs + kStage : q_sh + st * QC * kQChunk;
      if constexpr (sizeof(T) == 2) {
        // four k16 steps: A by ldmatrix from the rows, B from the queries
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          uint32_t b[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int qr = nt * 8 + (lane & 7);
            ldsm_x4(b[nt], qs + swz(qr, 4 * k2 + (lane >> 3)));
          }
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int kk = 2 * k2 + kh;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t av[4];
              const int r = rw0 + mt * 16 + (lane & 15);
              ldsm_x4(av, cs + swz(r, 2 * kk + (lane >> 4)));
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_bf16(acc[mt][nt], av[0], av[1], av[2], av[3],
                         b[nt][2 * kh], b[nt][2 * kh + 1]);
            }
          }
        }
      } else {
        // four k32 steps of int8: each 16-byte chunk of a row gives one k16
        // mma with k permuted (thread t holds bytes 4t .. 4t + 3)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t raw[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = rw0 + mt * 16 + (lane & 15);
            ldsm_x4(raw[mt], cs + swz(r, 2 * j + (lane >> 4)));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 32 * j + 16 * h + 4 * t;      // stage column
            const unsigned char* qc = qs + (col / kQCols) * kQChunk;
            const int cc = col % kQCols;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t lo0, hi0, lo1, hi1;
              widen(raw[mt][2 * h], lo0, hi0);       // row g
              widen(raw[mt][2 * h + 1], lo1, hi1);   // row g + 8
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const uint2 b = *reinterpret_cast<const uint2*>(
                    qc + swz(nt * 8 + g, cc >> 3) + 2 * (cc & 7));
                mma_bf16(acc[mt][nt], lo0, lo1, hi0, hi1, b.x, b.y);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }

    // accumulator (row g [+8], query 2t [+1]) -> the candidate workspace
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rw0 + mt * 16 + g + 8 * h;
        if (rl >= lim) continue;
        float scale = 1.f;
        if (a.scales != nullptr) scale = __ldg(a.scales + r0 + rl);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int qc = nt * 8 + 2 * t + i;
            if (qc < nqb)
              out_s[qc * width + slot0 + rl] = acc[mt][nt][2 * h + i] * scale;
          }
      }
    if (write_ids && rw0 + lane < lim)
      out_i[slot0 + rw0 + lane] = __ldg(a.ids + r0 + rw0 + lane);
  }
}

// Shared memory of a CTA: the ring, then the resident query (when the
// query chunks do not ride in the stages; as many chunks as the stages
// cover, those past D zero), + 1 KB for the alignment.
int scan_smem(int qg, int d, int elem, bool stream_q) {
  const int chunk = qg * kSpan, per_stage = kSpan / elem / kQCols;
  if (stream_q) return kRing * (kStage + per_stage * chunk) + 1024;
  const int steps = (d + kSpan / elem - 1) / (kSpan / elem);
  return kRing * kStage + steps * per_stage * chunk + 1024;
}

// Opts the instance into the most dynamic shared memory it may take, on
// the current device, once a device (the attribute is a device's).
template <typename T, int NT>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ivf_scan_kernel<T, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int NT>
cudaError_t launch_scan(const CUtensorMap& c_map, const CUtensorMap& q_map,
                        const ScanArgs& a, int n_ctas, int groups,
                        cudaStream_t st) {
  constexpr int QG = 8 * NT;
  ScanArgs args = a;
  args.stream_q = scan_smem(QG, a.d, sizeof(T), false) > kMaxSmem;
  const int smem = scan_smem(QG, a.d, sizeof(T), args.stream_q);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<T, NT>();
  if (err != cudaSuccess) return err;
  ivf_scan_kernel<T, NT><<<dim3(n_ctas, groups), kThreads, smem, st>>>(
      c_map, q_map, args);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* c_map_host, const void* q_map_host, const float* scales,
           const int* ids, const int* table, int table_cols, int ws_cols,
           int per_query, const int* n_valid, int nq, int qg, int n_blocks,
           int d, int block_n, int k, int n_ctas, int sel_ctas, float* cand_s,
           int* cand_i, uint32_t* hist, uint32_t* counts, uint64_t* surv,
           int64_t surv_stride, float* out_s, int* out_i, void* stream) {
  // qg: the query group's rows, which the query map's boxes were encoded
  // with (8 on the probed route, 8, 16 or 32 on the union route)
  if (nq < 1 || n_blocks < 1 || block_n < 1 || table_cols < 1 ||
      ws_cols < 1 || ws_cols > table_cols ||
      (per_query && ws_cols != table_cols) || d < 8 ||
      d % (16 / sizeof(T)) != 0 || k < 1 ||
      n_ctas < 1 || sel_ctas < 1 ||
      (qg != 8 && qg != 16 && qg != 32) || (per_query && qg != 8) ||
      static_cast<int64_t>(n_blocks) * block_n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap c_map, q_map;
  memcpy(&c_map, c_map_host, sizeof(CUtensorMap));
  memcpy(&q_map, q_map_host, sizeof(CUtensorMap));
  const int64_t width = static_cast<int64_t>(ws_cols) * block_n;
  for (int q0 = 0; q0 < nq; q0 += kChunk) {
    const int cn = nq - q0 < kChunk ? nq - q0 : kChunk;
    const int* rows = table + (per_query ? static_cast<int64_t>(q0) * table_cols : 0);
    // a union table's one row is scanned over its first ws_cols entries;
    // a probed table's rows (stride table_cols) over all of theirs
    const ScanArgs a{ids, scales, rows, ws_cols, per_query, n_valid, cn, q0,
                     n_blocks, d, block_n, 0, cand_s, cand_i, hist, counts};
    const int groups = per_query ? cn : (cn + qg - 1) / qg;
    cudaError_t err =
        qg == 8  ? launch_scan<T, 1>(c_map, q_map, a, n_ctas, groups, st)
      : qg == 16 ? launch_scan<T, 2>(c_map, q_map, a, n_ctas, groups, st)
                 : launch_scan<T, 4>(c_map, q_map, a, n_ctas, groups, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    select_k::Args s{cand_s, width, cand_i, per_query ? width : 0, width,
                     n_valid, block_n, k, hist, counts, surv, surv_stride,
                     out_s + static_cast<int64_t>(q0) * k,
                     out_i + static_cast<int64_t>(q0) * k, 0};
    err = select_k::launch(s, cn, sel_ctas, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// Rows of a scan tile; the selection's histogram and counter words a query.
int ivf_scan_tile_rows() { return kRows; }
int ivf_scan_clear_words() { return static_cast<int>(select_k::clear_words()); }
// Queries a scan + selection takes (the workspace holds one such chunk).
int ivf_scan_chunk() { return kChunk; }

// The corpus's tensor map (boxes of 256 rows x 128 bytes, 128-byte
// swizzle) for corpus [n, d] (bf16, or int8 when `int8`), into the
// sizeof(CUtensorMap) = 128 bytes at `map`. Returns the CUDA error code.
int ivf_scan_encode(const void* corpus, int int8, int n, int d, void* map) {
  CUtensorMap m;
  const int err = int8
      ? hopper_host::encode_2d(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, corpus,
                               d, n, kSpan, kRows, 128)
      : hopper_host::encode_2d(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                               corpus, d, n, kSpan / 2, kRows, 128);
  if (err == 0) memcpy(map, &m, sizeof(CUtensorMap));
  return err;
}

// The query group's tensor map (boxes of `qg` rows x 64 columns, 128-byte
// swizzle; rows past nq read as zeros) for queries [nq, d] bf16, into the
// 128 bytes at `map`. Returns the CUDA error code.
int ivf_scan_encode_queries(const void* queries, int nq, int d, int qg,
                            void* map) {
  CUtensorMap m;
  const int err = hopper_host::encode_2d(
      &m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, queries, d, nq, kQCols, qg,
      128);
  if (err == 0) memcpy(map, &m, sizeof(CUtensorMap));
  return err;
}

// c_map (ivf_scan_encode) over corpus
// [n_blocks * block_n, d]; q_map (ivf_scan_encode_queries with qg rows a
// box: 8 on the probed route, else 8, 16 or 32) over queries [nq, d] bf16;
// ids [n_blocks * block_n] int32; table [per_query ? nq : 1, table_cols]
// int32 block indices, of which the first ws_cols <= table_cols a row are
// scanned; n_valid: null, or a device int32 that limits every table row to
// its first n_valid entries; n_ctas scan CTAs a query group, sel_ctas
// selection CTAs a query; the workspace, for one chunk of c = min(nq,
// ivf_scan_chunk()) queries: cand_s [c, ws_cols * block_n] f32, cand_i
// [per_query ? c : 1, ws_cols * block_n] int32, hist and counts
// (ivf_scan_clear_words a query), surv [c, surv_stride >= min(k, ws_cols *
// block_n)] u64 -> out_s [nq, k] f32, out_i [nq, k] int32, any k >= 1.
// Returns the CUDA error code of the launches.
int ivf_scan_bf16(const void* c_map, const void* q_map, const int* ids,
                  const int* table, int table_cols, int ws_cols,
                  int per_query, const int* n_valid, int nq, int qg,
                  int n_blocks, int d, int block_n, int k, int n_ctas,
                  int sel_ctas, float* cand_s, int* cand_i, uint32_t* hist,
                  uint32_t* counts, uint64_t* surv, int64_t surv_stride,
                  float* out_s, int* out_i, void* stream) {
  return launch<__nv_bfloat16>(c_map, q_map, nullptr, ids, table,
                               table_cols, ws_cols, per_query, n_valid, nq,
                               qg, n_blocks, d, block_n, k, n_ctas, sel_ctas,
                               cand_s, cand_i, hist, counts, surv,
                               surv_stride, out_s, out_i, stream);
}

// The same over an int8 corpus (d a multiple of 16) with f32 row scales
// [n_blocks * block_n].
int ivf_scan_int8(const void* c_map, const void* q_map, const float* scales,
                  const int* ids, const int* table, int table_cols,
                  int ws_cols, int per_query, const int* n_valid, int nq,
                  int qg, int n_blocks, int d, int block_n, int k, int n_ctas,
                  int sel_ctas, float* cand_s, int* cand_i, uint32_t* hist,
                  uint32_t* counts, uint64_t* surv, int64_t surv_stride,
                  float* out_s, int* out_i, void* stream) {
  return launch<int8_t>(c_map, q_map, scales, ids, table, table_cols,
                        ws_cols, per_query, n_valid, nq, qg, n_blocks, d,
                        block_n, k, n_ctas, sel_ctas, cand_s, cand_i, hist,
                        counts, surv, surv_stride, out_s, out_i, stream);
}

}  // extern "C"
