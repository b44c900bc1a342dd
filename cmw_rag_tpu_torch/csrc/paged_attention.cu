// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of cmw_rag_tpu/ops/paged_attention.py:
//   :469 paged_decode_attention_dma (body _paged_dma_kernel :322);
//   :559 paged_decode_attention_dma_scatter (body _paged_dma_scatter_kernel
//        :521: this step's K/V row written into the pool first);
//   :858 paged_decode_attention_dma_kv_int8 (body _paged_dma_int8_kernel
//        :685: int8 pages with page-granular f32 scales);
// and three other TPU schedules of the same function, :641
// paged_decode_attention (_paged_kernel :64), :187
// paged_decode_attention_pooled (_paged_wl_kernel :121) and :1241
// paged_decode_attention_dma_batched (_paged_dma_batched_kernel :1111).
//
// Function, one query token per slot s and query head h, over one layer of
// a paged pool [P, page, Hkv, Dh]: KV head g = h / rep (rep = Hq / Hkv);
// position pos of the slot lives in page tables[s, pos / page], row
// pos % page. Over pos < lens[s]: score = (q . k) / sqrt(Dh) in fp32 (int8:
// times the page's K scale), softmax in fp32, o = sum p * v in fp32 (int8:
// p times the page's V scale weighs v), written as bf16. Rows at or past
// lens[s] are never weighted, so stale or NaN rows of a preempted request
// cannot leak (the TPU zeroes them with a where, because NaN * 0 is NaN).
//
// Fused write (bf16): split 0 of (g, s) stores k_new[s, g] and v_new[s, g]
// into pool row (page_idx[s], off[s]); the split that holds position
// lens[s] - 1 copies that row from k_new / v_new, never from the pool. The
// caller guarantees that (page_idx[s], off[s]) is position lens[s] - 1 of
// slot s and that active slots write distinct rows. The engine does: an
// active slot writes its own next row; an idle slot writes row 0 of the
// null page 0 and reads only that position, so idle slots race on a row
// whose attention output nobody samples. So no block reads a pool row that
// another block writes, and nothing waits between blocks.
//
// What bounds it: bytes. Each (slot, KV head) reads K and V of its used
// positions once, 2 * lens * Dh * (2 or 1) bytes, for about 4 * rep * Dh
// operations a position: ~2 operations a byte at rep 2, far under the ~295
// where the H100 turns compute-bound. So there are no tensor cores here
// (rep 2 would fill 2 of a wgmma's 64 rows); the only gains are bytes in
// flight and fewer launches. At 4 slots x 2048 positions x 8 KV heads x Dh
// 128, bf16, that is 33.5 MB, 10 us at 3.35 TB/s.
//
// Design: one launch a call. A work item is (KV head, slot, split of
// `split` positions): the grid is (Hkv, S, ceil(maxp * page / split)), the
// split chosen by the host from the table width and the blocks the card
// keeps resident (ops/paged_attention.py paged_split), never from the
// lengths on the device; a split past the slot's length returns at once.
// A block is eight consumer warps and one producer warp. The producer
// loads a stage of 64 positions of one KV head's K rows and V rows (Dh
// values a row, 256 bytes of bf16 or 128 of int8 at Dh 128, Hkv * Dh
// apart in the pool) with TMA boxes of `box` = gcd(page, 64, split) rows,
// one a page at most, through tensor maps of the whole stacked pool
// [L * P * page, Hkv, Dh], which the host encodes once a pool and caches;
// the boxes complete on an mbarrier of a ring in shared memory, a stage's
// K and V together and the next stage in flight behind it (two stages
// when the split has them). The tensor maps, the split's pages and q are
// loaded before the slot's length arrives. (A first version issued one
// cp.async.bulk of 256 bytes a row: 0.0193 ms at 4 slots x 2048 against
// 0.0164 with boxes, the compute as it is here.) The row of position
// lens[s] - 1 is written over in shared memory from k_new / v_new before
// anything reads it (fused write). Each consumer warp owns 8 positions of
// every stage: it scores them for all rep query heads (Dh / 8 lanes a
// row, 16-byte reads, every pass in straight-line code), takes the stage's
// max and sum over its rows from its own registers and one shuffle across
// its row groups, keeps its own running max, sum and [rep, Dh]
// accumulator, and folds the stage's V rows in (Dh / 32 values a lane).
// At the split lengths of decode the time goes to latency, not bytes: a
// stage's arithmetic, on a few warps a SM, costs about what its load does,
// so eight warps (not four) share a stage. The warps meet in shared memory
// in warp order once a split. A context of one split writes its output at
// once; otherwise each split writes (m, l, acc) to float32 scratch and the
// last split of the (slot, KV head) to finish (an integer counter bumped
// after a __threadfence) merges them in split order, as attend_split of
// csrc/int8_decode.cuh merges, and sets the counter back to 0.
// No float atomics: two launches agree bit for bit.
// Takes Dh in {64, 128}, rep in {1, 2, 4, 8}; a TMA box must fill a
// multiple of 128 bytes, so int8 pages at Dh 64 need an even box (the host
// refuses an odd page, say).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "hopper.cuh"
#include "int8_decode.cuh"

namespace {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_bar_sync;

constexpr int kWarps = 8;                    // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kRows = 64;                    // positions a stage
constexpr int kMaxDepth = 2;                 // stages in flight
constexpr int kMeetBar = 1;                  // the consumers' named barrier

// Shared-memory bytes of a stage (K rows, then V rows) and of its scales.
template <typename T, int DH>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kRows * DH * static_cast<int>(sizeof(T));
}
constexpr int kScaleBytes = 2 * kRows * 4;

__host__ __device__ constexpr int ring_depth(int split) {
  return split > kRows ? kMaxDepth : 1;
}

template <typename T, int DH>
__host__ __device__ constexpr int smem_bytes(int depth) {
  return depth * (stage_bytes<T, DH>() + kScaleBytes);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <int N>
struct Raw;
template <> struct Raw<16> { using U = uint4; };
template <> struct Raw<8> { using U = uint2; };
template <> struct Raw<4> { using U = uint32_t; };
template <> struct Raw<2> { using U = uint16_t; };

// N values of type T at p (N * sizeof(T) bytes, aligned to that) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const void* p, float (&f)[N]) {
  using U = typename Raw<N * static_cast<int>(sizeof(T))>::U;
  const U u = *reinterpret_cast<const U*>(p);
  const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_float(v[i]);
}

template <typename T, int DH, int REP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, T* k_pool, T* v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    const __nv_bfloat16* __restrict__ k_new,
                    const __nv_bfloat16* __restrict__ v_new,
                    const int* __restrict__ page_idx,
                    const int* __restrict__ off,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, int layer_row0,
                    int hkv, int page, int maxp, int split, int box,
                    int depth, float inv_sqrt_dh, float* part, int* count,
                    __nv_bfloat16* __restrict__ out) {
  constexpr int W = kWarps;
  constexpr int R = kRows / W;        // a consumer warp's rows of a stage
  constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  constexpr int kStage = stage_bytes<T, DH>();
  constexpr int TPR = DH / 8;         // lanes that score a row, 8 values each
  constexpr int RPP = 32 / TPR;       // rows a warp scores at once
  constexpr int NP = R / RPP;         // passes over the warp's rows
  constexpr int EV = DH / 32;         // values of a V row a lane folds in
  constexpr bool kInt8 = sizeof(T) == 1;  // int8 pages carry page scales
  static_assert(R % RPP == 0 && R <= 32, "warp rows");
  static_assert(W * DH * 4 <= kStage, "a query head's meet fits a stage");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kMaxDepth], empty[kMaxDepth];
  __shared__ float sc[W][REP][R];  // probabilities of a stage
  __shared__ float m_w[W][REP], l_w[W][REP];
  __shared__ int last;
  float* scales = reinterpret_cast<float*>(smem + depth * kStage);

  const int g = blockIdx.x, s = blockIdx.y, j = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * REP;
  const int p0 = j * split;
  const int* trow = tables + static_cast<int64_t>(s) * maxp;
  const int c = lane % TPR, rsub = lane / TPR;

  // what does not depend on the length is loaded while it arrives: the
  // tensor maps, the pages of the split's first 32 boxes (producer), q
  // (consumers)
  int first = 0;
  float qf[REP][8];
  if (warp == W) {
    if (lane == 0) {
      hopper::prefetch_tensor_map(&k_map);
      hopper::prefetch_tensor_map(&v_map);
    }
    const int pos = p0 + lane * box;
    if (lane * box < split && pos < maxp * page) first = trow[pos / page];
  } else {
#pragma unroll
    for (int r = 0; r < REP; ++r)
      load_vals<__nv_bfloat16, 8>(
          q + (static_cast<int64_t>(s) * hq + g * REP + r) * DH + c * 8,
          qf[r]);
  }
  if (tid == 0) {
    for (int i = 0; i < depth; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], W);
    }
    hopper::fence_barrier_init();
  }
  const int full_len = lens[s];
  const int len = min(full_len, maxp * page);
  const int n_live = i8d::live_splits(len, split);
  if (j >= n_live) return;  // the same for the whole block
  const int rows = max(0, min(split, len - p0));
  const int n_st = (rows + kRows - 1) / kRows;
  const int64_t row_stride = static_cast<int64_t>(hkv) * DH;
  const int64_t page_stride = row_stride * page;
  const int64_t new_row = (static_cast<int64_t>(s) * hkv + g) * DH;
  bool fused = false;
  if constexpr (sizeof(T) == 2) fused = k_new != nullptr;
  __syncthreads();  // the barriers are initialised

  if (warp == W) {
    // producer: each stage's K and V rows, a TMA box of `box` rows a page
    for (int t = 0; t < n_st; ++t) {
      const int st = t % depth;
      if (t >= depth) mbar_wait(&empty[st], ((t / depth) - 1) & 1);
      const int r0 = t * kRows;
      const int nr = min(kRows, rows - r0);
      const int nb = (nr + box - 1) / box;
      unsigned char* kd = smem + st * kStage;
      unsigned char* vd = kd + kRows * kRowBytes;
      float* ss = scales + st * 2 * kRows;
      if (lane == 0) mbar_expect_tx(&full[st], 2 * nb * box * kRowBytes);
      __syncwarp();
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int b = b0 + lane, bi = r0 / box + b;  // bi: box of the split
        const int pos = p0 + bi * box;  // a box never crosses a page
        int phys = __shfl_sync(0xffffffffu, first, bi & 31);
        if (b < nb) {
          if (bi >= 32) phys = trow[pos / page];
          const int row = layer_row0 + phys * page + pos % page;
          hopper::tma_load_3d(kd + b * box * kRowBytes, &k_map, &full[st], 0,
                              g, row);
          hopper::tma_load_3d(vd + b * box * kRowBytes, &v_map, &full[st], 0,
                              g, row);
        }
      }
      if constexpr (kInt8) {
#pragma unroll
        for (int u = 0; u < kRows / 32; ++u) {
          const int i = lane + 32 * u;
          if (i < nr) {
            const int64_t at =
                static_cast<int64_t>(trow[(p0 + r0 + i) / page]) * hkv + g;
            ss[i] = k_scale[at];
            ss[kRows + i] = v_scale[at];
          }
        }
      }
      __syncwarp();  // the scales are stored before the arrival
      if (lane == 0) mbar_arrive(&full[st]);
    }
    return;
  }

  if (fused && j == 0 && tid < DH / 8) {  // this step's row into the pool
    const int64_t dst = page_idx[s] * page_stride +
                        static_cast<int64_t>(off[s]) * row_stride +
                        static_cast<int64_t>(g) * DH;
    reinterpret_cast<uint4*>(k_pool + dst)[tid] =
        reinterpret_cast<const uint4*>(k_new + new_row)[tid];
    reinterpret_cast<uint4*>(v_pool + dst)[tid] =
        reinterpret_cast<const uint4*>(v_new + new_row)[tid];
  }

  float m[REP], l[REP], acc[REP][EV];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EV; ++e) acc[r][e] = 0.f;
  }

  const int w0 = warp * R;
  for (int t = 0; t < n_st; ++t) {
    const int st = t % depth;
    mbar_wait(&full[st], (t / depth) & 1);
    const int nw = max(0, min(R, rows - t * kRows - w0));
    unsigned char* kd = smem + st * kStage + w0 * kRowBytes;
    unsigned char* vd = kd + kRows * kRowBytes;
    const float* ss = scales + st * 2 * kRows + w0;
    const int fr = full_len - 1 - p0 - t * kRows - w0;
    if (fused && fr >= 0 && fr < nw) {
      // this step's row from k_new / v_new, never what the pool held
      for (int i = lane; i < kRowBytes / 16; i += 32) {
        reinterpret_cast<uint4*>(kd + fr * kRowBytes)[i] =
            reinterpret_cast<const uint4*>(k_new + new_row)[i];
        reinterpret_cast<uint4*>(vd + fr * kRowBytes)[i] =
            reinterpret_cast<const uint4*>(v_new + new_row)[i];
      }
      hopper::fence_proxy_async();  // before a refill of this stage
      __syncwarp();
    }

    // scores of the warp's rows for every query head of the KV head, all
    // passes in straight-line code: row k * RPP + rsub's dot product is
    // summed over its TPR lanes, which all hold it
    float d[NP][REP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      float kf[8];
      load_vals<T, 8>(kd + (k * RPP + rsub) * kRowBytes + c * 8 * sizeof(T),
                      kf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qf[r][e], kf[e], a);
        d[k][r] = a;
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int r = 0; r < REP; ++r)
          d[k][r] += __shfl_xor_sync(0xffffffffu, d[k][r], o);

    // the stage's max and sum over the warp's rows: each lane's own passes,
    // then across its warp's row groups (lanes TPR apart); rows past nw
    // weigh 0
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int i = k * RPP + rsub;
        float x = d[k][r];
        if constexpr (kInt8) x *= ss[i];
        d[k][r] = i < nw ? x * inv_sqrt_dh : -INFINITY;
        mx = fmaxf(mx, d[k][r]);
      }
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        d[k][r] = m_new == -INFINITY ? 0.f : expf(d[k][r] - m_new);
        sum += d[k][r];
      }
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[r][e] *= alpha;
      if (c == 0)
#pragma unroll
        for (int k = 0; k < NP; ++k) sc[warp][r][k * RPP + rsub] = d[k][r];
    }
    __syncwarp();

    // V rows; a row past nw (past the length, or another stage's) is
    // replaced by zeros with a zero weight, never weighted 0 as it stands
    // (NaN * 0 is NaN)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool live = i < nw;
      float vf[EV];
      load_vals<T, EV>(vd + i * kRowBytes + lane * EV * sizeof(T), vf);
#pragma unroll
      for (int e = 0; e < EV; ++e) vf[e] = live ? vf[e] : 0.f;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float pr = sc[warp][r][i];
        if constexpr (kInt8) pr *= ss[kRows + i];
        pr = live ? pr : 0.f;
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the warps meet in warp order, a query head at a time, in the ring
  // (every stage is consumed)
  const int n_split = gridDim.z;
  const i8d::Meet meet{
      part + (static_cast<int64_t>(s) * hkv + g) * n_split * REP * (DH + 2),
      count + s * hkv + g};
  __nv_bfloat16* o = out + (static_cast<int64_t>(s) * hq + g * REP) * DH;
  float* red = reinterpret_cast<float*>(smem);  // [W][DH]
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m_w[warp][r] = m[r];
      l_w[warp][r] = l[r];
    }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    named_bar_sync(kMeetBar, kConsumers);  // the ring or red is free
#pragma unroll
    for (int e = 0; e < EV; ++e) red[warp * DH + lane * EV + e] = acc[r][e];
    named_bar_sync(kMeetBar, kConsumers);
    for (int d = tid; d < DH; d += kConsumers) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < W; ++w) mx = fmaxf(mx, m_w[w][r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float mw = m_w[w][r];
        const float wt = mw == -INFINITY ? 0.f : expf(mw - mx);
        num += wt * red[w * DH + d];
        den += wt * l_w[w][r];
      }
      if (n_live == 1) {
        o[r * DH + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
      } else {
        float* dst = meet.part + (static_cast<int64_t>(j) * REP + r) *
                                     (DH + 2);
        if (d == 0) {
          dst[0] = mx;
          dst[1] = den;
        }
        dst[2 + d] = num;
      }
    }
  }
  if (n_live == 1) return;

  __threadfence();  // this split's partial is visible before the count
  named_bar_sync(kMeetBar, kConsumers);
  if (tid == 0) last = atomicAdd(meet.count, 1) == n_live - 1;
  named_bar_sync(kMeetBar, kConsumers);
  if (!last) return;
  __threadfence();
  // the merge, as attend_split's: o = sum_j w_j acc_j / sum_j w_j l_j,
  // w_j = e^(m_j - max m), j in split order (the partials read past L1)
  constexpr int64_t stride = DH + 2, step = REP * stride;
  for (int i = tid; i < REP * DH; i += kConsumers) {
    const int r = i / DH, d = i % DH;
    const float* src = meet.part + r * stride;
    float mx = -INFINITY;
    for (int k = 0; k < n_live; ++k) mx = fmaxf(mx, __ldcg(src + k * step));
    float num = 0.f, den = 0.f;
    for (int k = 0; k < n_live; ++k) {
      const float mk = __ldcg(src + k * step);
      const float w = mk == -INFINITY ? 0.f : expf(mk - mx);
      num += w * __ldcg(src + k * step + 2 + d);
      den += w * __ldcg(src + k * step + 1);
    }
    o[r * DH + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
  if (tid == 0) *meet.count = 0;  // every split of this launch has counted
}

// Opts the kernel into its dynamic shared memory past 48 KB on the current
// device, once a device (the attribute is a device's).
template <typename T, int DH, int REP>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(paged_decode_kernel<T, DH, REP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<T, DH>(kMaxDepth));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

struct Args {
  const void* q;        // [S, Hq, Dh] bf16
  void* k_pool;         // this layer: [P, page, Hkv, Dh]
  void* v_pool;
  const void* k_map;    // the stacked pools' tensor maps (host memory)
  const void* v_map;
  int layer_row0;       // this layer's first row in them
  const float* k_scale;  // this layer: [P, Hkv] (int8) or null
  const float* v_scale;
  const int* tables;    // [S, maxp]
  const int* lens;      // [S]
  const void* k_new;    // [S, Hkv, Dh] bf16 or null (no fused write)
  const void* v_new;
  const int* page_idx;  // [S]
  const int* off;       // [S]
  int s, hkv, page, maxp, split, box;
  float* part;          // [S, Hkv, n_split, rep, Dh + 2] when n_split > 1
  int* count;           // [S * Hkv] zeros when n_split > 1
  void* out;            // [S, Hq, Dh] bf16
  cudaStream_t stream;
};

template <typename T, int DH, int REP>
int launch(const Args& a) {
  const int positions = a.maxp * a.page;
  const int n_split = i8d::live_splits(positions, a.split);
  if (n_split > 1 && (a.part == nullptr || a.count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_decode_kernel<T, DH, REP>;
  const cudaError_t opt_in = allow_smem<T, DH, REP>();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  // a box divides the stage, the page and the split, and starts on a
  // 128-byte boundary of shared memory
  if (a.box < 1 || kRows % a.box != 0 || a.page % a.box != 0 ||
      a.split % a.box != 0 || a.box * DH * sizeof(T) % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap k_map, v_map;
  memcpy(&k_map, a.k_map, sizeof(CUtensorMap));
  memcpy(&v_map, a.v_map, sizeof(CUtensorMap));
  const int depth = ring_depth(min(a.split, positions));
  kern<<<dim3(a.hkv, a.s, n_split), kThreads, smem_bytes<T, DH>(depth),
         a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<T*>(a.k_pool),
      static_cast<T*>(a.v_pool), a.k_scale, a.v_scale, a.tables, a.lens,
      static_cast<const __nv_bfloat16*>(a.k_new),
      static_cast<const __nv_bfloat16*>(a.v_new), a.page_idx, a.off, k_map,
      v_map, a.layer_row0, a.hkv, a.page, a.maxp, a.split, a.box, depth,
      1.0f / sqrtf(static_cast<float>(DH)), a.part, a.count,
      static_cast<__nv_bfloat16*>(a.out));
  return static_cast<int>(cudaGetLastError());
}


// Blocks of the kernel resident on one SM at its deepest ring.
template <typename T, int DH, int REP>
int resident(int* blocks) {
  cudaError_t err = allow_smem<T, DH, REP>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, paged_decode_kernel<T, DH, REP>, kThreads,
        smem_bytes<T, DH>(kMaxDepth));
  return static_cast<int>(err);
}

template <typename T, int DH, class F>
int by_rep(int rep, const F& f) {
  switch (rep) {
    case 1: return f.template run<T, DH, 1>();
    case 2: return f.template run<T, DH, 2>();
    case 4: return f.template run<T, DH, 4>();
    case 8: return f.template run<T, DH, 8>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, class F>
int by_shape(int dh, int rep, const F& f) {
  switch (dh) {
    case 64: return by_rep<T, 64>(rep, f);
    case 128: return by_rep<T, 128>(rep, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct Launch {
  const Args& a;
  template <typename T, int DH, int REP>
  int run() const { return launch<T, DH, REP>(a); }
};

struct Resident {
  int* blocks;
  template <typename T, int DH, int REP>
  int run() const { return resident<T, DH, REP>(blocks); }
};

template <typename T>
int dispatch(int hq, int dh, const Args& a) {
  if (a.s < 1 || a.hkv < 1 || hq % a.hkv != 0 || a.page < 1 ||
      a.maxp < 1 || a.split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_shape<T>(dh, hq / a.hkv, Launch{a});
}

}  // namespace

extern "C" {

// The tensor map of a stacked pool [rows, hkv, dh] (rows = L * P * page;
// bf16, or int8 when `int8`) with boxes of [box, 1, dh], into the
// sizeof(CUtensorMap) = 128 bytes at `map`. Returns the CUDA error code.
int paged_attention_encode(const void* pool, int int8, long long rows,
                           int hkv, int dh, int box, void* map) {
  if (map == nullptr || rows < 1 || box < 1 || box > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m;
  const int err = hopper_host::encode_3d(
      &m, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      int8 ? 1 : 2, pool, dh, hkv, static_cast<uint64_t>(rows), dh, 1, box, 0);
  if (err == 0) memcpy(map, &m, sizeof(CUtensorMap));
  return err;
}

// q [S, Hq, Dh] bf16; k_pool, v_pool: one layer [P, page, Hkv, Dh] bf16,
// k_map, v_map the tensor maps of the stacked pools that hold it (from
// paged_attention_encode, with boxes of `box` rows: box divides 64, the
// page and the split, and box * Dh * 2 is a multiple of 128), the layer's
// first row in them at layer_row0 (layer * P * page); tables [S, maxp],
// lens [S] int32. With k_new / v_new [S, Hkv, Dh] bf16 and page_idx / off
// [S] int32 (all non-null) this step's rows are written first; null
// pointers skip the write. Each slot's maxp * page positions are cut into
// splits of `split`; with more than one split a (slot, KV head), part holds
// S * Hkv * n_split * (Hq / Hkv) * (Dh + 2) floats and count S * Hkv int32
// zeros (left zero by the launch), n_split = ceil(maxp * page / split).
// out [S, Hq, Dh] bf16. Returns the CUDA error code of the launch.
int paged_attention_bf16(const void* q, void* k_pool, void* v_pool,
                         const void* k_map, const void* v_map, int layer_row0,
                         const int* tables, const int* lens, const void* k_new,
                         const void* v_new, const int* page_idx,
                         const int* off, int s, int hq, int hkv, int dh,
                         int page, int maxp, int split, int box, float* part,
                         int* count, void* out, void* stream) {
  const Args a{q, k_pool, v_pool, k_map, v_map, layer_row0, nullptr, nullptr,
               tables, lens, k_new, v_new, page_idx, off, s, hkv, page, maxp,
               split, box, part, count, out,
               static_cast<cudaStream_t>(stream)};
  return dispatch<__nv_bfloat16>(hq, dh, a);
}

// The same over int8 pages (maps encoded with int8 set, box * Dh a
// multiple of 128) with page-granular scales k_scale, v_scale [P, Hkv]
// float32 (one layer); no fused write.
int paged_attention_int8(const void* q, const void* k_pool,
                         const float* k_scale, const void* v_pool,
                         const float* v_scale, const void* k_map,
                         const void* v_map, int layer_row0, const int* tables,
                         const int* lens, int s, int hq, int hkv, int dh,
                         int page, int maxp, int split, int box, float* part,
                         int* count, void* out, void* stream) {
  const Args a{q, const_cast<void*>(k_pool), const_cast<void*>(v_pool),
               k_map, v_map, layer_row0, k_scale, v_scale, tables, lens,
               nullptr, nullptr, nullptr, nullptr, s, hkv, page, maxp, split,
               box, part, count, out, static_cast<cudaStream_t>(stream)};
  return dispatch<int8_t>(hq, dh, a);
}

// Blocks of the kernel (int8 pages or bf16, Dh, rep) that one SM keeps
// resident, into *blocks. Returns the CUDA error code.
int paged_attention_resident(int int8, int dh, int rep, int* blocks) {
  return int8 ? by_shape<int8_t>(dh, rep, Resident{blocks})
              : by_shape<__nv_bfloat16>(dh, rep, Resident{blocks});
}

}  // extern "C"
