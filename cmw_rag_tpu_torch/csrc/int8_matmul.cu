// Int8 matmuls for Hopper (sm_90a): weight-only, then W8A8 (its own
// section below).
//
// Replaces the TPU kernel cmw_rag_tpu/ops/int8_matmul.py:59 int8_matmul
// (body _int8_kernel :47). Function: y[m, n] = (sum_k bf16(x[m, k]) *
// w[k, n]) * scale[n], w int8 [K, N] (per-output-channel scales), x bf16 or
// float32 [M, K], the sum in float32, y in x's dtype. x is rounded to bf16
// first, as the TPU kernel feeds its MXU; bf16 x int8 products are exact in
// float32.
//
// What bounds it: bytes. Decode has M <= 32 rows, so each weight byte is
// used M times; the LM head alone is K x N = 1024 x 151,680 int8 = 155 MB,
// 46 us at 3.35 TB/s.
//
// Design: one block of 256 threads per work item (a 32-row tile of x, 64
// columns, a share of the contraction), the tile of csrc/int8_decode.cuh:
// weights through a 4-deep cp.async ring in 64-row stages, coalesced 16-byte
// copies along N, float32 FMAs on the CUDA cores. When N gives too few
// column tiles to fill the card (the fused QKV: 64), the contraction is
// split and each split writes float32 partial sums; a second kernel adds
// them in split order (no atomics, so runs repeat bit for bit), scales and
// casts. With enough tiles (the head: 2,370) the block scales and writes
// directly.

#include <string.h>

#include <atomic>

#include "hopper.cuh"
#include "int8_decode.cuh"

namespace {

using namespace i8d;

template <int MT, typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, int m, int k, int n,
                   int ks, float* __restrict__ partial, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Split sp = make_split(m, MT, n, k, ks);
  auto load = [&](int mm, int kk) {
    return bf16r(to_f(x[static_cast<int64_t>(mm) * k + kk]));
  };
  const int it = blockIdx.x;
  if (ks > 1) {
    split_item<MT>(sp, it, w, n, m, load, partial, smem);
  } else {
    const int ct = it % sp.col_tiles, mt = it / sp.col_tiles;
    int8_tile<MT>(w, n, ct * kBN, 0, k, mt * MT, m, load,
                  [&](int mm, int nn, float v) {
                    from_f(v * scale[nn], out + static_cast<int64_t>(mm) * n + nn);
                  },
                  smem);
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ partial,
                               const float* __restrict__ scale, int m, int n,
                               int ks, T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(m) * n) return;
  const int mm = static_cast<int>(i / n), nn = static_cast<int>(i % n);
  from_f(split_sum(partial, ks, m, n, mm, nn) * scale[nn], out + i);
}

template <int MT, typename T>
int launch(const void* x, const int8_t* w, const float* scale, int m, int k,
           int n, int ks, float* partial, void* out, cudaStream_t stream) {
  const int smem = tile_smem(MT);
  auto kern = int8_matmul_kernel<MT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = ((m + MT - 1) / MT) * ((n + kBN - 1) / kBN) * ks;
  kern<<<items, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, scale, m, k, n, ks, partial,
      static_cast<T*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(m) * n;
  combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      stream>>>(partial, scale, m, n, ks,
                                static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_tile(const void* x, const int8_t* w, const float* scale, int m, int k,
            int n, int ks, float* partial, void* out, cudaStream_t stream) {
  if (m <= 4) return launch<4, T>(x, w, scale, m, k, n, ks, partial, out, stream);
  if (m <= 8) return launch<8, T>(x, w, scale, m, k, n, ks, partial, out, stream);
  if (m <= 16)
    return launch<16, T>(x, w, scale, m, k, n, ks, partial, out, stream);
  return launch<32, T>(x, w, scale, m, k, n, ks, partial, out, stream);
}

// ------------------------------------------------------------------ W8A8
//
// Replaces the TPU kernel cmw_rag_tpu/ops/int8_matmul.py:133
// int8_matmul_w8a8 (body _w8a8_kernel :126, pallas_call :156) together with
// the activation quantization around it (quantize_activations :105) and the
// row scale on its output (:171): one launch computes the whole function.
// Function (ops/int8_matmul.py int8_matmul_w8a8_plain): each row m of x is
// quantized with s[m] = max(max_k |x[m, k]|, 1e-8) / 127 (an IEEE
// division) to q = clip(round_half_even(x / s[m]), -127, 127) (an IEEE
// division again); acc = sum_k q[m, k] w[k, n] exactly in int32; y[m, n] =
// (float(acc) * w_scale[n]) * s[m], rounded to x's dtype.
//
// What bounds it: bytes. Decode has M <= 32 rows, so each weight byte is
// used M times; the products of qwen3guard-0.6b move 2 to 6 MB of int8
// weights a call (0.6 to 1.9 us at 3.35 TB/s) and the head 155 MB (46 us).
// The small products are bound by latency: a call is over once every SM
// has had its round trip to device memory, so the aim is to put every byte
// in flight at once and to add as few round trips as possible around it.
//
// Design: one launch a call, nothing before or after it.
// - Work items are (m tile of 8F rows, 128-column tile, split of the
//   contraction into ks parts of whole 64-row stages); the host
//   (ops/int8_matmul.py w8a8_plan) picks ks from the tile and SM counts.
// - A block is four consumer warps and one producer warp. The producer
//   streams an item's weight rows [64 rows, 128 columns] a stage by TMA (a
//   2-D map over w [K, N], 128-byte swizzle, encoded once a weight and
//   cached by the host) into a ring of four 8 KB stages on mbarriers.
// - Meanwhile the consumers take each row's absmax and quantize the item's
//   contraction rows into shared memory (1024 rows at a time), in the
//   order the products read them. x's scales never reach device memory.
// - Products on the int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32,
//   the weights as operand A (16 output columns x 32 contraction rows), the
//   activations as operand B (8 rows a fragment, F = 1, 2 or 4 fragments).
//   The weights lie N-major in shared memory, A wants K-major: a thread
//   reads four bytes (four columns) from each of eight contraction rows
//   and transposes them with byte permutes, so that it holds its four
//   columns' eight contraction values. Which physical column and which
//   physical contraction row sit in which fragment slot is free as long as
//   A and B agree and the epilogue maps the columns back: thread (g, t)
//   takes rows 2t + j % 2 + 8 (j / 2), j = 0..7, of each 32-row step (with
//   the 128-byte swizzle, a warp's loads hit 32 distinct banks), and
//   columns 4g .. 4g + 3 of its warp's 32, as rows g, g + 8 of two 16-row
//   A tiles; its accumulators are then two activation rows x four
//   adjacent columns.
// - The blocks walk the items in turn (the host launches min(items, SMs x
//   resident blocks)); a block scans its m tile's rows over the whole of K
//   once, all of a warp's rows loaded together.
// - ks > 1: each split writes its int32 partial tile to the per-(device,
//   stream) workspace and bumps the tile's arrival counter; the last to
//   arrive reads the ks partials (all of a thread's loads in flight at
//   once, a thread a 4-column quad of the tile), adds them (integer sums:
//   any order gives the same bits), scales, writes y and sets the counter
//   back to 0 for the next launch on the stream.
// - The producer lane initialises the barriers and issues the first loads
//   before the consumers have met it; they meet before their first wait.
//   A split counts its arrival with one acquire-release atomic after the
//   block's barrier, no fence a thread.
// Why the merge and the scan take this form: at the layer's products the
// weights arrive near the latency and byte floor, and the time left is
// the round trips around them. Loads of the ks partials one after another
// cost a round trip a split; merging the splits in a thread block
// cluster's distributed shared memory, each block scanning only its own
// contraction rows, waited on the exchange of the partial absmax longer
// than the device-memory merge takes (0.0085 against 0.0064 ms at the
// fused QKV at 4 slots, in two runs of phase 10 of chip_smoke.py on an
// H100).

namespace w8 {

using hopper::mbar_arrive;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_bar_sync;

constexpr int kCols = 128;                 // tile columns: one TMA box row
constexpr int kRows = 64;                  // weight rows a stage
constexpr int kStage = kRows * kCols;      // 8 KB
constexpr int kRing = 4;                   // stages a block has in flight
constexpr int kWarps = kCols / 32;         // consumer warps, 32 columns each
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kXMax = 1024;                // contraction rows of x quantized at once
constexpr int kPass = kXMax / kRows;       // stages of one quantized pass
constexpr int kMeetBar = 1;                // the consumers' named barrier
constexpr int kInitBar = 2;                // barriers initialised: everyone

// Dynamic shared memory of the kernel with F fragments (8F activation
// rows): slack to align the ring to 1024 bytes (the swizzle's period), the
// ring, the quantized activations and their row scales.
template <int F>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + kRing * kStage + 8 * F * kXMax + 8 * F * 4;
}

struct Item {
  int mt, ct, ki, s0, s1;  // m tile, column tile, split, its stages [s0, s1)
};

__device__ __forceinline__ Item item_of(int it, int ks, int col_tiles,
                                        int steps) {
  Item t;
  t.ki = it % ks;
  const int tile = it / ks;
  t.ct = tile % col_tiles;
  t.mt = tile / col_tiles;
  t.s0 = t.ki * steps / ks;
  t.s1 = (t.ki + 1) * steps / ks;
  return t;
}

// 8 consecutive values of x (one or two 16-byte loads) as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The absmax of rows row0 + warp + 4i (i < MP / 4; rows past m: 0) over
// all of K, in every lane of the warp: the warp's rows are loaded together
// (x is read from L2; a scan a row after another waits on one round trip
// after another).
template <int MP, typename T>
__device__ void scan_rows(const T* x, int m, int k, int row0, int warp,
                          int lane, float (&a)[MP / kWarps]) {
  constexpr int R = MP / kWarps;
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = 0.f;
#pragma unroll 2
  for (int c = lane; c < k / 8; c += 32) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int gm = row0 + warp + kWarps * i;
      if (gm < m) {
        float v[8];
        load8(x + static_cast<int64_t>(gm) * k + 8 * c, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) a[i] = fmaxf(a[i], fabsf(v[j]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = i8d::warp_max(a[i]);
}

// clip(round_half_even(v / s), -127, 127) as the low byte of a word.
__device__ __forceinline__ uint32_t quant(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
}

// The MP rows of an m tile over contraction rows [k0, k0 + len), quantized
// into xs as [len / 32 steps][MP rows][32 bytes]: contraction row 8a + i of
// a step (a = 0..3, i = 0..7) at byte 8 (i / 2) + 2a + i % 2, so that
// thread t of a fragment reads its two B registers (rows 2t + j % 2 +
// 8 (j / 2), j = 0..3 and 4..7, the A side's order) as one 8-byte word.
// Rows past m are zeros. A thread's chunks of 8 values are loaded 4 at a
// time before any is used (x comes from L2 again: the ring and xs leave
// L1 little room), so a pass costs one round trip, not one a chunk.
template <int MP, typename T>
__device__ void quantize(const T* x, int m, int k, int row0, int k0, int len,
                         const float* xscale, int8_t* xs, int tid) {
  constexpr int kBatch = 4;
  constexpr int kWords = 8 * sizeof(T) / 16;  // 16-byte words a chunk
  const int chunks = len / 8;
  for (int c0 = tid; c0 < MP * chunks; c0 += kBatch * kConsumers) {
    uint4 raw[kBatch][kWords];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b * kConsumers;
      if (c < MP * chunks && row0 + c / chunks < m) {
        const uint4* src = reinterpret_cast<const uint4*>(
            x + static_cast<int64_t>(row0 + c / chunks) * k + k0 +
            8 * (c % chunks));
#pragma unroll
        for (int u = 0; u < kWords; ++u) raw[b][u] = src[u];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b * kConsumers;
      if (c >= MP * chunks) break;
      const int r = c / chunks, kc = c % chunks;
      uint32_t q[8];
      if (row0 + r < m) {
        float v[8];
        load8(reinterpret_cast<const T*>(raw[b]), v);
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] = quant(v[i], xscale[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] = 0u;
      }
      uint16_t* dst = reinterpret_cast<uint16_t*>(
          xs + ((kc / 4) * MP + r) * 32 + 2 * (kc % 4));
#pragma unroll
      for (int t = 0; t < 4; ++t)
        dst[4 * t] = static_cast<uint16_t>(q[2 * t] | (q[2 * t + 1] << 8));
    }
  }
}

// Rows r0..r3 of four adjacent columns (one word a row) -> one word a
// column, its rows low byte first.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* col) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);  // .x = a, the low half
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// y = (float(acc) * w_scale) * s for four adjacent columns.
template <typename T>
__device__ __forceinline__ void write_out(T* dst, const int4& v,
                                          const float4& ws, float s) {
  store4(dst, __fmul_rn(__fmul_rn(__int2float_rn(v.x), ws.x), s),
         __fmul_rn(__fmul_rn(__int2float_rn(v.y), ws.y), s),
         __fmul_rn(__fmul_rn(__int2float_rn(v.z), ws.z), s),
         __fmul_rn(__fmul_rn(__int2float_rn(v.w), ws.w), s));
}

// atomicAdd with acquire-release semantics at device scope: the old value.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ float xscale_of(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_mma_kernel(const T* __restrict__ x,
                const __grid_constant__ CUtensorMap w_map,
                const float* __restrict__ w_scale, int m, int k, int n,
                int ks, int* __restrict__ part, int* __restrict__ count,
                T* __restrict__ out) {
  constexpr int MP = 8 * F;       // activation rows of an m tile
  constexpr int R = MP / kWarps;  // rows a consumer warp scans
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* xs = reinterpret_cast<int8_t*>(ring + kRing * kStage);
  float* xscale = reinterpret_cast<float*>(xs + MP * kXMax);  // [MP]
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col_tiles = (n + kCols - 1) / kCols;
  const int steps = k / kRows;
  const int items = ((m + MP - 1) / MP) * col_tiles * ks;

  if (warp == kWarps) {
    // producer: initialises the ring, then streams every stage of every
    // item of this block, in order
    if (lane == 0) {
      hopper::prefetch_tensor_map(&w_map);
      for (int s = 0; s < kRing; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kWarps);
      }
      hopper::fence_barrier_init();
    }
    __syncwarp();
    hopper::named_bar_arrive(kInitBar, kThreads);
    if (lane == 0) {
      int use = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item t = item_of(it, ks, col_tiles, steps);
        for (int s = t.s0; s < t.s1; ++s, ++use) {
          const int slot = use % kRing;
          if (use >= kRing) mbar_wait(&empty[slot], ((use / kRing) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[slot], kStage);
          hopper::tma_load_2d(ring + slot * kStage, &w_map, &full[slot],
                              t.ct * kCols, s * kRows);
        }
      }
    }
    return;
  }

  // consumer thread (g, t) of warp w: columns 32w + 4g .. + 3 of the tile;
  // the swizzled offsets of its eight rows of a 32-row step (the 128-byte
  // swizzle moves 16-byte chunk c of row r to c ^ (r % 8))
  const int g = lane >> 2, t4 = lane & 3;
  const int chunk = 2 * warp + (g >> 2);
  int off[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = 2 * t4 + (j & 1) + 8 * (j >> 1);
    off[j] = r * kCols + ((chunk ^ (r & 7)) << 4) + 4 * (g & 3);
  }
  const int col_l = 32 * warp + 4 * g;

  bool ring_ready = false;
  int use = 0, have_mt = -1, have_p0 = -1, have_p1 = -1;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item t = item_of(it, ks, col_tiles, steps);
    const int row0 = t.mt * MP;
    if (t.mt != have_mt) {  // the rows' scales, over the whole of K
      float a[R];
      named_bar_sync(kMeetBar, kConsumers);  // the last tile's readers done
      scan_rows<MP>(x, m, k, row0, warp, lane, a);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          xscale[warp + kWarps * i] = xscale_of(a[i]);
      }
      have_mt = t.mt;
      have_p0 = -1;
    }

    int acc[F][2][4];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][h][e] = 0;

    for (int p0 = t.s0; p0 < t.s1; p0 += kPass) {  // 1024 rows at a time
      const int p1 = min(t.s1, p0 + kPass);
      if (p0 != have_p0 || p1 != have_p1) {
        named_bar_sync(kMeetBar, kConsumers);  // scales in, xs free
        quantize<MP>(x, m, k, row0, p0 * kRows, (p1 - p0) * kRows, xscale,
                     xs, tid);
        named_bar_sync(kMeetBar, kConsumers);
        have_p0 = p0;
        have_p1 = p1;
      }
      if (!ring_ready) {  // the producer has initialised the ring
        named_bar_sync(kInitBar, kThreads);
        ring_ready = true;
      }
      for (int s = p0; s < p1; ++s, ++use) {
        const int slot = use % kRing;
        mbar_wait(&full[slot], (use / kRing) & 1);
        const unsigned char* st = ring + slot * kStage;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the stage's two 32-row steps
          uint32_t w[8], lo[4], hi[4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j] = *reinterpret_cast<const uint32_t*>(st + h * 32 * kCols +
                                                      off[j]);
          transpose4(w, lo);
          transpose4(w + 4, hi);
          const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
          const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
          const int8_t* xq = xs + ((2 * (s - p0) + h) * MP) * 32 + t4 * 8;
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const uint2 b =
                *reinterpret_cast<const uint2*>(xq + (8 * f + g) * 32);
            hopper::mma_s8_16832(acc[f][0], a0, b.x, b.y);
            hopper::mma_s8_16832(acc[f][1], a1, b.x, b.y);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
    }

    // this thread's sums: rows 8f + 2t + e (e = 0, 1) of the tile, columns
    // col_l .. + 3 (acc[f][h] holds A rows g and g + 8 of tile h: columns
    // col_l + 2h and col_l + 2h + 1); N % 16 == 0: four columns live or none
    const int col = t.ct * kCols + col_l;
    if (ks == 1) {
      if (col < n) {
        const float4 ws = *reinterpret_cast<const float4*>(w_scale + col);
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ml = 8 * f + 2 * t4 + e;
            if (row0 + ml < m)
              write_out(out + static_cast<int64_t>(row0 + ml) * n + col,
                        make_int4(acc[f][0][e], acc[f][0][2 + e],
                                  acc[f][1][e], acc[f][1][2 + e]),
                        ws, xscale[ml]);
          }
      }
      continue;
    }
    // ks > 1: the partial tile [MP][kCols] of split ki into the workspace
    const int tile = t.mt * col_tiles + t.ct;
    constexpr int kTileInts = MP * kCols;
    int* parts = part + static_cast<int64_t>(tile) * ks * kTileInts;
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ml = 8 * f + 2 * t4 + e;
        if (col < n && row0 + ml < m)
          *reinterpret_cast<int4*>(parts + t.ki * kTileInts + ml * kCols +
                                   col_l) =
              make_int4(acc[f][0][e], acc[f][0][2 + e], acc[f][1][e],
                        acc[f][1][2 + e]);
      }
    // one thread counts for the block, after the block's barrier: its
    // release publishes the block's partial, its acquire (the last
    // split's) the others' (the pattern of a split-K semaphore)
    named_bar_sync(kMeetBar, kConsumers);
    if (tid == 0) last = atom_add_acq_rel(count + tile, 1) == ks - 1;
    named_bar_sync(kMeetBar, kConsumers);
    if (!last) continue;
    // the last split: a thread a quad of 4 columns of a row, its ks
    // partials read 8 at a time, all in flight together
    for (int u = tid; u < MP * (kCols / 4); u += kConsumers) {
      const int ml = u / (kCols / 4), c4 = 4 * (u % (kCols / 4));
      const int cu = t.ct * kCols + c4;
      if (row0 + ml >= m || cu >= n) continue;
      const int* src = parts + ml * kCols + c4;
      int4 v = make_int4(0, 0, 0, 0);
      for (int j0 = 0; j0 < ks; j0 += 8) {
        int4 p[8];
#pragma unroll
        for (int u8 = 0; u8 < 8; ++u8)
          p[u8] = j0 + u8 < ks
                      ? __ldcg(reinterpret_cast<const int4*>(
                            src + (j0 + u8) * kTileInts))
                      : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int u8 = 0; u8 < 8; ++u8) {
          v.x += p[u8].x;
          v.y += p[u8].y;
          v.z += p[u8].z;
          v.w += p[u8].w;
        }
      }
      write_out(out + static_cast<int64_t>(row0 + ml) * n + cu, v,
                *reinterpret_cast<const float4*>(w_scale + cu), xscale[ml]);
    }
    if (tid == 0) count[tile] = 0;  // every split has counted
  }
}

// Opts the kernel into its dynamic shared memory past 48 KB on the current
// device, once a device (the attribute is a device's).
template <int F, typename T>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(w8a8_mma_kernel<F, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<F>());
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int F, typename T>
int launch(const void* x, const CUtensorMap& map, const float* w_scale, int m,
           int k, int n, int ks, int grid, int* part, int* count, void* out,
           cudaStream_t stream) {
  const cudaError_t opt_in = allow_smem<F, T>();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  w8a8_mma_kernel<F, T><<<grid, kThreads, smem_bytes<F>(), stream>>>(
      static_cast<const T*>(x), map, w_scale, m, k, n, ks, part, count,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int F, typename T>
int resident(int* blocks) {
  cudaError_t err = allow_smem<F, T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, w8a8_mma_kernel<F, T>, kThreads, smem_bytes<F>());
  return static_cast<int>(err);
}

// Fragments of 8 activation rows an m tile takes for m rows.
inline int frags(int m) { return m <= 8 ? 1 : m <= 16 ? 2 : 4; }

template <typename T, class Fn>
int by_frags(int m, const Fn& fn) {
  switch (frags(m)) {
    case 1: return fn.template run<1, T>();
    case 2: return fn.template run<2, T>();
    default: return fn.template run<4, T>();
  }
}

struct Launch {
  const void* x;
  const CUtensorMap& map;
  const float* w_scale;
  int m, k, n, ks, grid;
  int* part;
  int* count;
  void* out;
  cudaStream_t stream;
  template <int F, typename T>
  int run() const {
    return launch<F, T>(x, map, w_scale, m, k, n, ks, grid, part, count, out,
                        stream);
  }
};

struct Resident {
  int* blocks;
  template <int F, typename T>
  int run() const { return resident<F, T>(blocks); }
};

}  // namespace w8

}  // namespace


extern "C" {

// x [M, K] bf16 (x_f32 = 0) or float32 (x_f32 = 1); w [K, N] int8; scale [N]
// float32; out [M, N] in x's dtype. K a multiple of 64 and of 64 * k_split,
// N a multiple of 16. With k_split > 1, partial holds k_split * M * N floats.
// Returns the CUDA error code of the launches.
int int8_matmul(const void* x, int x_f32, const int8_t* w, const float* scale,
                int m, int k, int n, int k_split, float* partial, void* out,
                void* stream) {
  if (m < 1 || k < kBK || k % (kBK * k_split) != 0 || n < 16 || n % 16 != 0 ||
      k_split < 1 || (k_split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return by_tile<float>(x, w, scale, m, k, n, k_split, partial, out, st);
  return by_tile<__nv_bfloat16>(x, w, scale, m, k, n, k_split, partial, out,
                                st);
}

// The tensor map of w [k, n] int8 (n a multiple of 16, 16-byte aligned)
// for int8_matmul_w8a8: boxes of 64 rows x 128 columns, 128-byte swizzle,
// into the sizeof(CUtensorMap) = 128 bytes at `map`. Returns the CUDA
// error code.
int w8a8_encode(const void* w, int k, int n, void* map) {
  if (map == nullptr || k < w8::kRows || n < 16 || n % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mp;
  const int err = hopper_host::encode_2d(
      &mp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, static_cast<uint64_t>(n),
      static_cast<uint64_t>(k), w8::kCols, w8::kRows, 128);
  if (err == 0) memcpy(map, &mp, sizeof(CUtensorMap));
  return err;
}

// Blocks of the W8A8 kernel for m activation rows (bf16 x, or float32
// when x_f32) that one SM keeps resident, into *blocks. Returns the CUDA
// error code.
int w8a8_resident(int m, int x_f32, int* blocks) {
  if (m < 1 || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const w8::Resident r{blocks};
  return x_f32 ? w8::by_frags<float>(m, r)
               : w8::by_frags<__nv_bfloat16>(m, r);
}

// y = W8A8(x, w) in one launch: x [M, K] bf16 (x_f32 = 0) or float32
// (x_f32 = 1), quantized per row inside the kernel; w [K, N] int8 through
// w_map (w8a8_encode); w_scale [N] float32; out [M, N] in x's dtype; all
// 16-byte aligned. K a multiple of 64, N of 16. The contraction is cut into
// k_split parts of whole 64-row stages (1 <= k_split <= K / 64); `grid`
// blocks walk the items (m tile, 128-column tile, split). With k_split > 1,
// part holds tiles * k_split * 8F * 128 int32 and count `tiles` int32
// zeros (left zero by the launch), tiles = ceil(M / 8F) * ceil(N / 128), F
// = 1, 2 or 4 for M <= 8, <= 16, more. Returns the CUDA error code of the
// launch.
int int8_matmul_w8a8(const void* x, int x_f32, const void* w_map,
                     const float* w_scale, int m, int k, int n, int k_split,
                     int grid, int* part, int* count, void* out,
                     void* stream) {
  if (m < 1 || k < w8::kRows || k % w8::kRows != 0 || n < 16 ||
      n % 16 != 0 || k_split < 1 || k_split > k / w8::kRows || grid < 1 ||
      w_map == nullptr ||
      (k_split > 1 && (part == nullptr || count == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_scale) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memcpy(&map, w_map, sizeof(CUtensorMap));
  const w8::Launch l{x, map, w_scale, m, k, n, k_split, grid, part, count,
                     out, static_cast<cudaStream_t>(stream)};
  return x_f32 ? w8::by_frags<float>(m, l) : w8::by_frags<__nv_bfloat16>(m, l);
}

}  // extern "C"
