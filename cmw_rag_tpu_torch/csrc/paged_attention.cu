// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels of cmw_rag_tpu/ops/paged_attention.py:
//   :469 paged_decode_attention_dma (body _paged_dma_kernel :322);
//   :559 paged_decode_attention_dma_scatter (body _paged_dma_scatter_kernel
//        :521: this step's K/V row written into the pool first);
//   :858 paged_decode_attention_dma_kv_int8 (body _paged_dma_int8_kernel
//        :685: int8 pages with page-granular f32 scales);
// and two other TPU schedules of the same function, :641
// paged_decode_attention (_paged_kernel :64) and :187
// paged_decode_attention_pooled (_paged_wl_kernel :121).
//
// Function, one query token per slot s and query head h, over one layer of
// a paged pool [P, page, Hkv, Dh]: KV head g = h / rep (rep = Hq / Hkv);
// position pos of the slot lives in page tables[s, pos / page], row
// pos % page. Over pos < lens[s]: score = (q . k) / sqrt(Dh) in fp32 (int8:
// times the page's K scale), softmax in fp32, o = sum p * v in fp32 (int8:
// times the page's V scale), written as bf16. Rows at or past lens[s] are
// never read, so stale or NaN rows of a preempted request cannot leak (the
// TPU zeroes them with a where, because NaN * 0 is NaN).
//
// Fused write (bf16): split 0 of block (g, s) stores k_new[s, g] and
// v_new[s, g] into pool row (page_idx[s], off[s]); the block that reaches
// position lens[s] - 1 takes that row from k_new / v_new, not from the
// pool. The caller guarantees that (page_idx[s], off[s]) is position
// lens[s] - 1 of slot s and that active slots write distinct rows. The
// engine does: an active slot writes its own next row; an idle slot writes
// row 0 of the null page 0 and reads only that position, so idle slots race
// on a row whose attention output nobody samples. So no block reads a row
// that another block writes, and nothing waits between blocks.
//
// What bounds it: bytes. Each (slot, KV head) reads K and V of its used
// pages once, 2 * lens * Dh * (2 or 1) bytes, for about 4 * rep * Dh
// operations a position: ~2 operations a byte at rep 2, far under the
// H100's ~295. At 4 slots x 2048 positions x 8 KV heads x Dh 128, bf16,
// that is 33.5 MB, 10 us at 3.35 TB/s.
//
// Design (simple first): one block of 128 threads per (KV head, slot, page
// range). (KV head, slot) alone gives Hkv * S blocks, 32 at 4 slots, a
// quarter of the SMs, so the caller cuts each slot's page list into ranges
// until there are about two blocks per SM; each range writes its running
// max, sum and [rep, Dh] accumulator to scratch and a combine launch merges
// the ranges (with one range the block writes the output itself). In a
// page, Dh / 16 bytes threads share a row, each with one 16-byte load (8
// bf16 or 16 int8 values), four rows in flight per thread; the rep query
// heads of the KV head are scored together from registers and summed with
// shuffles; scores go to shared memory, one warp per head updates the
// running max and sum and turns the scores into probabilities, then every
// thread folds its rows of V into a [rep, 16-byte slice] register
// accumulator. The row groups' accumulators meet in shared memory at the
// end. A cp.async or TMA ring and a wider split are later work.
// Takes Dh in {64, 128}, rep in {1, 2, 4, 8}, page <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPage = 256;
constexpr int kUnroll = 4;  // rows in flight per thread

template <typename T>
struct Row;

template <>
struct Row<__nv_bfloat16> {
  static constexpr int kElems = 8;  // values in 16 bytes
  __device__ static void cvt(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Row<int8_t> {
  static constexpr int kElems = 16;
  __device__ static void cvt(const uint4& u, float* f) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
  }
};

struct Args {
  const void* q;        // [S, Hq, Dh] bf16
  void* k_pool;         // this layer: [P, page, Hkv, Dh]
  void* v_pool;
  const float* k_scale;  // this layer: [P, Hkv] (int8) or null
  const float* v_scale;
  const int* tables;    // [S, maxp]
  const int* lens;      // [S]
  const void* k_new;    // [S, Hkv, Dh] bf16 or null (no fused write)
  const void* v_new;
  const int* page_idx;  // [S]
  const int* off;       // [S]
  int s, hkv, page, maxp, pps;
  float* partial;       // [S, Hkv, n_split, rep, Dh + 2] when n_split > 1
  void* out;            // [S, Hq, Dh] bf16
  cudaStream_t stream;
};

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
                    const int* __restrict__ off, int hkv, int page, int maxp,
                    int pps, float inv_sqrt_dh, float* __restrict__ partial,
                    __nv_bfloat16* __restrict__ out) {
  using R = Row<T>;
  constexpr int E = R::kElems;
  constexpr int TPR = DH / E;          // threads sharing a row
  constexpr int NG = kThreads / TPR;   // rows per pass
  static_assert(32 % TPR == 0, "a row's threads must share a warp");

  __shared__ float sc[REP * kMaxPage];  // scores, then probabilities
  __shared__ float m_sh[REP], l_sh[REP], a_sh[REP];
  __shared__ float red[NG * DH];

  const int g = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % TPR, rg = tid / TPR;
  const int hq = hkv * REP;
  const int64_t row_stride = static_cast<int64_t>(hkv) * DH;
  const int64_t page_stride = row_stride * page;
  const int len = lens[s];
  const bool fused = k_new != nullptr;
  const __nv_bfloat16* kn = nullptr;
  const __nv_bfloat16* vn = nullptr;

  if constexpr (sizeof(T) == 2) {
    if (fused) {
      kn = k_new + (static_cast<int64_t>(s) * hkv + g) * DH;
      vn = v_new + (static_cast<int64_t>(s) * hkv + g) * DH;
      if (split == 0) {
        const int64_t dst = page_idx[s] * page_stride +
                            static_cast<int64_t>(off[s]) * row_stride + g * DH;
        for (int i = tid; i < DH / 8; i += kThreads) {
          reinterpret_cast<uint4*>(k_pool + dst)[i] =
              reinterpret_cast<const uint4*>(kn)[i];
          reinterpret_cast<uint4*>(v_pool + dst)[i] =
              reinterpret_cast<const uint4*>(vn)[i];
        }
      }
    }
  }

  float qf[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const __nv_bfloat16* qr =
        q + (static_cast<int64_t>(s) * hq + g * REP + r) * DH + c * E;
#pragma unroll
    for (int i = 0; i < E; i += 8)
      Row<__nv_bfloat16>::cvt(*reinterpret_cast<const uint4*>(qr + i),
                              &qf[r][i]);
  }
  float acc[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  if (tid < REP) {
    m_sh[tid] = -INFINITY;
    l_sh[tid] = 0.f;
  }

  const int n_pages = (len + page - 1) / page;
  const int p0 = split * pps;
  const int p1 = min(n_pages, p0 + pps);
  for (int j = p0; j < p1; ++j) {
    const int phys = tables[static_cast<int64_t>(s) * maxp + j];
    const int64_t base = phys * page_stride + g * DH + c * E;
    const int rows = min(page, len - j * page);
    // the row of position len - 1 comes from k_new / v_new when fused
    const int sub = fused ? len - 1 - j * page : -1;
    float ks = 1.f, vs = 1.f;
    if (k_scale != nullptr) {
      ks = k_scale[static_cast<int64_t>(phys) * hkv + g];
      vs = v_scale[static_cast<int64_t>(phys) * hkv + g];
    }

    for (int r0 = 0; r0 < rows; r0 += NG * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r0 + u * NG + rg;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (row == sub)
          raw[u] = *reinterpret_cast<const uint4*>(kn + c * E);
        else if (row < rows)
          raw[u] = *reinterpret_cast<const uint4*>(k_pool + base +
                                                    row * row_stride);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[E];
        R::cvt(raw[u], kf);
        float d[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) t = fmaf(qf[r][e], kf[e], t);
          d[r] = t;
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
#pragma unroll
          for (int r = 0; r < REP; ++r)
            d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
        const int row = r0 + u * NG + rg;
        if (c == 0 && row < rows)
#pragma unroll
          for (int r = 0; r < REP; ++r)
            sc[r * kMaxPage + row] = d[r] * ks * inv_sqrt_dh;
      }
    }
    __syncthreads();

    for (int r = warp; r < REP; r += kWarps) {
      float* sr = sc + r * kMaxPage;
      float mx = -INFINITY;
      for (int i = lane; i < rows; i += 32) mx = fmaxf(mx, sr[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < rows; i += 32) {
        const float p = expf(sr[i] - m_new);
        sr[i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        m_sh[r] = m_new;
        l_sh[r] = l_sh[r] * alpha + sum;
        a_sh[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float a = a_sh[r];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= a;
    }
    for (int r0 = 0; r0 < rows; r0 += NG * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r0 + u * NG + rg;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (row == sub)
          raw[u] = *reinterpret_cast<const uint4*>(vn + c * E);
        else if (row < rows)
          raw[u] = *reinterpret_cast<const uint4*>(v_pool + base +
                                                    row * row_stride);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r0 + u * NG + rg;
        if (row < rows) {  // rows past the length are skipped, not weighted 0
          float vf[E];
          R::cvt(raw[u], vf);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            const float p = sc[r * kMaxPage + row] * vs;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
          }
        }
      }
    }
    __syncthreads();  // the next page overwrites sc
  }

  const int64_t part =
      ((static_cast<int64_t>(s) * hkv + g) * n_split + split) * REP;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[rg * DH + c * E + e] = acc[r][e];
    __syncthreads();
    for (int d = tid; d < DH; d += kThreads) {
      float sum = 0.f;
      for (int i = 0; i < NG; ++i) sum += red[i * DH + d];
      if (partial != nullptr) {
        float* dst = partial + (part + r) * (DH + 2);
        if (d == 0) {
          dst[0] = m_sh[r];
          dst[1] = l_sh[r];
        }
        dst[2 + d] = sum;
      } else {
        out[(static_cast<int64_t>(s) * hq + g * REP + r) * DH + d] =
            __float2bfloat16(sum / fmaxf(l_sh[r], 1e-30f));
      }
    }
    __syncthreads();
  }
}

// Merges the page ranges of one (slot, query head): o = sum_i w_i acc_i /
// sum_i w_i l_i with w_i = exp(m_i - max_i m_i); an empty range has
// m_i = -inf and weight 0.
__global__ void combine_kernel(const float* __restrict__ partial, int n_split,
                               int hkv, int rep, int dh,
                               __nv_bfloat16* __restrict__ out) {
  const int sh = blockIdx.x;  // s * Hq + h
  const int hq = hkv * rep;
  const int s = sh / hq, h = sh % hq, g = h / rep, r = h % rep;
  const int64_t step = static_cast<int64_t>(rep) * (dh + 2);  // next range
  const float* base =
      partial + ((static_cast<int64_t>(s) * hkv + g) * n_split * rep + r) *
                    (dh + 2);
  float mx = -INFINITY;
  for (int i = 0; i < n_split; ++i) mx = fmaxf(mx, base[i * step]);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float m = base[i * step];
      if (m == -INFINITY) continue;
      const float w = expf(m - mx);
      num += w * base[i * step + 2 + d];
      den += w * base[i * step + 1];
    }
    out[static_cast<int64_t>(sh) * dh + d] =
        __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DH, int REP>
int launch(const Args& a) {
  const int n_split = (a.maxp + a.pps - 1) / a.pps;
  if (n_split > 1 && a.partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.hkv, a.s, n_split);
  auto* out = static_cast<__nv_bfloat16*>(a.out);
  paged_decode_kernel<T, DH, REP><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<T*>(a.k_pool),
      static_cast<T*>(a.v_pool), a.k_scale, a.v_scale, a.tables, a.lens,
      static_cast<const __nv_bfloat16*>(a.k_new),
      static_cast<const __nv_bfloat16*>(a.v_new), a.page_idx, a.off, a.hkv,
      a.page, a.maxp, a.pps, 1.0f / sqrtf(static_cast<float>(DH)),
      n_split > 1 ? a.partial : nullptr, out);
  if (n_split > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_kernel<<<a.s * a.hkv * REP, DH, 0, a.stream>>>(
        a.partial, n_split, a.hkv, REP, DH, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int by_rep(int rep, const Args& a) {
  switch (rep) {
    case 1: return launch<T, DH, 1>(a);
    case 2: return launch<T, DH, 2>(a);
    case 4: return launch<T, DH, 4>(a);
    case 8: return launch<T, DH, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int hq, int dh, const Args& a) {
  if (a.s < 1 || a.hkv < 1 || hq % a.hkv != 0 || a.page < 1 ||
      a.page > kMaxPage || a.maxp < 1 || a.pps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64: return by_rep<T, 64>(hq / a.hkv, a);
    case 128: return by_rep<T, 128>(hq / a.hkv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q [S, Hq, Dh] bf16; k_pool, v_pool: one layer [P, page, Hkv, Dh] bf16;
// tables [S, maxp], lens [S] int32. With k_new / v_new [S, Hkv, Dh] bf16 and
// page_idx / off [S] int32 (all non-null) this step's rows are written
// first; null pointers skip the write. pages_per_split cuts each slot's
// pages into ranges; with more than one range, partial holds
// S * Hkv * ceil(maxp / pages_per_split) * (Hq / Hkv) * (Dh + 2) floats.
// out [S, Hq, Dh] bf16. Returns the CUDA error code of the launches.
int paged_attention_bf16(const void* q, void* k_pool, void* v_pool,
                         const int* tables, const int* lens, const void* k_new,
                         const void* v_new, const int* page_idx,
                         const int* off, int s, int hq, int hkv, int dh,
                         int page, int maxp, int pages_per_split,
                         float* partial, void* out, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, tables, lens, k_new,
               v_new, page_idx, off, s, hkv, page, maxp, pages_per_split,
               partial, out, static_cast<cudaStream_t>(stream)};
  return dispatch<__nv_bfloat16>(hq, dh, a);
}

// The same over int8 pages with page-granular scales k_scale, v_scale
// [P, Hkv] float32 (one layer); no fused write.
int paged_attention_int8(const void* q, const void* k_pool,
                         const float* k_scale, const void* v_pool,
                         const float* v_scale, const int* tables,
                         const int* lens, int s, int hq, int hkv, int dh,
                         int page, int maxp, int pages_per_split,
                         float* partial, void* out, void* stream) {
  const Args a{q, const_cast<void*>(k_pool), const_cast<void*>(v_pool),
               k_scale, v_scale, tables, lens, nullptr, nullptr, nullptr,
               nullptr, s, hkv, page, maxp, pages_per_split, partial, out,
               static_cast<cudaStream_t>(stream)};
  return dispatch<int8_t>(hq, dh, a);
}

}  // extern "C"
