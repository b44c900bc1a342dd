// Device code shared by the int8-weight decode kernels for Hopper (sm_90a):
// csrc/slot_attention.cu includes it, and csrc/int8_matmul.cu, the fused
// MLP and the decoder-layer megakernels through csrc/weight_phases.cuh; the
// build hashes it with each (ops/cuda_build.py). It holds the block shape
// of 256 threads, the float <-> bf16 helpers, the warp reductions and one
// building block (the int8 weight products are weight_phases.cuh's):
//
// attend_split - decode attention for one (slot, KV head) cut over
//   positions (flash-decoding): a work item is split j of the slot's
//   context, positions [j * split, (j + 1) * split) with split at most
//   kMaxSplit (128), of the rep = Hq / Hkv query heads of that KV head,
//   position p in page page_of(p / page), row p % page. A slot's context is
//   walked by as many blocks as it has splits, not by one block in a serial
//   loop. Scores are float32 (q . k) / sqrt(Dh) kept in shared memory; each
//   split keeps its own max m_j, sum l_j of e^(s - m_j) and [rep, Dh]
//   float32 accumulator. A context of one split writes o = acc / l at once;
//   otherwise each split writes (m_j, l_j, acc_j) to float32 scratch and the
//   last split of the (slot, KV head) to finish (an integer counter, bumped
//   after a __threadfence, reset by that block) merges them in split order:
//   o = sum_j e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j, 1e-30), M the
//   largest m_j. No float atomics: two launches agree bit for bit. Only the
//   order of float32 sums differs from the TPU kernel's single pass. Rows
//   at or past len are never read, so stale or NaN rows cannot leak (the TPU
//   zeroes them with a where); a split past the length returns at once.
//   16-byte loads (8 bf16), Dh / 8 threads a row, 64 rows a pass in flight
//   at once (one pass for a split of 64, two for 128: all 128 rows at once
//   cost the megakernel registers, spills and time). Pool rows, scratch and
//   scales are read with ld.global.cg: the decoder-layer megakernel writes
//   this step's row earlier in the same launch, and L1 is not coherent
//   across SMs. int8
//   pools (the int8-KV megakernel) carry a float32 scale per (page, KV
//   head), [P, Hkv]: a score is (q . k_int8) * k_scale / sqrt(Dh) and a
//   probability is multiplied by v_scale before it weights v_int8, as the
//   TPU's int8 pipeline folds them (paged_attention.py:685); a thread loads
//   8 bytes (8 int8 values) of a row, so the layout of threads over a row
//   is the bf16 one.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace i8d {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;                    // query heads a KV head
constexpr int kMaxSplit = 128;                // positions of a split, at most
constexpr int kMaxRows = 256;                 // activation rows (norm scratch)

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Splits of a context of len positions cut into runs of `split`: those
// that hold a position under len, at least one (an empty context still
// writes its zero output).
__host__ __device__ constexpr int live_splits(int len, int split) {
  return len > split ? (len + split - 1) / split : 1;
}

// Shared-memory bytes of attend_split<DH>.
__host__ __device__ constexpr int attend_smem(int dh) {
  return (kMaxRep * dh + kMaxRep * kMaxSplit + 3 * kMaxRep +
          (kThreads / (dh / 8)) * dh) * 4;
}

// Slot-major page map: slot s's logical page j at base + j.
struct SlotPages {
  int64_t base;
  __device__ int64_t operator()(int j) const { return base + j; }
};

// Paged map: a row of the block table.
struct TablePages {
  const int* row;
  __device__ int64_t operator()(int j) const { return row[j]; }
};

// 8 values of a pool row: 16 bytes of bf16 or 8 bytes of int8, loaded raw
// with ld.global.cg (zeros when `live` is false) and turned into floats
// where they are used.
template <typename TP>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* pool, int64_t at,
                             bool live) {
    return live ? __ldcg(reinterpret_cast<const uint4*>(pool + at))
                : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ static void cvt(const Raw& u, float* f) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 t = __bfloat1622float2(h2[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  }
};

template <>
struct Row8<int8_t> {
  using Raw = uint2;
  __device__ static Raw load(const int8_t* pool, int64_t at, bool live) {
    return live ? __ldcg(reinterpret_cast<const uint2*>(pool + at))
                : make_uint2(0u, 0u);
  }
  __device__ static void cvt(const Raw& u, float* f) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = static_cast<float>(b[e]);
  }
};

// Where the splits of one (slot, KV head) meet: part [n_split][rep][DH + 2]
// floats (each split's m, l and acc) and a counter of the splits written.
// Null when the caller allots one split.
struct Meet {
  float* part;
  int* count;
};

// Split j of one (slot, KV head g): positions [j * split, (j + 1) * split)
// under len. q [Hq, DH] of the slot (float or bf16), pools of one layer
// [P, page, hkv, DH] bf16, or int8 with scales [P, hkv] (k_scale,
// v_scale; null for bf16), out [Hq, DH] of the slot. A split past the
// context returns at once; the only live split writes out itself; any
// other writes its partial, and the last of them to finish (a counter
// bumped after a fence) merges all of them into out in split order and sets
// the counter back to 0 for the next launch. Every thread of the block must
// call it. Uses attend_smem(DH) bytes of smem; split <= kMaxSplit.
template <int DH, typename TQ, typename TP, typename TO, class PageOf>
__device__ void attend_split(const TQ* q, int g, int rep, const TP* k_pool,
                             const TP* v_pool, int hkv, int page,
                             const PageOf& page_of, int len, int split, int j,
                             const Meet& meet, TO* out, float* smem,
                             const float* k_scale = nullptr,
                             const float* v_scale = nullptr) {
  constexpr int E = 8;           // values a thread loads of a row
  constexpr int TPR = DH / E;    // threads a row
  constexpr int NG = kThreads / TPR;  // rows a pass
  constexpr int U = 64 / NG;    // rows in flight a thread: 64 rows a pass
  static_assert(32 % TPR == 0, "a row's threads share a warp");
  static_assert(64 % NG == 0, "a pass is whole row groups");
  const int n_live = live_splits(len, split);
  if (j >= n_live) return;  // the same for the whole block
  float* q_s = smem;                        // [kMaxRep][DH]
  float* sc = q_s + kMaxRep * DH;           // [kMaxRep][kMaxSplit]
  float* m_sh = sc + kMaxRep * kMaxSplit;   // [kMaxRep]
  float* l_sh = m_sh + kMaxRep;
  int* last = reinterpret_cast<int*>(l_sh + kMaxRep);
  float* red = l_sh + 2 * kMaxRep;          // [NG][DH]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % TPR, rg = tid / TPR;
  const int64_t row_stride = static_cast<int64_t>(hkv) * DH;
  const int64_t page_stride = row_stride * page;
  const float inv_sqrt = rsqrtf(static_cast<float>(DH));
  const int p0 = j * split;
  const int rows = max(0, min(split, len - p0));

  for (int i = tid; i < rep * DH; i += kThreads)
    q_s[i] = to_f(__ldcg(q + static_cast<int64_t>(g) * rep * DH + i));
  __syncthreads();

  auto row_at = [&](int p) -> int64_t {
    return page_of(p / page) * page_stride + (p % page) * row_stride +
           g * DH + c * E;
  };
  // the page's scale of position p (1 for bf16 pools: d * 1 is d)
  auto scale_at = [&](const float* plane, int p, bool live) -> float {
    if (plane == nullptr || !live) return 1.f;
    return __ldcg(plane + page_of(p / page) * hkv + g);
  };

  for (int i0 = 0; i0 < rows; i0 += NG * U) {
    typename Row8<TP>::Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = i0 + u * NG + rg;
      raw[u] = Row8<TP>::load(k_pool, p < rows ? row_at(p0 + p) : 0,
                              p < rows);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * NG < rows) {  // the same for the whole block
        float kf[E];
        Row8<TP>::cvt(raw[u], kf);
        const int p = i0 + u * NG + rg;
        const float ks = scale_at(k_scale, p0 + p, p < rows);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float* qr = q_s + r * DH + c * E;
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qr[e], kf[e], d);
#pragma unroll
            for (int o = TPR / 2; o > 0; o >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, o);
            if (c == 0 && p < rows) sc[r * kMaxSplit + p] = d * ks * inv_sqrt;
          }
        }
      }
    }
  }
  __syncthreads();

  // the split's own softmax: m its largest score, l the sum of e^(s - m)
  for (int r = warp; r < rep; r += kWarps) {
    float* sr = sc + r * kMaxSplit;
    float mx = -INFINITY;
    for (int i = lane; i < rows; i += 32) mx = fmaxf(mx, sr[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < rows; i += 32) {
      const float pr = expf(sr[i] - mx);
      sr[i] = pr;
      sum += pr;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_sh[r] = mx;
      l_sh[r] = sum;
    }
  }
  __syncthreads();

  float acc[kMaxRep][E];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  for (int i0 = 0; i0 < rows; i0 += NG * U) {
    typename Row8<TP>::Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = i0 + u * NG + rg;
      raw[u] = Row8<TP>::load(v_pool, p < rows ? row_at(p0 + p) : 0,
                              p < rows);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = i0 + u * NG + rg;
      if (p < rows) {  // rows past the length are skipped, not weighted 0
        float vf[E];
        Row8<TP>::cvt(raw[u], vf);
        const float vs = scale_at(v_scale, p0 + p, true);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float pr = sc[r * kMaxSplit + p] * vs;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
          }
        }
      }
    }
  }

  // the row groups' sums meet in shared memory, in group order; one live
  // split writes o = acc / l, any other its partial (m, l, acc)
  const int stride = DH + 2;
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < E; ++e) red[rg * DH + c * E + e] = acc[r][e];
      __syncthreads();
      for (int d = tid; d < DH; d += kThreads) {
        float sum = 0.f;
        for (int i = 0; i < NG; ++i) sum += red[i * DH + d];
        if (n_live == 1) {
          from_f(sum / fmaxf(l_sh[r], 1e-30f),
                 out + (static_cast<int64_t>(g) * rep + r) * DH + d);
        } else {
          float* dst =
              meet.part + (static_cast<int64_t>(j) * rep + r) * stride;
          if (d == 0) {
            dst[0] = m_sh[r];
            dst[1] = l_sh[r];
          }
          dst[2 + d] = sum;
        }
      }
      __syncthreads();
    }
  }
  if (n_live == 1) return;

  // the last split to finish merges: o = sum_j w_j acc_j / sum_j w_j l_j,
  // w_j = e^(m_j - max m), j in order (no float atomics: runs repeat bit for
  // bit)
  __threadfence();  // this block's partial is visible before the count
  __syncthreads();
  if (tid == 0) *last = atomicAdd(meet.count, 1) == n_live - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < rep * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const float* src = meet.part + static_cast<int64_t>(r) * stride;
    const int64_t step = static_cast<int64_t>(rep) * stride;
    float mx = -INFINITY;
    for (int k = 0; k < n_live; ++k) mx = fmaxf(mx, __ldcg(src + k * step));
    float num = 0.f, den = 0.f;
    for (int k = 0; k < n_live; ++k) {
      const float m = __ldcg(src + k * step);
      const float w = m == -INFINITY ? 0.f : expf(m - mx);
      num += w * __ldcg(src + k * step + 2 + d);
      den += w * __ldcg(src + k * step + 1);
    }
    from_f(num / fmaxf(den, 1e-30f),
           out + (static_cast<int64_t>(g) * rep + r) * DH + d);
  }
  if (tid == 0) *meet.count = 0;  // every split of this launch has counted
}

namespace cg = cooperative_groups;

}  // namespace i8d
