// Exact top-k selection over per-query candidate lists, for Hopper (sm_90a):
// the k best (score descending, id ascending) of each query's candidates,
// in that order, any k >= 1; slots past the valid candidates hold
// (-3e38, -1). Candidates with id < 0 (or a score at or below -1.5e38)
// never surface. Ids must be unique within a query's candidates (a
// repeated row is dropped by whoever writes the candidates). Header-only;
// a source that includes it is rebuilt when it changes (cuda_build hashes
// quoted headers).
//
// Why not a merge of sorted lists: a k-way merge takes k rounds in a row on
// one block, so its serial length grows with k. Here no step on one SM
// grows with k except the sort of one slice of at most kSortMax survivors:
//   * Keys. A candidate's 64-bit key is the order-preserving image of its
//     float32 score (sign bit flipped for positives, every bit for
//     negatives; -0 read as +0) above 0x7fffffff - id, so the keys are
//     distinct and key order is (score desc, id asc) order.
//   * Radix select. C CTAs a query (a cooperative launch, so that all are
//     resident) each take a slice of the candidates. Pass p histograms
//     digit p (11, 11, 10 bits of each 32-bit half, high half first) of
//     the keys that still match the prefix chosen so far: shared-memory
//     counts, aggregated within a warp (__match_any_sync), added to the
//     query's global histogram with integer atomics. After a barrier among
//     the query's CTAs each CTA reads the same histogram and finds the same
//     bucket of the k-th key; the passes stop as soon as the bucket is
//     taken whole (at most 6 passes; ties at the k-th score are broken by
//     the id bits of the key in the later passes). The k best keys are
//     then exactly those at or above the threshold.
//   * Bytes: pass 0 and pass 1 read the candidates from device memory;
//     pass 1 also writes the keys above pass 0's bucket (survivors
//     whatever follows) and keeps the bucket's own keys in shared memory
//     (the stash, kStash a CTA) when this CTA's count of them, known from
//     pass 0, fits; later passes and the compaction then read the stash.
//   * Compaction: each CTA writes its survivors at positions from an
//     integer counter; their order there is arbitrary, the keys decide.
//   * Order: the survivors are cut into slices of a power of two (at most
//     kSortMax); each is sorted in shared memory by a bitonic sort (CTA c
//     takes slices c, c + C, ...). An element's place is its index in its
//     slice plus, for every other slice, the count of keys above it there
//     (a binary search; one thread per (element, other slice) pair).
// Every count is an integer and every key distinct, so two launches give
// the same bits.
//
// Workspace (from the caller, per stream): the histograms
// [queries, kPasses, kBins] and the counters [queries, 2] (barrier
// arrivals, survivors) must be zero when the selection starts; the kernel
// that writes the candidates clears them (select_k::clear), so a launch
// needs no memset. The survivors [queries, >= min(k, candidates)] u64.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace select_k {

constexpr int kThreads = 256;
constexpr int kBins = 2048;
constexpr int kPasses = 6;
constexpr int kSortMax = 2048;
constexpr int kStash = 8192;                // in-play keys a CTA keeps
constexpr int kUnroll = 16;                 // candidates a thread loads at once
constexpr int kStep = kUnroll * kThreads;
constexpr float kNegInf = -3.0e38f;

struct Args {
  const float* scores;   // [queries, score_stride]
  int64_t score_stride;
  const int* ids;        // [queries or 1, id_stride]; id_stride 0: shared
  int64_t id_stride;
  int64_t m;             // candidates a query
  const int* m_lim;      // null, or candidates = min(m, *m_lim * m_mult)
  int m_mult;
  int k;
  uint32_t* hist;        // [queries, kPasses, kBins], zero at launch
  uint32_t* counts;      // [queries, 2], zero at launch
  uint64_t* surv;        // [queries, surv_stride]
  int64_t surv_stride;   // >= min(k, candidates)
  float* out_s;          // [queries, k]
  int* out_i;
  int q0;                // the first query of this launch
};

// Words of the histograms and counters a query needs cleared.
__host__ __device__ constexpr int64_t clear_words() {
  return static_cast<int64_t>(kPasses) * kBins + 2;
}

// Zero the histograms and counters of `queries` queries; thread `tid` of
// `threads` in all (any grid shape that covers them).
__device__ __forceinline__ void clear(uint32_t* hist, uint32_t* counts,
                                      int queries, int64_t tid,
                                      int64_t threads) {
  const int64_t nh = static_cast<int64_t>(queries) * kPasses * kBins;
  for (int64_t i = tid; i < nh + 2 * queries; i += threads) {
    if (i < nh) hist[i] = 0u; else counts[i - nh] = 0u;
  }
}

// A candidate takes part unless its id is negative or its score is at or
// below half the empty slots' (-3e38), as the plain twins have it.
__device__ __forceinline__ bool valid(float s, int id) {
  return id >= 0 && s > 0.5f * kNegInf;
}

__device__ __forceinline__ uint64_t key_of(float s, int id) {
  uint32_t b = __float_as_uint(s);
  if ((b << 1) == 0u) b = 0u;                       // -0 is +0
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(o) << 32) |
         static_cast<uint32_t>(0x7fffffff - id);
}

__device__ __forceinline__ float score_of(uint64_t key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ int id_of(uint64_t key) {
  return 0x7fffffff - static_cast<int>(static_cast<uint32_t>(key));
}

// Digit p of a key: 11, 11 and 10 bits of each half, the high half first.
__device__ __forceinline__ int digit_shift(int p) {
  const int in_half = (p % 3) == 0 ? 21 : (p % 3) == 1 ? 10 : 0;
  return in_half + (p < 3 ? 32 : 0);
}
__device__ __forceinline__ int digit_bits(int p) { return (p % 3) == 2 ? 10 : 11; }

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier among the `ctas` CTAs of one query: `target` counts the arrivals
// so far (ctas per barrier).
__device__ __forceinline__ void query_sync(uint32_t* bar, uint32_t& target,
                                           uint32_t ctas) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += ctas;
    __threadfence();
    atomicAdd(bar, 1u);
    for (uint32_t spins = 0; ld_acquire(bar) < target; ++spins) {
      if (spins == (1u << 26)) __trap();   // a CTA that never arrives
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Keys of the walk's places base + u * kThreads + threadIdx.x (u <
// kUnroll) of n: from the stash, or candidates lo + place of the slice,
// loaded together so that their latencies overlap; ok false for an
// invalid candidate or past n.
__device__ __forceinline__ void walk_keys(bool stashed, const uint64_t* stash,
                                          const float* sc, const int* ids,
                                          int64_t lo, int64_t base, int64_t n,
                                          uint64_t (&key)[kUnroll],
                                          bool (&ok)[kUnroll]) {
  if (stashed) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      ok[u] = i < n;
      key[u] = ok[u] ? stash[i] : 0ull;
    }
    return;
  }
  float s[kUnroll];
  int id[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = base + u * kThreads + threadIdx.x;
    id[u] = i < n ? ids[lo + i] : -1;
    s[u] = i < n ? sc[lo + i] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    ok[u] = valid(s[u], id[u]);
    key[u] = key_of(s[u], id[u]);
  }
}

// Block-wide: over bins taken from the highest down (thread t holds bins
// kBins-1-8t .. kBins-8-8t), the bin where the running count first reaches
// `need`; writes (bin, count above it, its count, total) to dec[0..3].
__device__ __forceinline__ void find_bucket(const uint32_t* ghist, int64_t need,
                                            uint32_t* warp_sum,
                                            int64_t* dec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kPer = kBins / kThreads;
  uint32_t c[kPer];
  uint32_t local = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = __ldcg(ghist + (kBins - 1 - (kPer * tid + j)));
    local += c[j];
  }
  uint32_t incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  uint32_t before = 0, total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += warp_sum[w];
    total += warp_sum[w];
  }
  int64_t run = static_cast<int64_t>(before) + incl - local;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (run < need && need <= run + c[j]) {
      dec[0] = kBins - 1 - (kPer * tid + j);
      dec[1] = run;
      dec[2] = c[j];
    }
    run += c[j];
  }
  if (tid == 0) dec[3] = total;
  __syncthreads();
}

// Sorts buf[0, n) (n a power of two) in descending order.
__device__ __forceinline__ void bitonic_desc(uint64_t* buf, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const uint64_t a = buf[lo], b = buf[hi];
        if ((a < b) == desc) { buf[lo] = b; buf[hi] = a; }
      }
      __syncthreads();
    }
}

// Keys above `key` in the descending slice s[0, n) (global, written by
// other CTAs of this launch).
__device__ __forceinline__ int count_above(const uint64_t* s, int n,
                                           uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldcg(reinterpret_cast<const unsigned long long*>(s) + mid) > key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// grid (C CTAs a query, queries of this launch), kThreads threads; launched
// cooperatively so that a query's CTAs are all resident.
__global__ void __launch_bounds__(kThreads)
select_kernel(const Args a) {
  extern __shared__ uint64_t stash[];   // [kStash] in-play keys
  __shared__ int n_stash_sh;
  __shared__ uint32_t h[kBins];
  __shared__ uint64_t buf[kSortMax];
  __shared__ int rank[kSortMax];
  __shared__ uint32_t warp_sum[kThreads / 32];
  __shared__ int64_t dec[4];

  const int tid = threadIdx.x, lane = tid & 31;
  const int q = a.q0 + blockIdx.y, c = blockIdx.x, ctas = gridDim.x;
  int64_t m = a.m;
  if (a.m_lim != nullptr)
    m = imin(m, static_cast<int64_t>(max(0, *a.m_lim)) * a.m_mult);
  const float* sc = a.scores + q * a.score_stride;
  const int* ids = a.ids + q * a.id_stride;
  const int64_t lo = m * c / ctas, hi = m * (c + 1) / ctas;
  uint32_t* ghist = a.hist + static_cast<int64_t>(q) * kPasses * kBins;
  uint32_t* bar = a.counts + 2 * static_cast<int64_t>(q);
  uint32_t* n_surv = bar + 1;
  uint64_t* surv = a.surv + q * a.surv_stride;
  uint32_t target = 0;

  // The walk over this CTA's candidates: the slice in global memory, or
  // the stash of in-play keys in shared memory once it holds them
  // (walk_keys); every loop over it is warp-uniform.
  int n_stash = 0;
  bool stashed = false;
  // Writes each key with `keep` at the next place of the survivors.
  auto emit = [&](uint64_t key, bool keep) {
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    uint32_t at = 0;
    if (lane == 0 && ballot) at = atomicAdd(n_surv, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (keep) surv[at + __popc(ballot & ((1u << lane) - 1u))] = key;
  };

  // radix select of the threshold key. Pass 0 reads the slice; pass 1
  // reads it once more, writes the keys above pass 0's bucket (survivors
  // whatever follows) and keeps the bucket's keys in the stash when they
  // fit, so that later passes and the compaction read shared memory only.
  uint64_t prefix = 0, mask = 0, thresh = 0, prefix0 = 0, mask0 = 0;
  int64_t need = a.k, keff = 0;
  bool fits = false, pre = false;
  for (int p = 0; p < kPasses; ++p) {
    const int shift = digit_shift(p);
    const uint32_t dmask = (1u << digit_bits(p)) - 1u;
    for (int i = tid; i < kBins; i += kThreads) h[i] = 0u;
    if (tid == 0) n_stash_sh = 0;
    __syncthreads();
    const bool split_off = p == 1;
    const int64_t n_walk = stashed ? n_stash : hi - lo;
    for (int64_t base = 0; base < n_walk; base += kStep) {
      uint64_t key[kUnroll];
      bool ok[kUnroll];
      walk_keys(stashed, stash, sc, ids, lo, base, n_walk, key, ok);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = ok[u] && (key[u] & mask) == prefix;
        const uint32_t dig =
            in ? static_cast<uint32_t>(key[u] >> shift) & dmask : 0xffffffffu;
        const unsigned peers = __match_any_sync(0xffffffffu, dig);
        if (in && (__ffs(peers) - 1) == lane)
          atomicAdd(&h[dig], static_cast<uint32_t>(__popc(peers)));
        if (split_off) {
          emit(key[u], ok[u] && (key[u] & mask) > prefix);
          if (in && fits) stash[atomicAdd(&n_stash_sh, 1)] = key[u];
        }
      }
    }
    __syncthreads();
    if (split_off) {
      pre = true;
      stashed = fits;
      n_stash = n_stash_sh;
    }
    uint32_t* gh = ghist + p * kBins;
    for (int i = tid; i < kBins; i += kThreads)
      if (h[i]) atomicAdd(gh + i, h[i]);
    query_sync(bar, target, ctas);
    find_bucket(gh, need, warp_sum, dec);
    if (p == 0) {
      if (dec[3] <= need) {   // every valid candidate survives
        keff = dec[3];
        thresh = 0;
        break;
      }
      keff = need;
      fits = h[dec[0]] <= kStash;   // this CTA's keys in the bucket
    }
    prefix |= static_cast<uint64_t>(dec[0]) << shift;
    mask |= static_cast<uint64_t>(dmask) << shift;
    if (p == 0) {
      prefix0 = prefix;
      mask0 = mask;
    }
    need -= dec[1];
    if (need == dec[2]) {     // the bucket is taken whole
      thresh = prefix;
      break;
    }
  }

  // compaction of the survivors (key >= thresh) not written in pass 1
  const int64_t n_walk = stashed ? n_stash : hi - lo;
  for (int64_t base = 0; base < n_walk; base += kStep) {
    uint64_t key[kUnroll];
    bool ok[kUnroll];
    walk_keys(stashed, stash, sc, ids, lo, base, n_walk, key, ok);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      emit(key[u], ok[u] && key[u] >= thresh &&
                       (!pre || (key[u] & mask0) == prefix0));
  }
  query_sync(bar, target, ctas);

  // sort the slices
  int ch = 32;
  while (ch < kSortMax && static_cast<int64_t>(ch) * ctas < keff) ch <<= 1;
  const int64_t n_slices = (keff + ch - 1) / ch;
  for (int64_t j = c; j < n_slices; j += ctas) {
    const int64_t s0 = j * ch;
    const int n = static_cast<int>(imin(ch, keff - s0));
    for (int i = tid; i < ch; i += kThreads)
      buf[i] = i < n ? __ldcg(reinterpret_cast<const unsigned long long*>(
                                  surv) + s0 + i)
                     : 0ull;
    __syncthreads();
    bitonic_desc(buf, ch);
    for (int i = tid; i < n; i += kThreads) surv[s0 + i] = buf[i];
    __syncthreads();
  }
  query_sync(bar, target, ctas);

  // place every survivor
  float* out_s = a.out_s + static_cast<int64_t>(q) * a.k;
  int* out_i = a.out_i + static_cast<int64_t>(q) * a.k;
  for (int64_t j = c; j < n_slices; j += ctas) {
    const int64_t s0 = j * ch;
    const int n = static_cast<int>(imin(ch, keff - s0));
    for (int i = tid; i < n; i += kThreads) {
      buf[i] = __ldcg(reinterpret_cast<const unsigned long long*>(surv) +
                      s0 + i);
      rank[i] = i;
    }
    __syncthreads();
    const int64_t others = n_slices - 1;
    for (int64_t x = tid; x < n * others; x += kThreads) {
      const int i = static_cast<int>(x / others);
      int64_t o = x % others;
      if (o >= j) ++o;
      const int64_t o0 = o * ch;
      const int on = static_cast<int>(imin(ch, keff - o0));
      atomicAdd(&rank[i], count_above(surv + o0, on, buf[i]));
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      out_s[rank[i]] = score_of(buf[i]);
      out_i[rank[i]] = id_of(buf[i]);
    }
    __syncthreads();
  }
  for (int64_t r = keff + static_cast<int64_t>(c) * kThreads + tid; r < a.k;
       r += static_cast<int64_t>(ctas) * kThreads) {
    out_s[r] = kNegInf;
    out_i[r] = -1;
  }
}

constexpr int kStashBytes = kStash * 8;

// Blocks of select_kernel one SM keeps resident (cached per device; the
// first call also lets it take the stash's dynamic shared memory).
inline int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStashBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, select_kernel, kThreads, kStashBytes) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// Selects for queries [0, queries) with `ctas` CTAs a query, in launches of
// as many queries as can be resident at once. `a.q0` is set here.
inline cudaError_t launch(Args a, int queries, int ctas, cudaStream_t st) {
  const int cap = resident_blocks();
  if (cap < 1) return cudaErrorInvalidConfiguration;
  ctas = max(1, min(ctas, cap));
  const int per_launch = max(1, cap / ctas);
  for (int q0 = 0; q0 < queries; q0 += per_launch) {
    a.q0 = q0;
    const dim3 grid(ctas, min(per_launch, queries - q0));
    void* args[] = {&a};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&select_kernel), grid, dim3(kThreads), args,
        kStashBytes, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace select_k
