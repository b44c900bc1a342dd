// Weight-only int8 matmul for Hopper (sm_90a).
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

}  // extern "C"
