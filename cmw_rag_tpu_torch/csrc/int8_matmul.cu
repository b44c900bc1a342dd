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

// Shared-memory bytes of w8a8_tile<MT>: the weight ring and MT activation
// rows as packs of 4 int8 a stage.
__host__ __device__ constexpr int w8a8_smem(int mt) {
  return kWBytes + kStages * (kBK / 4) * mt * 4;
}

// Exact int32 sums over k in [k0, k1) (a multiple of kBK) of xq[m, k] *
// w[k, n] for rows m0 <= m < min(m0 + MT, m_rows) and columns col0 <= n <
// col0 + kBN, n < n_cols; calls epi(m, n, sum) for each. xq is [m_rows, k]
// int8 (k a multiple of 64). Every thread of the block must call it.
template <int MT, class Epi>
__device__ void w8a8_tile(const int8_t* xq, int k, const int8_t* w,
                          int n_cols, int col0, int k0, int k1, int m0,
                          int m_rows, const Epi& epi, unsigned char* smem) {
  static_assert(MT % 4 == 0, "MT is a multiple of 4");
  constexpr int kQuads = kBK / 4;  // packs of 4 rows a stage, one a subset
  static_assert(kQuads == kKSub, "each row subset takes one pack a stage");
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  int* x_s = reinterpret_cast<int*>(smem + kWBytes);  // [stage][quad][MT]
  const int tid = threadIdx.x;
  const int colg = tid % kColGroups, sub = tid / kColGroups;
  const int n_iter = (k1 - k0) / kBK;

  auto issue = [&](int it) {
    const int stage = it % kStages;
    const int kb = k0 + it * kBK;
    for (int c = tid; c < kBK * kBN / 16; c += kThreads) {
      const int r = c / (kBN / 16), cc = (c % (kBN / 16)) * 16;
      int8_t* dst = w_s + (stage * kBK + r) * kBN + cc;
      if (col0 + cc < n_cols)
        cp_async16(dst, w + static_cast<int64_t>(kb + r) * n_cols + col0 + cc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e = tid; e < kQuads * MT; e += kThreads) {
      const int q4 = e / MT, m = e % MT;
      x_s[(stage * kQuads + q4) * MT + m] =
          m0 + m < m_rows
              ? *reinterpret_cast<const int*>(
                    xq + static_cast<int64_t>(m0 + m) * k + kb + 4 * q4)
              : 0;
    }
  };

  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_iter) issue(st);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed; everyone finished stage it - 1
    if (it + kStages - 1 < n_iter) issue(it + kStages - 1);
    cp_async_commit();
    const int stage = it % kStages;
    const int8_t* ws = w_s + (stage * kBK + 4 * sub) * kBN + colg * 4;
    const int* xs = x_s + (stage * kQuads + sub) * MT;
    const int w0 = *reinterpret_cast<const int*>(ws);
    const int w1 = *reinterpret_cast<const int*>(ws + kBN);
    const int w2 = *reinterpret_cast<const int*>(ws + 2 * kBN);
    const int w3 = *reinterpret_cast<const int*>(ws + 3 * kBN);
    // 4 rows x 4 columns of bytes -> 4 columns of 4 rows each
    const int lo01 = __byte_perm(w0, w1, 0x5140);
    const int hi01 = __byte_perm(w0, w1, 0x7362);
    const int lo23 = __byte_perm(w2, w3, 0x5140);
    const int hi23 = __byte_perm(w2, w3, 0x7362);
    const int col[4] = {static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                        static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
    for (int m = 0; m < MT; m += 4) {
      const int4 xv = *reinterpret_cast<const int4*>(xs + m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[m][j] = __dp4a(xv.x, col[j], acc[m][j]);
        acc[m + 1][j] = __dp4a(xv.y, col[j], acc[m + 1][j]);
        acc[m + 2][j] = __dp4a(xv.z, col[j], acc[m + 2][j]);
        acc[m + 3][j] = __dp4a(xv.w, col[j], acc[m + 3][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 16 row subsets meet in the (now idle) weight ring, 4 rows at a time
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mc = 0; mc < MT; mc += 4) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
      *reinterpret_cast<int4*>(red + (sub * 4 + mm) * kBN + colg * 4) =
          make_int4(acc[mc + mm][0], acc[mc + mm][1], acc[mc + mm][2],
                    acc[mc + mm][3]);
    __syncthreads();
    {
      const int mm = tid / kBN, c = tid % kBN;
      int sum = 0;
#pragma unroll
      for (int u = 0; u < kKSub; ++u) sum += red[(u * 4 + mm) * kBN + c];
      const int m = m0 + mc + mm, n = col0 + c;
      if (m < m_rows && n < n_cols) epi(m, n, sum);
    }
    __syncthreads();
  }
}

// y = (float(acc) * w_scale[n]) * x_scale[m] in T.
template <typename T>
__device__ __forceinline__ void w8a8_out(int acc, const float* w_scale,
                                         const float* x_scale, int mm, int nn,
                                         int n, T* out) {
  from_f((static_cast<float>(acc) * w_scale[nn]) * x_scale[mm],
         out + static_cast<int64_t>(mm) * n + nn);
}

template <int MT, typename T>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
            const int8_t* __restrict__ w, const float* __restrict__ w_scale,
            int m, int k, int n, int ks, int* __restrict__ partial,
            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Split sp = make_split(m, MT, n, k, ks);
  const int it = blockIdx.x;
  if (ks > 1) {
    const int ki = it % ks;
    const int ct = (it / ks) % sp.col_tiles;
    const int mt = it / (ks * sp.col_tiles);
    int* dst = partial + static_cast<int64_t>(ki) * m * n;
    w8a8_tile<MT>(xq, k, w, n, ct * kBN, ki * sp.k_per, (ki + 1) * sp.k_per,
                  mt * MT, m,
                  [&](int mm, int nn, int v) {
                    dst[static_cast<int64_t>(mm) * n + nn] = v;
                  },
                  smem);
  } else {
    const int ct = it % sp.col_tiles, mt = it / sp.col_tiles;
    w8a8_tile<MT>(xq, k, w, n, ct * kBN, 0, k, mt * MT, m,
                  [&](int mm, int nn, int v) {
                    w8a8_out(v, w_scale, x_scale, mm, nn, n, out);
                  },
                  smem);
  }
}

template <typename T>
__global__ void w8a8_combine_kernel(const int* __restrict__ partial,
                                    const float* __restrict__ x_scale,
                                    const float* __restrict__ w_scale, int m,
                                    int n, int ks, T* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = static_cast<int64_t>(m) * n;
  if (i >= total) return;
  int acc = 0;
  for (int s = 0; s < ks; ++s) acc += partial[s * total + i];
  w8a8_out(acc, w_scale, x_scale, static_cast<int>(i / n),
           static_cast<int>(i % n), n, out);
}

template <int MT, typename T>
int launch_w8a8(const int8_t* xq, const float* x_scale, const int8_t* w,
                const float* w_scale, int m, int k, int n, int ks,
                int* partial, void* out, cudaStream_t stream) {
  const int smem = w8a8_smem(MT);
  auto kern = w8a8_kernel<MT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = ((m + MT - 1) / MT) * ((n + kBN - 1) / kBN) * ks;
  kern<<<items, kThreads, smem, stream>>>(xq, x_scale, w, w_scale, m, k, n,
                                          ks, partial, static_cast<T*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(m) * n;
  w8a8_combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                           stream>>>(partial, x_scale, w_scale, m, n, ks,
                                     static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int w8a8_by_tile(const int8_t* xq, const float* x_scale, const int8_t* w,
                 const float* w_scale, int m, int k, int n, int ks,
                 int* partial, void* out, cudaStream_t stream) {
  if (m <= 4)
    return launch_w8a8<4, T>(xq, x_scale, w, w_scale, m, k, n, ks, partial,
                             out, stream);
  if (m <= 8)
    return launch_w8a8<8, T>(xq, x_scale, w, w_scale, m, k, n, ks, partial,
                             out, stream);
  if (m <= 16)
    return launch_w8a8<16, T>(xq, x_scale, w, w_scale, m, k, n, ks, partial,
                              out, stream);
  return launch_w8a8<32, T>(xq, x_scale, w, w_scale, m, k, n, ks, partial,
                            out, stream);
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

// xq [M, K] int8 and x_scale [M] float32 (the per-row quantized
// activations); w [K, N] int8; w_scale [N] float32; out [M, N] bf16
// (out_f32 = 0) or float32 (out_f32 = 1). K a multiple of 64 * k_split, N
// a multiple of 16. With k_split > 1, partial holds k_split * M * N int32.
// Returns the CUDA error code of the launches.
int int8_matmul_w8a8(const int8_t* xq, const float* x_scale, const int8_t* w,
                     const float* w_scale, int m, int k, int n, int k_split,
                     int* partial, void* out, int out_f32, void* stream) {
  if (m < 1 || k < kBK || k_split < 1 || k % (kBK * k_split) != 0 ||
      n < 16 || n % 16 != 0 || (k_split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return w8a8_by_tile<float>(xq, x_scale, w, w_scale, m, k, n, k_split,
                               partial, out, st);
  return w8a8_by_tile<__nv_bfloat16>(xq, x_scale, w, w_scale, m, k, n,
                                     k_split, partial, out, st);
}

}  // extern "C"
