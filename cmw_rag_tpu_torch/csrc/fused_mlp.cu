// Fused int8 decode MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel cmw_rag_tpu/ops/fused_mlp.py:101 fused_mlp_int8
// (body _fused_mlp_kernel :59). Function, per row of S (the slots):
// x1 = x + (bf16(attn) @ wo) * wo_s in float32; y = bf16(x1 * rsqrt(mean(x1^2)
// + eps) * ffn_norm); g, u = (y @ w_gateup) * gateup_s in float32 (gate
// columns first in the one [D, 2F] buffer); h = bf16(silu(g) * u); out = x1 +
// (h @ down) * down_s, written as bf16. All weights int8 per output channel.
//
// What bounds it: bytes. At qwen3guard-0.6b's width (D 1024, A 2048, F 3072)
// the three products stream 2 MB + 6 MB + 3 MB of int8 weights, used S times
// each: 3.4 us at 3.35 TB/s.
//
// Design: ONE cooperative launch (cudaLaunchCooperativeKernel, every block
// resident, the grid sized by the occupancy query) that runs the phases of
// mlp_phases() in csrc/int8_decode.cuh with grid barriers between them: wo
// partial sums; the residual and the norm, one block a row; gate/up partial
// sums; the down product with h formed as it is loaded; the residual out.
// The TPU kernel streams d_ff blocks through one core in grid order; here
// every phase spreads its weight columns and a share of its contraction
// over all blocks, and the barriers give the order. A launch whose grid
// cannot be co-resident fails, and the failure is returned.

#include "int8_decode.cuh"

namespace {

using namespace i8d;

template <int MT>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const MlpArgs p, const __nv_bfloat16* __restrict__ attn) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  auto load_attn = [&](int m, int k) {
    return __bfloat162float(attn[static_cast<int64_t>(m) * p.a + k]);
  };
  mlp_phases<MT>(p, load_attn, smem, grid);
}

template <int MT>
int launch(const MlpArgs& p, const void* attn, cudaStream_t stream) {
  const int smem = tile_smem(MT);
  auto kern = fused_mlp_kernel<MT>;
  static const int blocks = cooperative_blocks(kern, smem);  // once
  if (blocks <= 0)
    return blocks < 0 ? -blocks
                      : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(attn);
  void* args[] = {const_cast<MlpArgs*>(&p), &a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), dim3(blocks), dim3(kThreads), args,
      smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int blocks_for() {
  return cooperative_blocks(fused_mlp_kernel<MT>, tile_smem(MT));
}

}  // namespace

extern "C" {

// Blocks of one cooperative launch for the row tile mt (4, 8, 16 or 32): the
// grid the contraction splits should fill. Negative: a CUDA error code.
int fused_mlp_blocks(int mt) {
  switch (mt) {
    case 4: return blocks_for<4>();
    case 8: return blocks_for<8>();
    case 16: return blocks_for<16>();
    case 32: return blocks_for<32>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [S, D] bf16, attn [S, A] bf16, wo_q [A, D], gateup_q [D, 2F], down_q
// [F, D] int8 with float32 scales and ffn_norm; D, A, F multiples of 64 and
// of 64 x their split (ks_wo over A, ks_gu over D, ks_dn over F). Scratch:
// part_a max(ks_wo, ks_dn) * S * D floats, part_b ks_gu * S * 2F, x1 and y
// S * D each. out [S, D] bf16. Returns the CUDA error code of the launch.
int fused_mlp_int8(const void* x, const void* attn, const int8_t* wo_q,
                   const float* wo_s, const float* ffn_norm,
                   const int8_t* gateup_q, const float* gateup_s,
                   const int8_t* down_q, const float* down_s, int s, int d,
                   int a, int f, float eps, int ks_wo, int ks_gu, int ks_dn,
                   float* part_a, float* part_b, float* x1, float* y,
                   void* out, void* stream) {
  if (s < 1 || ks_wo < 1 || ks_gu < 1 || ks_dn < 1 ||
      a % (kBK * ks_wo) != 0 || d % (kBK * ks_gu) != 0 ||
      f % (kBK * ks_dn) != 0 || d % kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpArgs p{static_cast<const __nv_bfloat16*>(x), wo_q, wo_s, ffn_norm,
                  gateup_q, gateup_s, down_q, down_s, s, d, a, f, eps, ks_wo,
                  ks_gu, ks_dn, part_a, part_b, x1, y,
                  static_cast<__nv_bfloat16*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 4) return launch<4>(p, attn, st);
  if (s <= 8) return launch<8>(p, attn, st);
  if (s <= 16) return launch<16>(p, attn, st);
  return launch<32>(p, attn, st);
}

}  // extern "C"
