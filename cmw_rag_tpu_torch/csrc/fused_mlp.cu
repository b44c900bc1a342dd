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
// Design: the back half of the decoder-layer megakernel, on the weight
// phases of csrc/weight_phases.cuh: ONE persistent cooperative launch, one
// block a SM of eight consumer warps and a producer warp that puts the
// block's weight stages of wo, gate/up and down in flight by TMA at kernel
// entry (maps cached per weight), mma.sync m16n8k16 bf16 products on the
// activations formed once in shared memory (bf16 attn, the FFN norm of x1,
// h), splits of the contraction merged by the last to arrive (x1 with its
// residual; h; the output with its residual), and two grid-wide waits: wo
// -> the FFN norm, gate/up -> down. The TPU kernel streams d_ff blocks
// through one core in grid order; here every product spreads its columns
// and a share of its contraction over all blocks, and the waits give the
// order. The host plan is ops/weight_phases.py mlp_plan. A launch whose
// grid cannot be co-resident fails, and the failure is returned.

#include "weight_phases.cuh"

namespace {

using namespace i8d;

template <int F>
__global__ void __launch_bounds__(kBlock, 1)
fused_mlp_kernel(const __grid_constant__ WeightArgs p) {
  constexpr int MT = 8 * F;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* act =
      reinterpret_cast<__nv_bfloat16*>(ring + p.ring * kStage);
  float* tb = reinterpret_cast<float*>(act + MT * kActRow);
  __shared__ uint64_t full[kMaxRing];
  __shared__ float rstd[MT];
  __shared__ int flag;
  __shared__ Product plan[4];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == kWarps) {
    produce(p, plan, ring, full);
    return;
  }
  Walk walk;  // consumer thread 0 refills the ring past its first stages
  const bool refill = consume_start(p, plan, walk);
  Block<F> blk{p, plan, ring, act, tb, full, rstd, &flag, walk, 0, refill,
               tid, lane, warp};
  blk.wo_phase();  // x1 = x + (attn @ wo) * wo_s
  grid.sync();     // wait 1: the FFN norm needs every column of x1
  blk.gu_phase();  // h = bf16(silu(g) * u)
  grid.sync();     // wait 2: down reads every column of h
  blk.dn_phase();  // out = x1 + (h @ down) * down_s
}

template <int F>
int blocks_for() {
  constexpr int MT = 8 * F;
  // the attribute at the most the plan may ask for, once
  static const int blocks =
      resident_blocks(fused_mlp_kernel<F>, layer_smem(MT, max_ring(MT)));
  return blocks;
}

template <int F>
int launch(const WeightArgs& p, int grid, cudaStream_t stream) {
  const int blocks = blocks_for<F>();
  if (blocks <= 0)
    return blocks < 0 ? -blocks
                      : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (grid > blocks || p.ring > max_ring(8 * F))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<WeightArgs*>(&p)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_mlp_kernel<F>), dim3(grid),
      dim3(kBlock), args, layer_smem(8 * F, p.ring), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of one cooperative launch for the row tile mt (8 or 16 rows; up to
// 8 rows take the 8-row kernel, past it the 16-row one), at the most shared
// memory the plan may give it (one block a SM): the grid of mlp_plan.
// Negative: a CUDA error code.
int fused_mlp_blocks(int mt) {
  if (mt != 8 && mt != 16) return -static_cast<int>(cudaErrorInvalidValue);
  return frags_of(mt) == 1 ? blocks_for<1>() : blocks_for<2>();
}

// The tensor map of a weight w [k, n] int8, as decoder_layer_encode of
// csrc/decoder_layer.cu (the maps are the same).
int fused_mlp_encode(const void* w, int k, int n, void* map) {
  return encode_weight(w, k, n, map);
}

// x [S, D] and attn [S, A] bf16 (16-byte aligned); wo_q [A, D], gateup_q
// [D, 2F], down_q [F, D] int8, read through the three tensor maps at `maps`
// (3 x 128 bytes in that order, fused_mlp_encode); wo_s, ffn_norm,
// gateup_s, down_s float32. S >= 1; D, A and F multiples of 64. The plan
// (ops/weight_phases.py mlp_plan): ks_wo, ks_gu and ks_dn split the
// contraction of the three products into parts of at most 16 stages of 64
// rows; `ring` stages of 8 KB (2 to the row tile's most); `grid` blocks (at
// most fused_mlp_blocks). Workspace (16-byte aligned): part the split
// partial tiles (for each product split more than once, row tiles x column
// tiles x ks x MT x 128 (gate/up 256) floats, MT the row tile), h S * F
// bf16, x1 S * D floats; counts the products' arrival counters (the most
// row tiles x column tiles of a product), int32 zeros that each launch
// leaves 0. out [S, D] bf16. Returns the CUDA error code of the launch.
int fused_mlp_int8(const void* x, const void* attn, const float* wo_s,
                   const float* ffn_norm, const float* gateup_s,
                   const float* down_s, int s, int d, int a, int f,
                   float eps, int ks_wo, int ks_gu, int ks_dn, float* part,
                   void* h, float* x1, void* out, const void* maps,
                   int* counts, int ring, int grid, void* stream) {
  if (s < 1 || d % kRows != 0 || a % kRows != 0 || f % kRows != 0 ||
      d < kRows || a < kRows || f < kRows || maps == nullptr ||
      counts == nullptr || ring < 2 || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(attn) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // columns, boxes a stage, splits, contraction rows, box 1's offset; no
  // QKV product
  const int spec[4][5] = {{0, 1, 1, kRows, 0},
                          {d, 1, ks_wo, a, 0},
                          {f, 2, ks_gu, d, f},
                          {d, 1, ks_dn, f, 0}};
  unsigned char four[4 * sizeof(CUtensorMap)] = {};
  memcpy(four + sizeof(CUtensorMap), maps, 3 * sizeof(CUtensorMap));
  WeightArgs p;
  memset(&p, 0, sizeof(p));
  p.s = s;
  if (set_products(p, spec, four, ring) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wo_in16 = static_cast<const __nv_bfloat16*>(attn);
  p.wo_s = wo_s;
  p.fnw = ffn_norm;
  p.gu_s = gateup_s;
  p.dn_s = down_s;
  p.part = part;
  p.h = static_cast<__nv_bfloat16*>(h);
  p.x1 = x1;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.tile_count = counts;
  p.d = d;
  p.a = a;
  p.f = f;
  p.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return frags_of(s) == 1 ? launch<1>(p, grid, st) : launch<2>(p, grid, st);
}

}  // extern "C"
