// Slot-major paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel cmw_rag_tpu/ops/paged_attention.py:1024
// paged_decode_attention_dma_slot (body _paged_dma_slot_kernel :1013 ->
// _slot_attn_inner :931). Function: one query token per slot s, the pool in
// the engine's partitioned layout (slot s's logical page j is physical page
// base0 + s * maxp_slot + j, contiguous per slot); slot s attends over its
// first min(lens[s], cap * page) positions of one layer [P, page, Hkv, Dh]
// bf16. Query head h reads KV head h / rep; scores (q . k) / sqrt(Dh) in
// float32, a single-pass float32 softmax (no running max or sum state while
// the context fits one chunk of scores, 1,024 positions), o = sum p v / sum
// p in float32, written as bf16. Rows at or past the length are never read.
//
// What bounds it: bytes, K and V of the real positions once: at 4 slots of
// 384 positions x 8 KV heads x Dh 128 in bf16, 6.3 MB, 1.9 us at 3.35 TB/s.
//
// Design: one block of 256 threads per (KV head, slot), the attend() of
// csrc/int8_decode.cuh: the rep query heads of the KV head are scored
// together from 16-byte row loads, the scores of the whole context sit in
// shared memory, then V is folded in. Splitting a slot's positions over
// blocks (as csrc/paged_attention.cu does) is later work: the TPU budget
// that routes contexts here keeps them at most 384 positions at
// qwen3guard-0.6b's width.

#include "int8_decode.cuh"

namespace {

using namespace i8d;

template <int DH>
__global__ void __launch_bounds__(kThreads)
slot_attention_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_pool,
                      const __nv_bfloat16* __restrict__ v_pool,
                      const int* __restrict__ lens, int hq, int hkv, int page,
                      int cap, int maxp_slot, int base0,
                      __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x, s = blockIdx.y;
  const int rep = hq / hkv;
  const int len = min(lens[s], cap * page);
  const int64_t head = static_cast<int64_t>(s) * hq * DH;
  attend<DH>(q + head, g, rep, k_pool, v_pool, hkv, page,
             SlotPages{base0 + static_cast<int64_t>(s) * maxp_slot}, len,
             out + head, smem);
}

template <int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* lens, int s, int hq, int hkv, int page, int cap,
           int maxp_slot, int base0, void* out, cudaStream_t stream) {
  const int smem = attend_smem(DH);
  auto kern = slot_attention_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(hkv, s), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), lens, hq, hkv, page, cap,
      maxp_slot, base0, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [S, Hq, Dh] bf16; k_pool, v_pool: one layer [P, page, Hkv, Dh] bf16 in
// the partitioned layout; lens [S] int32; out [S, Hq, Dh] bf16. Dh 64 or
// 128, Hq / Hkv at most 8. Returns the CUDA error code of the launch.
int slot_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                        const int* lens, int s, int hq, int hkv, int dh,
                        int page, int cap, int maxp_slot, int base0, void* out,
                        void* stream) {
  if (s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kMaxRep || page < 1 ||
      cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64>(q, k_pool, v_pool, lens, s, hq, hkv, page, cap,
                        maxp_slot, base0, out, st);
    case 128:
      return launch<128>(q, k_pool, v_pool, lens, s, hq, hkv, page, cap,
                         maxp_slot, base0, out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
