// Slot-major paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel cmw_rag_tpu/ops/paged_attention.py:1024
// paged_decode_attention_dma_slot (body _paged_dma_slot_kernel :1013 ->
// _slot_attn_inner :931). Function: one query token per slot s, the pool in
// the engine's partitioned layout (slot s's logical page j is physical page
// base0 + s * maxp_slot + j, contiguous per slot); slot s attends over its
// first min(lens[s], cap * page) positions of one layer [P, page, Hkv, Dh]
// bf16. Query head h reads KV head h / rep; scores (q . k) / sqrt(Dh) in
// float32, a float32 softmax, o = sum p v / sum p in float32, written as
// bf16. Rows at or past the length are never read.
//
// What bounds it: bytes, K and V of the real positions once: at 4 slots of
// 384 positions x 8 KV heads x Dh 128 in bf16, 6.3 MB, 1.9 us at 3.35 TB/s.
//
// Design: flash-decoding, attend_split() of csrc/int8_decode.cuh. One block
// of 256 threads per (KV head, slot, split of `split` positions): the grid
// is (Hkv, S, n_split) with n_split = ceil(cap * page / split) from the
// host's cap, so a slot's context is read by as many blocks as it has
// splits; blocks past the slot's length (on the device) return at once.
// The rep query heads of the KV head are scored together from 16-byte row
// loads, 64 rows a pass in flight at once. A slot of one split
// writes its output itself; otherwise the last of its splits to finish
// merges the partials (scratch `part`, counters `count` that the merging
// block sets back to 0) in split order, in the same launch. Shared memory
// is under the 48 KB a launch may take without opting in, so no attribute
// is set.

#include "int8_decode.cuh"

namespace {

using namespace i8d;

template <int DH>
__global__ void __launch_bounds__(kThreads)
slot_attention_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_pool,
                      const __nv_bfloat16* __restrict__ v_pool,
                      const int* __restrict__ lens, int hq, int hkv, int page,
                      int cap, int maxp_slot, int base0, int split,
                      float* part, int* count,
                      __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x, s = blockIdx.y, j = blockIdx.z;
  const int rep = hq / hkv;
  const int len = min(lens[s], cap * page);
  const int64_t head = static_cast<int64_t>(s) * hq * DH;
  const int pair = s * hkv + g;
  const Meet meet{
      gridDim.z > 1 ? part + static_cast<int64_t>(pair) * gridDim.z * rep *
                                 (DH + 2)
                    : nullptr,
      gridDim.z > 1 ? count + pair : nullptr};
  attend_split<DH>(q + head, g, rep, k_pool, v_pool, hkv, page,
                   SlotPages{base0 + static_cast<int64_t>(s) * maxp_slot}, len,
                   split, j, meet, out + head, smem);
}

template <int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* lens, int s, int hq, int hkv, int page, int cap,
           int maxp_slot, int base0, int split, int n_split, float* part,
           int* count, void* out, cudaStream_t stream) {
  static_assert(attend_smem(DH) <= 48 * 1024, "no opt-in needed");
  slot_attention_kernel<DH>
      <<<dim3(hkv, s, n_split), kThreads, attend_smem(DH), stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k_pool),
          static_cast<const __nv_bfloat16*>(v_pool), lens, hq, hkv, page,
          cap, maxp_slot, base0, split, part, count,
          static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [S, Hq, Dh] bf16; k_pool, v_pool: one layer [P, page, Hkv, Dh] bf16 in
// the partitioned layout; lens [S] int32; out [S, Hq, Dh] bf16. Dh 64 or
// 128, Hq / Hkv at most 8. Positions are cut into splits of `split` (1 to
// 128); n_split = ceil(cap * page / split) splits a (slot, KV head). With
// n_split > 1, part holds S * Hkv * n_split * (Hq / Hkv) * (Dh + 2) floats
// and count S * Hkv int32 zeros (left zero by the launch). Returns the CUDA
// error code of the launch.
int slot_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                        const int* lens, int s, int hq, int hkv, int dh,
                        int page, int cap, int maxp_slot, int base0,
                        int split, int n_split, float* part, int* count,
                        void* out, void* stream) {
  if (s < 1 || hkv < 1 || hq % hkv != 0 || hq / hkv > kMaxRep || page < 1 ||
      cap < 1 || split < 1 || split > kMaxSplit ||
      n_split != live_splits(cap * page, split) ||
      (n_split > 1 && (part == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64>(q, k_pool, v_pool, lens, s, hq, hkv, page, cap,
                        maxp_slot, base0, split, n_split, part, count, out,
                        st);
    case 128:
      return launch<128>(q, k_pool, v_pool, lens, s, hq, hkv, page, cap,
                         maxp_slot, base0, split, n_split, part, count, out,
                         st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
