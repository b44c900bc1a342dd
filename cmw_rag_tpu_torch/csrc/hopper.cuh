// Hopper (sm_90a) building blocks of the port's hand-written kernels: the
// mbarrier ring, TMA tensor loads with the host-side tensor-map encoding,
// bulk copies, wgmma (shared-memory descriptors, fence, commit, wait and
// the products used) and the int8 mma.sync. Header-only; a source that includes it is
// rebuilt when it changes (cuda_build hashes quoted headers).
//
// Shared-memory tiles are laid out as TMA writes them with a 128-, 64- or
// 32-byte swizzle: a [rows, cols] bf16 tile whose row is wider than the
// swizzle span is stored as column chunks of span / 2 elements, each chunk
// [rows][span] with rows contiguous, so that one TMA box (at most one span
// wide) fills one chunk. Every chunk starts on a 1024-byte boundary, which
// keeps the descriptors' base offset 0.

#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// async proxy (TMA); follow it with a block-wide barrier.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Tells the barrier to expect `bytes` more from TMA or bulk copies, without
// an arrival (the arrival may follow the copies it counts).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A wait
// that never ends (a broken ring) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 28)) __trap();
  }
}

// A ring of `Stages` buffers: full[s] completes when stage s's copies have
// landed, empty[s] when its consumers are done with it. Use number i (0, 1,
// 2, ...) goes to stage i % Stages; its full wait has parity
// (i / Stages) & 1, and the producer, before refilling a stage for use
// i >= Stages, waits for empty with parity (i / Stages - 1) & 1.
template <int Stages>
struct Ring {
  uint64_t full[Stages];
  uint64_t empty[Stages];

  __device__ __forceinline__ void init(uint32_t consumers) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  __device__ __forceinline__ static int stage(int i) { return i % Stages; }
  __device__ __forceinline__ static uint32_t parity(int i) {
    return static_cast<uint32_t>(i / Stages) & 1u;
  }
  __device__ __forceinline__ void wait_full(int i) {
    mbar_wait(&full[stage(i)], parity(i));
  }
  __device__ __forceinline__ void wait_empty(int i) {  // i >= Stages
    mbar_wait(&empty[stage(i)], parity(i) ^ 1u);
  }
  __device__ __forceinline__ void release(int i) { mbar_arrive(&empty[stage(i)]); }
};

// Orders this thread's earlier shared-memory writes before later async-proxy
// (TMA) accesses of the same bytes, such as a refill of a ring stage.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers (ids 1-15; 0 is __syncthreads): `threads` threads in all,
// each warp either waiting (sync) or only signalling (arrive).
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 3-D map, at element coordinates (c0 innermost), into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D map, at element coordinates (c0 innermost), into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory
// (both 16-byte aligned) by the bulk-copy engine; they complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (multiples of 16) and the swizzle span (128, 64, 32 or 0 bytes).
// K-major tiles: LBO unused (16), SBO = 8 rows x span. MN-major tiles
// (transposed B): LBO = the stride between column chunks, SBO = the stride
// between groups of 8 K rows (8 x span).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1 : swizzle == 64 ? 2
                        : swizzle == 32 ? 3 : 0;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | layout << 62;
}

// A descriptor moved `bytes` further into shared memory (no carry out of the
// 14-bit address field: shared memory is under 256 KB).
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(Pending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Register r of an m64nN float32 accumulator, in warp w (0-3) of the
// warpgroup, lane l: row 16 w + l / 4 + 8 ((r / 2) % 2), column
// 8 (r / 4) + 2 (l % 4) + r % 2. The A fragment of an m64k16 register
// operand is the same for two adjacent 8-column blocks: {a0, a1, a2, a3} =
// accumulator registers {0,1}, {2,3}, {4,5}, {6,7} of the 16 columns,
// each pair packed low-first into bf16x2.

// d[32] (+)= A[64, 16] B[16, 64]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[16] += A[64, 16] B[16, 32]: A from registers (the m16k16 layout of each
// warp's 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[32] += A[64, 16] B[16, 64]: A from registers (the m16k16 layout of each
// warp's 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64] += A[64, 16] B[16, 128]: A from registers (the m16k16 layout of each
// warp's 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// ------------------------------------------------------------- mma.sync

// d += A[16, 32] B[32, 8], s8 x s8 -> s32, exact (mma.sync m16n8k32; the
// fragments as the PTX ISA lays them out: lane l, g = l / 4, t = l % 4;
// a[0] = A[g][4t .. 4t + 3], a[1] = A[g + 8][4t ..], a[2] = A[g][16 + 4t ..],
// a[3] = A[g + 8][16 + 4t ..]; b0 = B[4t .. 4t + 3][g], b1 = B[16 + 4t ..][g];
// d = D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]; the lowest
// byte of a register holds the lowest k).
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace hopper

// ------------------------------------------------------ host: tensor maps

namespace hopper_host {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that the
// library needs no -lcuda; null where the installed CUDA has none.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return
        static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [d2, d1, d0] tensor (d0 innermost) of
// `elem`-byte elements of type `type`, with boxes of [box2, box1, box0] and
// the given swizzle span in bytes (box0 * elem must not exceed it). Returns
// a cudaError_t code (0 on success).
inline int encode_3d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                     const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t box0, uint32_t box1, uint32_t box2,
                     int swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};  // dims 1, 2
  const cuuint32_t box[3] = {box0, box1, box2};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
    : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
    : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 2-D map over a contiguous [d1, d0] tensor (d0 innermost) of `elem`-byte
// elements of type `type`, with boxes of [box1, box0] and the given swizzle
// span in bytes (box0 * elem must not exceed it; d0 * elem a multiple of
// 16). Returns a cudaError_t code (0 on success).
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                     const void* base, uint64_t d0, uint64_t d1,
                     uint32_t box0, uint32_t box1, int swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * elem};  // dim 1
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapSwizzle sw =
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
    : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
    : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 3-D map over a contiguous bf16 [d2, d1, d0] tensor with boxes of
// [1, box1, box0] (encode_3d).
inline int encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0,
                          uint64_t d1, uint64_t d2, uint32_t box0,
                          uint32_t box1, int swizzle) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, d0, d1, d2,
                   box0, box1, 1, swizzle);
}

}  // namespace hopper_host
