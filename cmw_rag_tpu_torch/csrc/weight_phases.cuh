// The int8 weight phases of a decode layer for Hopper (sm_90a), shared by
// the decoder-layer megakernels (csrc/decoder_layer.cuh: QKV, wo, gate/up,
// down) and the fused MLP (csrc/fused_mlp.cu: wo, gate/up, down, the
// megakernel's back half). The build hashes this header with each source
// that includes it (ops/cuda_build.py); the host plan is
// ops/weight_phases.py.
//
// What bounds them: bytes. At qwen3guard-0.6b's width the layer's int8
// weights are 15.7 MB (the MLP's three 11 MB), each used S times. At
// decode's few rows the time goes to latency: the weights' first bytes,
// and the round trips of the phases that depend on each other.
//
// Design: ONE persistent cooperative launch, one block a SM of eight
// consumer warps and a producer warp (the grid is the host plan's, at most
// the co-resident blocks). Nine warps leave a thread 168 registers (three
// warps share a quarter of the register file); the code is written to need
// no more (no spills: scripts/kernel_resources.py).
// - The weight products are one list of work items, (row tile, column
//   tile, split of the contraction) of each product in phase order; block
//   b takes items b, b + grid, ... (the host plan picks the splits). The
//   list has four product slots, QKV, wo, gate/up and down; the fused MLP
//   leaves QKV empty. A gate/up item takes the gate tile and the up tile of
//   the same columns, so that its merge can form h.
// - Weights arrive by TMA (a 2-D map a weight, boxes of 64 rows x 128
//   columns, 128-byte swizzle, zero-filled past the edges; the host encodes
//   each map once and caches it) into a ring of 8 KB stages on mbarriers.
//   The producer warp issues the first `ring` stages of the block's items
//   of ALL products at kernel entry and exits: the weights do not depend on
//   the activations, so phase n + 1's weights land while phase n computes
//   and while the grid waits. Where the ring holds every stage of the
//   block's items (up to 16 rows at qwen3guard-0.6b's width), all of them
//   are in flight from the first instruction. The consumer warps meet on a
//   named barrier of their own; block-wide barriers (the grid's) wait, once
//   the producer has exited, on the consumers alone. With more stages than
//   the ring holds it runs ahead: consumer thread 0 refills a stage as
//   soon as the block is done with it, across the grid waits too.
// - Products on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32,
//   the weights as operand A (16 output columns x 16 contraction rows),
//   the bf16 activations, held in shared memory, as operand B (8 rows a
//   fragment; 8 or 16 rows a row tile). A thread reads four bytes (four
//   columns) from each of the contraction rows 2t, 2t + 1, 2t + 8 and
//   2t + 9 of a 16-row step (with the swizzle, a warp's loads hit 32
//   distinct banks), transposes them with byte permutes and turns each
//   byte into bf16 exactly (|w| <= 127): 128 + its low 7 bits built as a
//   bf16's bits, 128 or 256 (its sign) subtracted. Warp w takes 32 columns
//   (w % 4) and half of each 64-row stage (w / 4); the halves are added in
//   a fixed order at the item's end.
// - Each activation is formed once a consumer, in bulk, into shared memory
//   before the item's first stage: the attention norm of x (QKV), bf16 of
//   the attention output (wo), the FFN norm of x1 (gate/up), h as the
//   gate/up merge wrote it (down). A block that takes a QKV or gate/up item
//   reads its row tile's rows of x or x1 whole for their norms (x_rstd,
//   x1_rstd), summing the squares in a fixed order: a norm one float32
//   step off moves y a bf16 step at a few elements, and such a step moves
//   a dozen outputs past the card tests' tolerance.
// - Splits of the contraction write float32 partial tiles to the
//   workspace; the last to arrive (an acquire-release counter a tile, set
//   back to 0 by it) reads all of them, its loads in flight together with
//   those of the epilogue's operands, adds them in split order (runs repeat
//   bit for bit), scales, and writes what the next phase reads once per
//   element: x1 = x + sum * wo_s; h = bf16(silu(g) * u); the output with
//   its residual (the QKV merge is the megakernel's own). Those loads go
//   after the arrival: a release waits for the thread's earlier loads too.
// - The plan's numbers are copied to shared memory at entry: the item
//   arithmetic reads them there, not by dependent constant-bank loads of
//   the kernel parameters.
// - A grid-wide wait goes where every block needs every other's output:
//   wo -> the FFN norm, gate/up -> down (the megakernel adds attention ->
//   wo). Data written in the launch is read back with ld.global.cg.
// Counters live in the wrapper's per-(device, stream) workspace: zero when
// made, and every launch leaves them 0 (the block that reads a counter
// last resets it).

#pragma once

#include <string.h>

#include "hopper.cuh"
#include "int8_decode.cuh"

namespace {

using namespace i8d;

// The weight phases' geometry (mirrored by ops/weight_phases.py).
constexpr int kCols = 128;             // a box's columns (128 bytes)
constexpr int kRows = 64;              // a box's contraction rows: a stage
constexpr int kStage = kCols * kRows;  // 8 KB
constexpr int kKCap = 1024;            // contraction rows of an item, at most
constexpr int kActRow = kKCap + 8;     // bf16 a row of the activations
constexpr int kTW = 2 * kCols + 4;     // floats a row of the tile buffer
constexpr int kMaxRing = 32;           // ring stages, at most
constexpr int kBlock = kThreads + 32;  // 8 consumer warps, 1 producer warp
constexpr int kConsBar = 1;            // the consumers' named barrier
constexpr int kInitBar = 2;            // the ring is initialised: everyone
constexpr int kSmemLimit = 232448;     // a block's shared memory (sm_90)
constexpr int kStaticSlack = 1024;     // static shared memory, at most

enum { kQkv = 0, kWo = 1, kGu = 2, kDn = 3 };

// Dynamic shared memory beside the ring: slack to align the ring to 1024
// bytes (the swizzle's period), the activations [MT][kActRow] bf16 and the
// tile buffer [MT][kTW] float32 (the megakernel's attention scratch shares
// these two).
__host__ __device__ constexpr int fixed_smem(int mt) {
  return 1024 + mt * kActRow * 2 + mt * kTW * 4;
}
__host__ __device__ constexpr int layer_smem(int mt, int ring) {
  return fixed_smem(mt) + ring * kStage;
}
__host__ __device__ constexpr int max_ring(int mt) {
  return (kSmemLimit - kStaticSlack - fixed_smem(mt)) / kStage < kMaxRing
             ? (kSmemLimit - kStaticSlack - fixed_smem(mt)) / kStage
             : kMaxRing;
}

// Row tile of S rows: 8 or 16 (8 rows a fragment; more rows take more row
// tiles: a 32-row tile's accumulators spilled under 168 registers a
// thread).
__host__ __device__ constexpr int frags_of(int s) { return s <= 8 ? 1 : 2; }

// One weight product of the list.
struct Product {
  int ctiles;   // column tiles (gate/up: pairs of a gate and an up tile)
  int nb;       // boxes a stage: 1, or 2 for gate/up
  int ks;       // splits of the contraction
  int steps;    // stages of the contraction (K / 64)
  int n;        // output columns (gate/up: F)
  int box_off;  // column of box 1 past box 0 (gate/up: F)
  int items;    // row tiles x ctiles x ks (0: not in this kernel's list)
  int base;     // its first item in the list
};

// What the weight phases read and write.
struct alignas(64) WeightArgs {
  CUtensorMap maps[4];  // wqkv, wo, gate/up, down; boxes of 64 x 128
  Product prod[4];
  const __nv_bfloat16* x;        // [S, D] residual in
  const float* anorm;            // [D] attention norm (QKV's input)
  const float* wo_in;            // [S, A] wo's input, float32, or null
  const __nv_bfloat16* wo_in16;  // [S, A] wo's input, bf16, or null
  const float* wo_s;             // [D]
  const float* fnw;              // [D] FFN norm
  const float* gu_s;             // [2F], gate columns first
  const float* dn_s;             // [D]
  float* part;                   // the split partial tiles
  __nv_bfloat16* h;              // [S, F]
  float* x1;                     // [S, D] residual after wo
  __nv_bfloat16* out;            // [S, D]
  int* tile_count;  // [the most tiles of a product] arrivals, left 0
  int s, d, a, f;
  float eps;
  int mtiles, ring, total;  // row tiles, ring stages, items in the list
};

// Item g of the list (prod: the block's shared copy of the plan, read
// without the kernel parameters' dependent constant loads).
struct Item {
  int prod, mt, ct, ki, s0, s1;  // stages [s0, s1) of the contraction
};

__device__ __forceinline__ Item item_at(const Product* prod, int g) {
  int pr = 0;
  while (pr < 3 && g >= prod[pr + 1].base) ++pr;
  const Product& q = prod[pr];
  const int i = g - q.base;
  Item t;
  t.prod = pr;
  t.ki = i % q.ks;
  const int tile = i / q.ks;
  t.ct = tile % q.ctiles;
  t.mt = tile / q.ctiles;
  t.s0 = t.ki * q.steps / q.ks;
  t.s1 = (t.ki + 1) * q.steps / q.ks;
  return t;
}

// This block's first item of product pr.
__device__ __forceinline__ int first_item(const Product& q) {
  const int g = static_cast<int>(gridDim.x);
  return q.base + ((static_cast<int>(blockIdx.x) - q.base) % g + g) % g;
}

// Thread 0's walk over the block's stages, in the order the block uses
// them: items b, b + grid, ...; each item's stages; each stage's boxes.
struct Walk {
  int g, s, b, issued;
  Item t;
  const Product* prod;
  __device__ void start(const WeightArgs& p, const Product* plan) {
    prod = plan;
    g = blockIdx.x;
    s = b = issued = 0;
    if (g < p.total) {
      t = item_at(prod, g);
      s = t.s0;
    }
  }
  __device__ bool more(const WeightArgs& p) const { return g < p.total; }
  // The next stage into its slot (load false: only step past it).
  __device__ void issue(const WeightArgs& p, unsigned char* ring,
                        uint64_t* full, bool load = true) {
    const Product& q = prod[t.prod];
    const int slot = issued % p.ring;
    if (load) {
      hopper::mbar_arrive_expect_tx(&full[slot], kStage);
      hopper::tma_load_2d(ring + slot * kStage, &p.maps[t.prod], &full[slot],
                          t.ct * kCols + b * q.box_off, s * kRows);
    }
    ++issued;
    if (++b < q.nb) return;
    b = 0;
    if (++s < t.s1) return;
    g += gridDim.x;
    if (g < p.total) {
      t = item_at(prod, g);
      s = t.s0;
    }
  }
};

__device__ __forceinline__ int ld_acquire(const int* c) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(c) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* c, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n"
               :: "l"(c), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* c, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(c), "r"(v) : "memory");
  return old;
}

// The consumer warps' barrier (the producer warp takes no part).
__device__ __forceinline__ void csync() {
  hopper::named_bar_sync(kConsBar, kThreads);
}

// Rows r0..r3 of four adjacent columns (one word a row) -> one word a
// column, its rows low byte first.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* col) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
}

// Four int8 values (lowest byte first) as two bf16 pairs, exactly: lo =
// (b0, b1), hi = (b2, b3), the lower value in the lower half. A lane 0x43mm
// (mm the byte's low 7 bits) is 128 + mm; less 128 (the byte's sign bit
// clear) or 256 (set), 0x4300 or 0x4380, it is the byte's value (|w| <=
// 128, so both bf16 values and the difference are exact).
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t m = w & 0x7F7F7F7Fu, sgn = w & 0x80808080u;
  const uint32_t vlo = __byte_perm(m, 0x43434343u, 0x5140);
  const uint32_t vhi = __byte_perm(m, 0x43434343u, 0x7362);
  const uint32_t slo = __byte_perm(sgn, 0x43434343u, 0x5140);
  const uint32_t shi = __byte_perm(sgn, 0x43434343u, 0x7362);
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(vlo), "r"(slo));
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(vhi), "r"(shi));
}

// d += A[16, 16] B[16, 8], bf16 x bf16 -> f32 (mma.sync m16n8k16; lane l,
// g = l / 4, t = l % 4: a[0] = A[g][2t, 2t + 1], a[1] = A[g + 8][2t, ..],
// a[2] = A[g][2t + 8, ..], a[3] = A[g + 8][2t + 8, ..]; b0 = B[2t, 2t +
// 1][g], b1 = B[2t + 8, 2t + 9][g]; d = D[g][2t, 2t + 1], D[g + 8][2t,
// 2t + 1]).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x = a, the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The producer warp's part of a block (warp kWarps): the plan into shared
// memory, the ring's barriers, then the block's first `ring` stages of
// every product in flight (the memory system takes them as fast as it
// streams: microseconds of issue, off the consumers' path). The warp then
// exits, so that the block-wide barriers wait on the consumers only.
__device__ __forceinline__ void produce(const WeightArgs& p, Product* plan,
                                        unsigned char* ring, uint64_t* full) {
  static_assert(sizeof(Product) * 4 == 32 * sizeof(int), "a lane an int");
  const int lane = threadIdx.x & 31;
  reinterpret_cast<int*>(plan)[lane] =
      reinterpret_cast<const int*>(p.prod)[lane];
  __syncwarp();
  if (lane == 0) {
    for (int i = 0; i < p.ring; ++i) hopper::mbar_init(&full[i], 1);
    hopper::fence_barrier_init();
    for (int i = 0; i < 4; ++i)
      if (p.prod[i].items > 0) hopper::prefetch_tensor_map(&p.maps[i]);
  }
  __syncwarp();
  hopper::named_bar_arrive(kInitBar, kBlock);
  if (lane == 0) {
    Walk w;
    w.start(p, plan);
    for (int i = 0; i < p.ring && w.more(p); ++i) w.issue(p, ring, full);
  }
}

// A consumer's start: waits until the ring and plan are set; → whether the
// block has more stages than the ring holds (then consumer thread 0's
// `walk` stands past the first `ring` stages, to refill the ring).
__device__ __forceinline__ bool consume_start(const WeightArgs& p,
                                              const Product* plan,
                                              Walk& walk) {
  hopper::named_bar_sync(kInitBar, kBlock);  // the ring and plan are set
  int uses = 0;  // the block's stages, to know whether the ring refills
  for (int g = blockIdx.x; g < p.total; g += gridDim.x) {
    const Item t = item_at(plan, g);
    uses += (t.s1 - t.s0) * plan[t.prod].nb;
  }
  if (threadIdx.x == 0 && uses > p.ring) {
    walk.start(p, plan);
    for (int i = 0; i < p.ring && walk.more(p); ++i)
      walk.issue(p, nullptr, nullptr, false);
  }
  return uses > p.ring;
}

// The block's shared state and its thread roles, as the phases use them.
template <int F>
struct Block {
  static constexpr int MT = 8 * F;
  // epilogue elements a thread loads ahead: all of them at 8 rows; one at
  // 16 rows, whose accumulators leave no registers for more
  static constexpr int kAhead = F == 1 ? MT / 2 : 1;
  const WeightArgs& p;
  const Product* plan;  // the block's shared copy
  unsigned char* ring;
  __nv_bfloat16* act;  // [MT][kActRow]
  float* tb;           // [MT][kTW]
  uint64_t* full;
  float* rstd;   // [MT]
  int* flag;
  Walk& walk;    // thread 0's
  int use;       // stages used so far (the same in every thread)
  bool refill;   // the block has more stages than the ring holds
  int tid, lane, warp;

  // The item's products, partial over its stages, into tb [MT][nb * 128]
  // (before the scale). The activations must be in act.
  template <int NB>
  __device__ __forceinline__ void mma_item(const Item& t) {
    const int kh = warp >> 2, cq = warp & 3;
    const int g8 = lane >> 2, t4 = lane & 3;
    // the swizzled offsets of rows 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-row
    // step at this thread's four columns 32 cq + 4 g8 (the 128-byte swizzle
    // moves 16-byte chunk c of row r to c ^ (r % 8))
    const int chunk = 2 * cq + (g8 >> 2);
    int off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * t4 + (i & 1) + 8 * (i >> 1);
      off[i] = r * kCols + ((chunk ^ (r & 7)) << 4) + 4 * (g8 & 3);
    }
    float acc[NB][F][2][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[b][f][h][e] = 0.f;

    for (int s = t.s0; s < t.s1; ++s) {
      const int kact = (s - t.s0) * kRows;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int u = use + b;
        const int slot = u % p.ring;
        hopper::mbar_wait(&full[slot], static_cast<uint32_t>(u / p.ring) & 1u);
        const unsigned char* st = ring + slot * kStage;
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // this warp's two 16-row steps
          const int kb = 32 * kh + 16 * j;
          uint32_t w[4], col[4], lo[4], hi[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint32_t*>(st + kb * kCols + off[i]);
          transpose4(w, col);
#pragma unroll
          for (int c = 0; c < 4; ++c) i8x4_bf16(col[c], lo[c], hi[c]);
          // A tile h: its rows g8, g8 + 8 are columns 4 g8 + 2h, + 1
          const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
          const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const __nv_bfloat16* ar =
                act + (8 * f + g8) * kActRow + kact + kb + 2 * t4;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ar);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ar + 8);
            mma_bf16(acc[b][f][0], a0, b0, b1);
            mma_bf16(acc[b][f][1], a1, b0, b1);
          }
        }
      }
      use += NB;
      if (refill) {  // the stages just used are free: refill them
        csync();
        if (tid == 0)
          for (int b = 0; b < NB && walk.more(p); ++b)
            walk.issue(p, ring, full);
      }
    }

    // the two halves of the contraction meet in tb, in a fixed order: this
    // thread's sums are rows 8f + 2 t4 + e, columns 32 cq + 4 g8 .. + 3
    csync();  // tb is free
    if (kh == 1) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float4*>(
                tb + (8 * f + 2 * t4 + e) * kTW + b * kCols + 32 * cq +
                4 * g8) = make_float4(acc[b][f][0][e], acc[b][f][0][2 + e],
                                      acc[b][f][1][e], acc[b][f][1][2 + e]);
    }
    csync();
    if (kh == 0) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int f = 0; f < F; ++f)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float4* dst = reinterpret_cast<float4*>(
                tb + (8 * f + 2 * t4 + e) * kTW + b * kCols + 32 * cq +
                4 * g8);
            const float4 o = *dst;
            *dst = make_float4(acc[b][f][0][e] + o.x, acc[b][f][0][2 + e] + o.y,
                               acc[b][f][1][e] + o.z,
                               acc[b][f][1][2 + e] + o.w);
          }
    }
    csync();
  }

  // The item's sums are in tb. With splits, this split's partial tile goes
  // to the workspace and the block counts its arrival: → whether it is
  // the tile's last (then gather() adds the splits and the block runs the
  // epilogue). One split: true.
  __device__ __forceinline__ bool arrive(const Product& q, const Item& t) {
    if (q.ks == 1) return true;
    const int w = q.nb * kCols;      // floats a partial row
    const int tile = t.mt * q.ctiles + t.ct;
    float* part = p.part + static_cast<int64_t>(tile) * q.ks * MT * w;
    for (int i = tid; i < MT * w / 4; i += kThreads) {
      const int r = i / (w / 4), c = 4 * (i % (w / 4));
      *reinterpret_cast<float4*>(part + (t.ki * MT + r) * w + c) =
          *reinterpret_cast<const float4*>(tb + r * kTW + c);
    }
    csync();
    if (tid == 0) *flag = atom_add_acq_rel(p.tile_count + tile, 1) == q.ks - 1;
    csync();
    return *flag != 0;
  }

  // The last split reads all of them (a thread's loads in flight
  // together) and adds them in split order into tb.
  __device__ __forceinline__ void gather(const Product& q, const Item& t) {
    if (q.ks == 1) return;
    const int w = q.nb * kCols;
    const int tile = t.mt * q.ctiles + t.ct;
    const float* part = p.part + static_cast<int64_t>(tile) * q.ks * MT * w;
#pragma unroll 1
    for (int i = tid; i < MT * w / 4; i += kThreads) {
      const int r = i / (w / 4), c = 4 * (i % (w / 4));
      const float* src = part + r * w + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = 0; j0 < q.ks; j0 += 8) {
        float4 x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          x[u] = j0 + u < q.ks
                     ? __ldcg(reinterpret_cast<const float4*>(
                           src + static_cast<int64_t>(j0 + u) * MT * w))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (j0 + u < q.ks) {
            v.x += x[u].x;
            v.y += x[u].y;
            v.z += x[u].z;
            v.w += x[u].w;
          }
        }
      }
      *reinterpret_cast<float4*>(tb + r * kTW + c) = v;
    }
    if (tid == 0) p.tile_count[tile] = 0;  // every split has counted
    csync();
  }

  // rstd[r] = 1 / sqrt(mean(x^2) + eps) of row m0 + r of x (0 past S), one
  // warp a row (each lane's elements lane, lane + 32, ... fused into its
  // sum in turn, then the lanes' butterfly); a lane's loads (32 at D 1024)
  // are in flight together.
  __device__ __forceinline__ void x_rstd(int m0) {
    for (int r = warp; r < MT; r += kWarps) {
      const int si = m0 + r;
      float ss = 0.f;
      if (si < p.s) {
        const __nv_bfloat16* row = p.x + static_cast<int64_t>(si) * p.d;
        for (int i0 = lane; i0 < p.d; i0 += 32 * 32) {
          float v[32];
#pragma unroll
          for (int u = 0; u < 32; ++u)
            v[u] = i0 + 32 * u < p.d ? to_f(row[i0 + 32 * u]) : 0.f;
#pragma unroll
          for (int u = 0; u < 32; ++u)
            if (i0 + 32 * u < p.d) ss += v[u] * v[u];
        }
      }
      ss = warp_sum(ss);
      if (lane == 0)
        rstd[r] = si < p.s ? rsqrtf(ss / static_cast<float>(p.d) + p.eps)
                           : 0.f;
    }
  }

  // The FFN norm's rstd of the row tile's rows (thread t's elements t,
  // t + 256, ... fused into its sum in turn, each warp's butterfly, the
  // warps' sums added in order), 8 rows at a time with all of a thread's
  // loads in flight. red holds 8 x kWarps floats.
  __device__ __forceinline__ void x1_rstd(int m0, float* red) {
    for (int r0 = 0; r0 < MT; r0 += 8) {
      float ss[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ss[i] = 0.f;
      for (int n0 = tid; n0 < p.d; n0 += 4 * kThreads) {
        float v[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int si = m0 + r0 + i, n = n0 + j * kThreads;
            v[i][j] = si < p.s && n < p.d
                          ? __ldcg(p.x1 + static_cast<int64_t>(si) * p.d + n)
                          : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j * kThreads < p.d) ss[i] += v[i][j] * v[i][j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = warp_sum(ss[i]);
        if (lane == 0) red[i * kWarps + warp] = w;
      }
      csync();
      if (tid < 8) {
        const int si = m0 + r0 + tid;
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += red[tid * kWarps + w];
        rstd[r0 + tid] =
            si < p.s ? rsqrtf(total / static_cast<float>(p.d) + p.eps) : 0.f;
      }
      csync();
    }
  }

  // Eight input values of a product (and the norm's weights) at chunk c of
  // the item's [MT rows, len columns from k0] activations.
  struct Chunk {
    float v[8], w[8];
  };

  __device__ __forceinline__ void load_chunk(int prod, int m0, int k0,
                                             int chunks, int c,
                                             Chunk& ch) const {
    const int r = c / chunks, k = k0 + 8 * (c % chunks), si = m0 + r;
#pragma unroll
    for (int i = 0; i < 8; ++i) ch.v[i] = ch.w[i] = 0.f;
    if (c >= MT * chunks || si >= p.s) return;
    const float* src = nullptr;
    if (prod == kQkv) {  // x and the attention norm's weights
      unpack8(*reinterpret_cast<const uint4*>(
                  p.x + static_cast<int64_t>(si) * p.d + k), ch.v);
#pragma unroll
      for (int i = 0; i < 8; ++i) ch.w[i] = p.anorm[k + i];
    } else if (prod == kWo) {  // the attention output
      if (p.wo_in16 != nullptr)
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    p.wo_in16 + static_cast<int64_t>(si) * p.a + k)), ch.v);
      else
        src = p.wo_in + static_cast<int64_t>(si) * p.a + k;
    } else if (prod == kGu) {  // x1 and the FFN norm's weights
      src = p.x1 + static_cast<int64_t>(si) * p.d + k;
#pragma unroll
      for (int i = 0; i < 8; ++i) ch.w[i] = p.fnw[k + i];
    } else {  // h, bf16 as the gate/up merge wrote it
      unpack8(__ldcg(reinterpret_cast<const uint4*>(
                  p.h + static_cast<int64_t>(si) * p.f + k)), ch.v);
    }
    if (src != nullptr) {
      const float4 lo = __ldcg(reinterpret_cast<const float4*>(src));
      const float4 hi = __ldcg(reinterpret_cast<const float4*>(src + 4));
      ch.v[0] = lo.x; ch.v[1] = lo.y; ch.v[2] = lo.z; ch.v[3] = lo.w;
      ch.v[4] = hi.x; ch.v[5] = hi.y; ch.v[6] = hi.z; ch.v[7] = hi.w;
    }
  }

  // act[r][0, len) = bf16 of the product's input at row m0 + r, columns
  // [k0, k0 + len) (rows past S: zeros), a chunk of 8 a thread at a time;
  // with `ahead`, `first` is this thread's first chunk, loaded ahead.
  __device__ __forceinline__ void form(int prod, int m0, int k0, int len,
                                       const Chunk& first, bool ahead) {
    const int chunks = len / 8;
#pragma unroll 2
    for (int c = tid; c < MT * chunks; c += kThreads) {
      Chunk ch;
      if (c == tid && ahead)
        ch = first;
      else
        load_chunk(prod, m0, k0, chunks, c, ch);
      const int r = c / chunks, k = 8 * (c % chunks);
      if (prod == kQkv || prod == kGu) {  // the norms: (v * rstd) * w
#pragma unroll
        for (int i = 0; i < 8; ++i) ch.v[i] = ch.v[i] * rstd[r] * ch.w[i];
      }
      *reinterpret_cast<uint4*>(act + r * kActRow + k) = pack8(ch.v);
    }
  }

  // The merge's epilogue over this thread's elements of the tile (kAhead
  // of them loaded ahead, in flight with the splits' loads): operands(k,
  // ea, eb) loads element k's two operands, put(r, c, si, col, ea, eb)
  // writes it from tb.
  template <class Ops, class Put>
  __device__ __forceinline__ void epilogue(const Product& q, const Item& t,
                                           const Ops& operands,
                                           const Put& put) {
    float ea[kAhead], eb[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) operands(k, ea[k], eb[k]);
    gather(q, t);
#pragma unroll
    for (int k = 0; k < MT / 2; ++k) {
      float a, b;
      if (k < kAhead) {
        a = ea[k];
        b = eb[k];
      } else {
        operands(k, a, b);
      }
      const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
      put(r, c, t.mt * MT + r, t.ct * kCols + c, a, b);
    }
  }

  // wo; each tile's merge: x1 = x + (attn @ wo) * wo_s
  __device__ __forceinline__ void wo_phase() {
    const Product& q = plan[kWo];
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      csync();
      form(kWo, t.mt * MT, t.s0 * kRows, (t.s1 - t.s0) * kRows, Chunk{},
           false);
      csync();
      mma_item<1>(t);
      if (!arrive(q, t)) continue;
      // this thread's elements of the tile: their operands (x and wo_s)
      epilogue(
          q, t,
          [&](int k, float& ea, float& eb) {
            const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
            const int si = t.mt * MT + r, col = t.ct * kCols + c;
            const bool in = si < p.s && col < p.d;
            ea = in ? to_f(p.x[static_cast<int64_t>(si) * p.d + col]) : 0.f;
            eb = in ? p.wo_s[col] : 0.f;
          },
          [&](int r, int c, int si, int col, float a, float b) {
            if (si < p.s && col < p.d)
              p.x1[static_cast<int64_t>(si) * p.d + col] =
                  a + tb[r * kTW + c] * b;
          });
    }
  }

  // gate/up; each pair's merge: h = bf16(silu(g) * u)
  __device__ __forceinline__ void gu_phase() {
    const Product& q = plan[kGu];
    int have_mt = -1;
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      const int len = (t.s1 - t.s0) * kRows;
      // 8-row tiles: the first chunk in flight across the norm (16 rows
      // have no registers for it)
      Chunk first;
      if constexpr (F == 1)
        load_chunk(kGu, t.mt * MT, t.s0 * kRows, len / 8, tid, first);
      csync();  // act and rstd are free
      if (t.mt != have_mt) {
        x1_rstd(t.mt * MT, tb);
        have_mt = t.mt;
      }
      form(kGu, t.mt * MT, t.s0 * kRows, len, first, F == 1);
      csync();
      mma_item<2>(t);
      if (!arrive(q, t)) continue;
      // this thread's elements of the tile: their operands (the gate's and
      // up's scales)
      epilogue(
          q, t,
          [&](int k, float& ea, float& eb) {
            const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
            const int si = t.mt * MT + r, col = t.ct * kCols + c;
            const bool in = si < p.s && col < p.f;
            ea = in ? p.gu_s[col] : 0.f;
            eb = in ? p.gu_s[p.f + col] : 0.f;
          },
          [&](int r, int c, int si, int col, float a, float b) {
            if (si >= p.s || col >= p.f) return;
            const float gv = tb[r * kTW + c] * a;
            const float uv = tb[r * kTW + kCols + c] * b;
            p.h[static_cast<int64_t>(si) * p.f + col] =
                __float2bfloat16(gv * (1.f / (1.f + expf(-gv))) * uv);
          });
    }
  }

  // down; each tile's merge: out = x1 + (h @ down) * down_s
  __device__ __forceinline__ void dn_phase() {
    const Product& q = plan[kDn];
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      csync();
      form(kDn, t.mt * MT, t.s0 * kRows, (t.s1 - t.s0) * kRows, Chunk{},
           false);
      csync();
      mma_item<1>(t);
      if (!arrive(q, t)) continue;
      // this thread's elements of the tile: their operands (x1 and down_s)
      epilogue(
          q, t,
          [&](int k, float& ea, float& eb) {
            const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
            const int si = t.mt * MT + r, col = t.ct * kCols + c;
            const bool in = si < p.s && col < p.d;
            ea = in ? __ldcg(p.x1 + static_cast<int64_t>(si) * p.d + col)
                    : 0.f;
            eb = in ? p.dn_s[col] : 0.f;
          },
          [&](int r, int c, int si, int col, float a, float b) {
            if (si < p.s && col < p.d)
              p.out[static_cast<int64_t>(si) * p.d + col] =
                  __float2bfloat16(a + tb[r * kTW + c] * b);
          });
    }
  }
};

// Blocks of kBlock threads of a cooperative launch of kern with `smem`
// bytes of dynamic shared memory: all that fit on the card at once (the
// attribute set to `smem`). Negative: a CUDA error code.
template <class K>
int resident_blocks(K kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kBlock, smem)) != cudaSuccess)
    return -static_cast<int>(err);
  return per_sm * sms;
}

// The tensor map of a weight w [k, n] int8 (n a multiple of 16, 16-byte
// aligned): boxes of 64 rows x 128 columns, 128-byte swizzle, into the
// sizeof(CUtensorMap) = 128 bytes at `map`. Returns the CUDA error code.
inline int encode_weight(const void* w, int k, int n, void* map) {
  if (map == nullptr || k < kRows || n < 16 || n % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mp;
  const int err = hopper_host::encode_2d(
      &mp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, static_cast<uint64_t>(n),
      static_cast<uint64_t>(k), kCols, kRows, 128);
  if (err == 0) memcpy(map, &mp, sizeof(CUtensorMap));
  return err;
}

// The list of p's four products from spec[i] = {output columns, boxes a
// stage, splits, contraction rows, box 1's offset} (columns 0: the product
// is not in the list), the maps (4 x 128 bytes, a null product's unread),
// the row tiles of S rows and the ring; → the most tiles of a product (its
// arrival counters), or -1 if a split is out of range.
inline int set_products(WeightArgs& p, const int (&spec)[4][5],
                        const void* maps, int ring) {
  memcpy(p.maps, maps, sizeof(p.maps));
  const int mt = 8 * frags_of(p.s);
  p.mtiles = (p.s + mt - 1) / mt;
  int base = 0, most_tiles = 0;
  for (int i = 0; i < 4; ++i) {
    Product& q = p.prod[i];
    q.n = spec[i][0];
    q.nb = spec[i][1];
    q.ks = spec[i][2];
    q.steps = spec[i][3] / kRows;
    q.box_off = spec[i][4];
    q.ctiles = (q.n + kCols - 1) / kCols;
    if (q.ks < 1 || q.ks > q.steps ||
        (q.steps + q.ks - 1) / q.ks > kKCap / kRows)
      return -1;
    q.items = p.mtiles * q.ctiles * q.ks;
    q.base = base;
    base += q.items;
    most_tiles = p.mtiles * q.ctiles > most_tiles ? p.mtiles * q.ctiles
                                                  : most_tiles;
  }
  p.ring = ring;
  p.total = base;
  return most_tiles;
}

}  // namespace
