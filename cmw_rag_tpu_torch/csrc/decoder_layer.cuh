// The decoder-layer decode megakernel's device code, shared by
// csrc/decoder_layer.cu (bf16 KV pages) and csrc/decoder_layer_kv8.cu (int8
// KV pages): each source instantiates the kernel for its pool type only, so
// the two compile in parallel. The build hashes this header, hopper.cuh and
// int8_decode.cuh with each (ops/cuda_build.py).
//
// One int8-weight decoder layer, for one new token per slot, in ONE launch
// (Hopper, sm_90a). Function, per slot s: y = bf16(x * rsqrt(mean(x^2) +
// eps) * attn_norm); qkv = (y @ wqkv) * wqkv_s in float32; per head, t *
// rsqrt(mean(t^2) + eps) * {q,k}_norm, then rotate-half RoPE n * c2 +
// roll(n, Dh / 2) * s2 (c2, s2 from make_rope_maps), q kept in float32, k
// and v written as bf16 into row off[s] of page page_idx[s] of this layer's
// pools (IN PLACE: the TPU kernel aliases them); attention over positions <
// lens[s], slot-major over the partitioned pool (slot_cap > 0: cap pages
// from slot_base + s * slot_maxp) or paged over tables [S, maxp]; then
// x1 = x + (bf16(attention) @ wo) * wo_s, y2 = bf16(x1 * rsqrt(mean(x1^2)
// + eps) * ffn_norm), h = bf16(silu(g) * u) with [g | u] = (y2 @ w_gateup)
// * gateup_s, out = bf16(x1 + (h @ w_down) * down_s).
//
// What bounds it: bytes. The layer's int8 weights are 15.7 MB at
// qwen3guard-0.6b's width (4.7 us at 3.35 TB/s), each used S times; the
// attention reads K and V of the real positions once. At decode's few rows
// the time goes to latency: the weights' first bytes, and the round trips
// of the phases that depend on each other.
//
// Design: ONE persistent cooperative launch, one block a SM of eight
// consumer warps and a producer warp (the grid is the host plan's, at most
// the co-resident blocks). Nine warps leave a thread 168 registers (three
// warps share a quarter of the register file); the kernel is written to
// need no more (no spills: scripts/kernel_resources.py).
// - The weight products (QKV, wo, gate/up, down) are one list of work
//   items, (row tile, column tile, split of the contraction) of each
//   product in phase order; block b takes items b, b + grid, ... (the host
//   plan, ops/decoder_layer.py layer_plan, picks the splits). A gate/up
//   item takes the gate tile and the up tile of the same columns, so that
//   its merge can form h.
// - Weights arrive by TMA (a 2-D map a weight, boxes of 64 rows x 128
//   columns, 128-byte swizzle; the host encodes each map once and caches
//   it) into a ring of 8 KB stages on mbarriers. The block issues the first
//   `ring` stages of the block's items of ALL four products at kernel
//   entry: the weights do not depend on the activations, so phase n + 1's
//   weights land while phase n computes and while the grid waits. At up to
//   16 rows the plan sizes the ring to hold every stage of the block's
//   items (about 17 stages, 136 KB, at qwen3guard-0.6b's width): all of
//   them are in flight from the first instruction. A producer warp issues
//   them and exits: the issue lasts as long as the memory system takes to
//   accept a block's share of the weights (microseconds, all blocks
//   streaming at once), which a consumer warp issuing them spent off its
//   own work, and the phases' waits for each other with it. The consumer
//   warps meet on a named barrier of their own; attend_split and the grid
//   barrier meet on the block-wide one, which, once the producer has
//   exited, waits on the consumers alone. With more rows the ring runs
//   ahead: consumer thread 0 refills a stage as soon as the block is done
//   with it, so the next stages (across the grid barriers too) stay in
//   flight.
// - Products on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32,
//   the weights as operand A (16 output columns x 16 contraction rows),
//   the bf16 activations, held in shared memory, as operand B (8 rows a
//   fragment; 8 or 16 rows a row tile). A thread reads four bytes
//   (four columns) from each of the contraction rows 2t, 2t + 1, 2t + 8 and
//   2t + 9 of a 16-row step (with the swizzle, a warp's loads hit 32
//   distinct banks), transposes them with byte permutes and turns each
//   byte into bf16 exactly (|w| <= 127): 128 + its low 7 bits built as a
//   bf16's bits, 128 or 256 (its sign) subtracted. Warp w takes 32 columns
//   (w % 4) and half of each 64-row stage (w / 4); the halves are added in
//   a fixed order at the item's end.
// - Each activation is formed once a consumer, in bulk, into shared memory
//   before the item's first stage: the attention norm of x, bf16 of the
//   attention output, the FFN norm of x1, h as the gate/up merge wrote it.
//   A block that takes a QKV or gate/up item reads its row tile's rows of
//   x or x1 whole for their norms, summing the squares in the previous
//   kernel's order (row_rstd's, block_sum's): a norm one float32 step off
//   the twin's moves y or y2 a bf16 step at a few elements, and such a step
//   in y moves the layer's output past its tolerance at a dozen elements
//   (the twin's own output, stepped so, does the same).
// - Splits of the contraction write float32 partial tiles to the
//   workspace; the last to arrive (an acquire-release counter a tile, set
//   back to 0 by it) reads all of them, its loads in flight together with
//   those of the epilogue's operands (scales, RoPE maps, the residual),
//   adds them in split order (runs repeat bit for bit), scales, and writes
//   what the next phase reads once per element: q after its head norm and
//   RoPE (float32) and the K/V rows (phase 2 of the TPU kernel, folded
//   in); x1; h = bf16(silu(g) * u); the output with its residual. (Those
//   loads go after the arrival: a release waits for the thread's earlier
//   loads too.)
// - The plan's numbers are copied to shared memory at entry: the item
//   arithmetic reads them there, not by dependent constant-bank loads of
//   the kernel parameters.
// - Three grid-wide waits a layer, where every block needs every other's
//   output: attention -> wo, wo -> the FFN norm, gate/up -> down. The QKV
//   merges release a counter a (row tile, KV head group); an attention item
//   of (slot, KV head, split) waits (acquire) until all of its group's
//   rep + 2 heads are merged. Every block is resident, so the waits end.
// - Attention is attend_split() of csrc/int8_decode.cuh as before, one
//   (slot, KV head, split) item at a time; the last split of a (slot, KV
//   head) to finish merges the others' partials (attn_part) in split order
//   and sets its counter (attn_count) back to 0. Only the live items (those
//   under the slot's length) are handed out, numbered densely, so that an
//   item past a length takes no block's turn: with one block a SM, fewer
//   rounds of items.
// Counters live in the wrapper's per-(device, stream) workspace: zero when
// made, and every launch leaves them 0 (the block that reads a counter last
// resets it; the head-group counters are reset after the first grid-wide
// wait). Data written in the launch is read back with ld.global.cg. The
// caller guarantees that active slots write distinct rows; idle slots
// write row 0 of the null page, whose output nobody samples. A launch whose
// grid cannot be co-resident fails, and the failure is returned.
//
// The ablation "noattn" (the TPU kernels' ablate argument, diagnosis only:
// wrong outputs on purpose) skips attention; wo reads q as its input.

#pragma once

#include <string.h>

#include "hopper.cuh"
#include "int8_decode.cuh"

namespace {

using namespace i8d;

constexpr float kKvHeadroom = 1.25f / 127.0f;  // KV_HEADROOM / 127

// The weight phases' geometry (mirrored by ops/decoder_layer.py).
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
// tile buffer [MT][kTW] float32 (attend_split's scratch shares these two).
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
static_assert(attend_smem(128) <= 8 * kActRow * 2 + 8 * kTW * 4,
              "attention's scratch fits the activations and tile buffer");

// One weight product of the layer's list.
struct Product {
  int ctiles;   // column tiles (gate/up: pairs of a gate and an up tile)
  int nb;       // boxes a stage: 1, or 2 for gate/up
  int ks;       // splits of the contraction
  int steps;    // stages of the contraction (K / 64)
  int n;        // output columns (gate/up: F)
  int box_off;  // column of box 1 past box 0 (gate/up: F)
  int items;    // row tiles x ctiles x ks
  int base;     // its first item in the layer's list
};

struct alignas(64) LayerArgs {
  CUtensorMap maps[4];  // wqkv, wo, gate/up, down; boxes of 64 x 128
  Product prod[4];
  const float* c2;  // [S, Dh] RoPE maps
  const float* s2;
  const float* anorm;  // [D]
  const float* wqkv_s;
  const float* qn;  // [Dh]
  const float* kn;
  const int* page_idx;  // [S]
  const int* off;
  void* k_pool;  // this layer: [P, page, Hkv, Dh], bf16 or int8
  void* v_pool;
  float* k_scale;  // this layer: [P, Hkv] (int8 pools) or null
  float* v_scale;
  const int* lens;    // [S], this step's token included
  const int* tables;  // [S, maxp] (paged route) or null
  int hq, hkv, page, maxp, slot_cap, slot_maxp, slot_base, noattn;
  int attn_split, n_split;  // positions a split; splits a (slot, KV head)
  float* attn_part;  // [S, Hkv, n_split, Hq / Hkv, Dh + 2] split partials
  int* attn_count;   // [S, Hkv] splits written, left 0
  float* qbuf;       // [S, Hq, Dh]
  float* aout;       // [S, Hq, Dh]
  int* tile_count;   // [the most tiles of a product] arrivals, left 0
  int* ready;        // [row tiles, Hkv] heads merged, reset after wait 1
  int mtiles, ring, total;  // row tiles, ring stages, items in the list
  // x, the scales and norms, S, D, A, F, eps; part_a: the partial tiles;
  // part_b: h [S, F] bf16; x1 [S, D]; out [S, D] (ybuf is not read)
  MlpArgs mlp;
};

// Item g of the layer's list (prod: the block's shared copy of the plan,
// read without the kernel parameters' dependent constant loads).
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
  __device__ void start(const LayerArgs& p, const Product* plan) {
    prod = plan;
    g = blockIdx.x;
    s = b = issued = 0;
    if (g < p.total) {
      t = item_at(prod, g);
      s = t.s0;
    }
  }
  __device__ bool more(const LayerArgs& p) const { return g < p.total; }
  // The next stage into its slot (load false: only step past it).
  __device__ void issue(const LayerArgs& p, unsigned char* ring,
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

// Spins (one thread) until *c reaches target; a wait that never ends traps
// instead of hanging the card.
__device__ void wait_count(const int* c, int target) {
  for (unsigned spins = 0; ld_acquire(c) < target; ++spins) {
    __nanosleep(64);
    if (spins == (1u << 26)) __trap();
  }
}

// Slots (of s) with more than j live splits of `split` positions, their
// lengths capped at cap (every lane of the warp gets it; each warp counts
// alike).
__device__ int slots_past(const int* lens, int s, int cap, int split, int j,
                          int lane) {
  int n = 0;
  for (int c = 0; c < s; c += 32) {
    const int si = c + lane;
    const bool live =
        si < s && live_splits(min(__ldg(lens + si), cap), split) > j;
    n += __popc(__ballot_sync(0xffffffffu, live));
  }
  return n;
}

// The k-th (from 0) of those slots, in slot order.
__device__ int nth_slot_past(const int* lens, int s, int cap, int split,
                             int j, int k, int lane) {
  for (int c = 0; c < s; c += 32) {
    const int si = c + lane;
    const bool live =
        si < s && live_splits(min(__ldg(lens + si), cap), split) > j;
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    const int n = __popc(mask);
    if (k < n) return c + __fns(mask, 0, k + 1);
    k -= n;
  }
  return s;  // not reached: k is under slots_past
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

// One K or V row of DH values, EL = DH / 32 a lane, into an int8 pool row
// `dst` against the page's scale `*scale` (set from the row when fresh):
// the rounding points of the TPU kernel (bf16 first, then the amax).
template <int EL>
__device__ __forceinline__ void store_row(const float* t, bool fresh,
                                          float* scale, int8_t* dst,
                                          int lane) {
  float r[EL], amax = 0.f;
#pragma unroll
  for (int e = 0; e < EL; ++e) {
    r[e] = bf16r(t[e]);
    amax = fmaxf(amax, fabsf(r[e]));
  }
  amax = warp_max(amax);
  const float sc = fresh ? fmaxf(amax, 1e-8f) * kKvHeadroom : __ldcg(scale);
  if (fresh && lane == 0) *scale = sc;
#pragma unroll
  for (int e = 0; e < EL; ++e)
    dst[e] = static_cast<int8_t>(
        __float2int_rn(fmaxf(fminf(rintf(r[e] / sc), 127.f), -127.f)));
}

__device__ __forceinline__ void store_row_bf16(const float* t, int el,
                                               __nv_bfloat16* dst) {
  for (int e = 0; e < el; ++e) dst[e] = __float2bfloat16(t[e]);
}

// The block's shared state and its thread roles, as the phases use them.
template <int F>
struct Block {
  static constexpr int MT = 8 * F;
  const LayerArgs& p;
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
    float* part = p.mlp.part_a + static_cast<int64_t>(tile) * q.ks * MT * w;
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
    const float* part =
        p.mlp.part_a + static_cast<int64_t>(tile) * q.ks * MT * w;
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
  // warp a row, in row_rstd's order (each lane's elements lane, lane + 32,
  // ... fused into its sum in turn, then the lanes' butterfly), so that y
  // rounds to bf16 where the previous kernel's did; a lane's loads (32 at
  // D 1024) are in flight together.
  __device__ __forceinline__ void x_rstd(int m0) {
    const MlpArgs& m = p.mlp;
    for (int r = warp; r < MT; r += kWarps) {
      const int si = m0 + r;
      float ss = 0.f;
      if (si < m.s) {
        const __nv_bfloat16* row = m.x + static_cast<int64_t>(si) * m.d;
        for (int i0 = lane; i0 < m.d; i0 += 32 * 32) {
          float v[32];
#pragma unroll
          for (int u = 0; u < 32; ++u)
            v[u] = i0 + 32 * u < m.d ? to_f(row[i0 + 32 * u]) : 0.f;
#pragma unroll
          for (int u = 0; u < 32; ++u)
            if (i0 + 32 * u < m.d) ss += v[u] * v[u];
        }
      }
      ss = warp_sum(ss);
      if (lane == 0)
        rstd[r] = si < m.s ? rsqrtf(ss / static_cast<float>(m.d) + m.eps)
                           : 0.f;
    }
  }

  // The FFN norm's rstd of the row tile's rows, in block_sum's order as the
  // previous kernel took it (thread t's elements t, t + 256, ... fused into
  // its sum in turn, each warp's butterfly, the warps' sums added in
  // order), 8 rows at a time with all of a thread's loads in flight. red
  // holds 8 x kWarps floats.
  __device__ __forceinline__ void x1_rstd(int m0, float* red) {
    const MlpArgs& m = p.mlp;
    for (int r0 = 0; r0 < MT; r0 += 8) {
      float ss[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ss[i] = 0.f;
      for (int n0 = tid; n0 < m.d; n0 += 4 * kThreads) {
        float v[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int si = m0 + r0 + i, n = n0 + j * kThreads;
            v[i][j] = si < m.s && n < m.d
                          ? __ldcg(m.x1 + static_cast<int64_t>(si) * m.d + n)
                          : 0.f;
          }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0 + j * kThreads < m.d) ss[i] += v[i][j] * v[i][j];
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
            si < m.s ? rsqrtf(total / static_cast<float>(m.d) + m.eps) : 0.f;
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
    const MlpArgs& m = p.mlp;
    const int r = c / chunks, k = k0 + 8 * (c % chunks), si = m0 + r;
#pragma unroll
    for (int i = 0; i < 8; ++i) ch.v[i] = ch.w[i] = 0.f;
    if (c >= MT * chunks || si >= m.s) return;
    const float* src = nullptr;
    if (prod == kQkv) {  // x and the attention norm's weights
      unpack8(*reinterpret_cast<const uint4*>(
                  m.x + static_cast<int64_t>(si) * m.d + k), ch.v);
#pragma unroll
      for (int i = 0; i < 8; ++i) ch.w[i] = p.anorm[k + i];
    } else if (prod == kWo) {  // the attention output (noattn: q)
      src = (p.noattn ? p.qbuf : p.aout) + static_cast<int64_t>(si) * m.a + k;
    } else if (prod == kGu) {  // x1 and the FFN norm's weights
      src = m.x1 + static_cast<int64_t>(si) * m.d + k;
#pragma unroll
      for (int i = 0; i < 8; ++i) ch.w[i] = m.fnw[k + i];
    } else {  // h, bf16 as the gate/up merge wrote it
      unpack8(__ldcg(reinterpret_cast<const uint4*>(
                  reinterpret_cast<const __nv_bfloat16*>(m.part_b) +
                  static_cast<int64_t>(si) * m.f + k)), ch.v);
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
};

template <int F, int DH, typename TP>
__global__ void __launch_bounds__(kBlock, 1)
decoder_layer_kernel(const __grid_constant__ LayerArgs p) {
  constexpr int MT = 8 * F;
  constexpr bool kInt8 = sizeof(TP) == 1;
  constexpr int EL = DH / 32;
  constexpr int kHeads = kCols / DH;  // heads a QKV column tile
  // epilogue elements a thread loads ahead: all of them at 8 rows; one at
  // 16 rows, whose accumulators leave no registers for more
  constexpr int kAhead = F == 1 ? MT / 2 : 1;
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
  TP* const k_pool = static_cast<TP*>(p.k_pool);
  TP* const v_pool = static_cast<TP*>(p.v_pool);
  cg::grid_group grid = cg::this_grid();
  const MlpArgs& m = p.mlp;
  const int s = m.s, d = m.d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = p.hq + 2 * p.hkv, rep = p.hq / p.hkv;

  // the producer warp: the ring, then the block's first `ring` stages of
  // every product in flight (the memory system takes them as fast as it
  // streams: microseconds of issue, off the consumers' path); then it
  // exits, so that the block-wide barriers of attend_split and of the grid
  // wait on the consumers only
  static_assert(sizeof(Product) * 4 == 32 * sizeof(int), "a lane an int");
  if (warp == kWarps) {
    reinterpret_cast<int*>(plan)[lane] =
        reinterpret_cast<const int*>(p.prod)[lane];
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < p.ring; ++i) hopper::mbar_init(&full[i], 1);
      hopper::fence_barrier_init();
      for (int i = 0; i < 4; ++i) hopper::prefetch_tensor_map(&p.maps[i]);
    }
    __syncwarp();
    hopper::named_bar_arrive(kInitBar, kBlock);
    if (lane == 0) {
      Walk w;
      w.start(p, plan);
      for (int i = 0; i < p.ring && w.more(p); ++i) w.issue(p, ring, full);
    }
    return;
  }
  hopper::named_bar_sync(kInitBar, kBlock);  // the ring and plan are set
  int uses = 0;  // the block's stages, to know whether the ring refills
  for (int g = blockIdx.x; g < p.total; g += gridDim.x) {
    const Item t = item_at(plan, g);
    uses += (t.s1 - t.s0) * plan[t.prod].nb;
  }
  // consumer thread 0 refills the ring past its first `ring` stages
  Walk walk;
  if (tid == 0 && uses > p.ring) {
    walk.start(p, plan);
    for (int i = 0; i < p.ring && walk.more(p); ++i)
      walk.issue(p, ring, full, false);
  }
  Block<F> blk{p, ring, act, tb, full, rstd, &flag, walk, 0, uses > p.ring,
               tid, lane, warp};

  // 1-2. the QKV items; each tile's merge: head norms, RoPE, q out, k and v
  // into the pools, then the head groups' counters
  {
    const Product& q = plan[kQkv];
    int have_mt = -1;
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      const int len = (t.s1 - t.s0) * kRows;
      // 8-row tiles: the first chunk in flight across the norm (16 rows
      // have no registers for it)
      typename Block<F>::Chunk first;
      if constexpr (F == 1)
        blk.load_chunk(kQkv, t.mt * MT, t.s0 * kRows, len / 8, tid, first);
      csync();  // act and rstd are free
      if (t.mt != have_mt) {
        blk.x_rstd(t.mt * MT);
        csync();
        have_mt = t.mt;
      }
      blk.form(kQkv, t.mt * MT, t.s0 * kRows, len, first, F == 1);
      csync();
      blk.template mma_item<1>(t);
      // a warp's (row, head) of the tile: its scales, RoPE maps, norm
      // weights and pool row
      struct Head {
        float ws[EL], c2[EL], s2[EL], nw[EL];
        int pg, off;
      };
      auto head_of = [&](int w, Head& hd) {
        const int r = w / kHeads, h = t.ct * kHeads + w % kHeads;
        const int si = t.mt * MT + r;
        const bool in = w < MT * kHeads && si < s && h < nh;
        const float* nw = h < p.hq ? p.qn : p.kn;
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int dd = lane * EL + e;
          hd.ws[e] = in ? p.wqkv_s[h * DH + dd] : 0.f;
          hd.c2[e] = in ? p.c2[si * DH + dd] : 0.f;
          hd.s2[e] = in ? p.s2[si * DH + dd] : 0.f;
          hd.nw[e] = in ? nw[dd] : 0.f;
        }
        hd.pg = in ? p.page_idx[si] : 0;
        hd.off = in ? p.off[si] : 0;
      };
      if (!blk.arrive(q, t)) continue;
      Head head0;  // in flight with the splits' loads (8-row tiles)
      if constexpr (F == 1) head_of(warp, head0);
      blk.gather(q, t);
      for (int w = warp; w < MT * kHeads; w += kWarps) {
        const int r = w / kHeads, h = t.ct * kHeads + w % kHeads;
        const int si = t.mt * MT + r;
        if (si >= s || h >= nh) continue;
        Head hd;
        if (F == 1 && w == warp)
          hd = head0;
        else
          head_of(w, hd);
        float tv[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const int col = h * DH + lane * EL + e;
          tv[e] = tb[r * kTW + (col - t.ct * kCols)] * hd.ws[e];
        }
        const int pg = hd.pg;
        const bool fresh = hd.off == 0;
        const int64_t row =
            (static_cast<int64_t>(pg) * p.page + hd.off) * p.hkv * DH;
        if (h >= p.hq + p.hkv) {
          const int gv = h - p.hq - p.hkv;
          if constexpr (kInt8)
            store_row<EL>(tv, fresh,
                          p.v_scale + static_cast<int64_t>(pg) * p.hkv + gv,
                          v_pool + row + gv * DH + lane * EL, lane);
          else
            store_row_bf16(tv, EL, v_pool + row + gv * DH + lane * EL);
          continue;
        }
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) ss += tv[e] * tv[e];
        const float rn = rsqrtf(warp_sum(ss) / static_cast<float>(DH) + m.eps);
        float n[EL], o[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e) n[e] = tv[e] * rn * hd.nw[e];
#pragma unroll
        for (int e = 0; e < EL; ++e) {
          const float partner = __shfl_xor_sync(0xffffffffu, n[e], 16);
          o[e] = n[e] * hd.c2[e] + partner * hd.s2[e];
        }
        if (h < p.hq) {
          float* dst =
              p.qbuf + (static_cast<int64_t>(si) * p.hq + h) * DH + lane * EL;
#pragma unroll
          for (int e = 0; e < EL; ++e) dst[e] = o[e];
        } else {
          const int gk = h - p.hq;
          if constexpr (kInt8)
            store_row<EL>(o, fresh,
                          p.k_scale + static_cast<int64_t>(pg) * p.hkv + gk,
                          k_pool + row + gk * DH + lane * EL, lane);
          else
            store_row_bf16(o, EL, k_pool + row + gk * DH + lane * EL);
        }
      }
      csync();  // the tile's rows are written: release them
      if (tid == 0) {
        for (int hh = 0; hh < kHeads; ++hh) {
          const int h = t.ct * kHeads + hh;
          if (h >= nh) break;
          const int grp = h < p.hq ? h / rep
                        : h < p.hq + p.hkv ? h - p.hq : h - p.hq - p.hkv;
          red_release(p.ready + t.mt * p.hkv + grp, 1);
        }
      }
    }
  }

  // 3. attention: the live items (split j, slot, KV head) with j under
  // the slot's live splits, numbered densely, splits slowest (so that each
  // split's items spread over the grid), slots, then KV heads; block b takes
  // live items b, b + grid, ...: an item past a slot's length takes no
  // block's turn. Each waits for its head group's QKV merges.
  const int cap_pos = (p.slot_cap > 0 ? p.slot_cap : p.maxp) * p.page;
  int j = 0, base = 0;  // the walk's split and its first live number
  int in_j = p.noattn ? 0 : p.hkv * slots_past(p.lens, s, cap_pos,
                                                p.attn_split, 0, lane);
  for (int L = blockIdx.x; !p.noattn; L += gridDim.x) {
    while (j < p.n_split && L >= base + in_j) {
      base += in_j;
      ++j;
      in_j = j < p.n_split ? p.hkv * slots_past(p.lens, s, cap_pos,
                                                p.attn_split, j, lane)
                           : 0;
    }
    if (j >= p.n_split) break;
    const int si = nth_slot_past(p.lens, s, cap_pos, p.attn_split, j,
                                 (L - base) / p.hkv, lane);
    const int g = (L - base) % p.hkv, pair = si * p.hkv + g;
    const int len = min(p.lens[si], cap_pos);
    csync();  // attention's scratch (act, tb) is free
    if (tid == 0) wait_count(p.ready + (si / MT) * p.hkv + g, rep + 2);
    csync();
    const int64_t head = static_cast<int64_t>(si) * p.hq * DH;
    const Meet meet{p.attn_part + static_cast<int64_t>(pair) * p.n_split *
                                      rep * (DH + 2),
                    p.attn_count + pair};
    float* sm = reinterpret_cast<float*>(act);
    if (p.slot_cap > 0) {
      attend_split<DH>(
          p.qbuf + head, g, rep, k_pool, v_pool, p.hkv, p.page,
          SlotPages{p.slot_base + static_cast<int64_t>(si) * p.slot_maxp},
          len, p.attn_split, j, meet, p.aout + head, sm);
    } else {
      attend_split<DH>(
          p.qbuf + head, g, rep, k_pool, v_pool, p.hkv, p.page,
          TablePages{p.tables + static_cast<int64_t>(si) * p.maxp}, len,
          p.attn_split, j, meet, p.aout + head, sm, p.k_scale, p.v_scale);
    }
  }
  grid.sync();  // wait 1: wo reads every head of the attention output
  if (blockIdx.x == 0)
    for (int i = tid; i < p.mtiles * p.hkv; i += kThreads) p.ready[i] = 0;

  // 4. wo; each tile's merge: x1 = x + (attn @ wo) * wo_s
  {
    const Product& q = plan[kWo];
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      csync();
      blk.form(kWo, t.mt * MT, t.s0 * kRows, (t.s1 - t.s0) * kRows,
               typename Block<F>::Chunk{}, false);
      csync();
      blk.template mma_item<1>(t);
      if (!blk.arrive(q, t)) continue;
      // this thread's elements of the tile: their operands (x and wo_s); the
      // first ones' loads in flight with the splits'
      auto operands = [&](int k, float& ea, float& eb) {
        const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
        const int si = t.mt * MT + r, col = t.ct * kCols + c;
        const bool in = si < s && col < d;
        ea = in ? to_f(m.x[static_cast<int64_t>(si) * d + col]) : 0.f;
        eb = in ? m.wo_s[col] : 0.f;
      };
      float ea[kAhead], eb[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) operands(k, ea[k], eb[k]);
      blk.gather(q, t);
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
        const int si = t.mt * MT + r, col = t.ct * kCols + c;
        if (si < s && col < d)
          m.x1[static_cast<int64_t>(si) * d + col] = a + tb[r * kTW + c] * b;
      }
    }
  }
  grid.sync();  // wait 2: the FFN norm needs every column of x1

  // 5. gate/up; each pair's merge: h = bf16(silu(g) * u)
  {
    const Product& q = plan[kGu];
    int have_mt = -1;
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      const int len = (t.s1 - t.s0) * kRows;
      typename Block<F>::Chunk first;  // as in the QKV items
      if constexpr (F == 1)
        blk.load_chunk(kGu, t.mt * MT, t.s0 * kRows, len / 8, tid, first);
      csync();
      if (t.mt != have_mt) {
        blk.x1_rstd(t.mt * MT, tb);
        have_mt = t.mt;
      }
      blk.form(kGu, t.mt * MT, t.s0 * kRows, len, first, F == 1);
      csync();
      blk.template mma_item<2>(t);
      if (!blk.arrive(q, t)) continue;
      // this thread's elements of the tile: their operands (the gate's and up's scales); the
      // first ones' loads in flight with the splits'
      auto operands = [&](int k, float& ea, float& eb) {
        const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
        const int si = t.mt * MT + r, col = t.ct * kCols + c;
        const bool in = si < s && col < m.f;
        ea = in ? m.gu_s[col] : 0.f;
        eb = in ? m.gu_s[m.f + col] : 0.f;
      };
      float ea[kAhead], eb[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) operands(k, ea[k], eb[k]);
      blk.gather(q, t);
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
        const int si = t.mt * MT + r, col = t.ct * kCols + c;
        if (si >= s || col >= m.f) continue;
        const float gv = tb[r * kTW + c] * a;
        const float uv = tb[r * kTW + kCols + c] * b;
        reinterpret_cast<__nv_bfloat16*>(m.part_b)[
            static_cast<int64_t>(si) * m.f + col] =
            __float2bfloat16(gv * (1.f / (1.f + expf(-gv))) * uv);
      }
    }
  }
  grid.sync();  // wait 3: down reads every column of h

  // 6. down; each tile's merge: out = x1 + (h @ down) * down_s
  {
    const Product& q = plan[kDn];
    for (int g = first_item(q); g < q.base + q.items; g += gridDim.x) {
      const Item t = item_at(plan, g);
      csync();
      blk.form(kDn, t.mt * MT, t.s0 * kRows, (t.s1 - t.s0) * kRows,
               typename Block<F>::Chunk{}, false);
      csync();
      blk.template mma_item<1>(t);
      if (!blk.arrive(q, t)) continue;
      // this thread's elements of the tile: their operands (x1 and down_s); the
      // first ones' loads in flight with the splits'
      auto operands = [&](int k, float& ea, float& eb) {
        const int i = tid + k * kThreads, r = i / kCols, c = i % kCols;
        const int si = t.mt * MT + r, col = t.ct * kCols + c;
        const bool in = si < s && col < d;
        ea = in ? __ldcg(m.x1 + static_cast<int64_t>(si) * d + col) : 0.f;
        eb = in ? m.dn_s[col] : 0.f;
      };
      float ea[kAhead], eb[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) operands(k, ea[k], eb[k]);
      blk.gather(q, t);
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
        const int si = t.mt * MT + r, col = t.ct * kCols + c;
        if (si < s && col < d)
          m.out[static_cast<int64_t>(si) * d + col] =
              __float2bfloat16(a + tb[r * kTW + c] * b);
      }
    }
  }
}

// Row tile of S rows: 8 or 16 (8 rows a fragment; more rows take more row
// tiles: a 32-row tile's accumulators spilled under 168 registers a
// thread).
__host__ __device__ constexpr int frags_of(int s) { return s <= 8 ? 1 : 2; }

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

template <int F, int DH, typename TP>
int blocks_for() {
  constexpr int MT = 8 * F;
  // the attribute at the most the plan may ask for, once
  static const int blocks = resident_blocks(
      decoder_layer_kernel<F, DH, TP>, layer_smem(MT, max_ring(MT)));
  return blocks;
}

template <int F, int DH, typename TP>
int launch(const LayerArgs& p, int grid, cudaStream_t stream) {
  const int blocks = blocks_for<F, DH, TP>();
  if (blocks <= 0)
    return blocks < 0 ? -blocks
                      : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (grid > blocks || p.ring > max_ring(8 * F))
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {const_cast<LayerArgs*>(&p)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decoder_layer_kernel<F, DH, TP>),
      dim3(grid), dim3(kBlock), args, layer_smem(8 * F, p.ring), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename TP>
int by_rows(const LayerArgs& p, int grid, cudaStream_t stream) {
  return frags_of(p.mlp.s) == 1 ? launch<1, DH, TP>(p, grid, stream)
                                 : launch<2, DH, TP>(p, grid, stream);
}

template <typename TP, int DH>
int blocks_dh(int mt) {
  return frags_of(mt) == 1 ? blocks_for<1, DH, TP>() : blocks_for<2, DH, TP>();
}

template <typename TP>
int blocks_by_tile(int mt, int dh) {
  if (mt != 4 && mt != 8 && mt != 16 && mt != 32)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) return blocks_dh<TP, 64>(mt);
  if (dh == 128) return blocks_dh<TP, 128>(mt);
  return -static_cast<int>(cudaErrorInvalidValue);
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

// The C entry of either source: checks the arguments, then launches the
// kernel for pool type TP (int8 pools come with scale planes). See
// csrc/decoder_layer.cu for the arguments.
template <typename TP>
int run_layer(
    const void* x, const float* c2, const float* s2, const float* attn_norm,
    const int8_t* wqkv_q, const float* wqkv_s, const float* q_norm,
    const float* k_norm, const int8_t* wo_q, const float* wo_s,
    const float* ffn_norm, const int8_t* gateup_q, const float* gateup_s,
    const int8_t* down_q, const float* down_s, const int* page_idx,
    const int* off, void* k_pool, void* v_pool, const int* lens,
    const int* tables, float* part_a, int s, int d, int hq, int hkv, int dh,
    int f, int page, int maxp, int slot_cap, int slot_maxp, int slot_base,
    float eps, int ks_qkv, int ks_wo, int ks_gu, int ks_dn, float* part_b,
    float* qbuf, float* aout, float* x1, float* y, void* out, float* k_scale,
    float* v_scale, int noattn, int attn_split, int n_split,
    float* attn_part, int* attn_count, const void* maps, int* counts,
    int ring, int grid, void* stream) {
  constexpr bool kv8 = sizeof(TP) == 1;
  const int a = hq * dh;
  if (s < 1 || s > kMaxRows || hkv < 1 || hq % hkv != 0 ||
      hq / hkv > kMaxRep || page < 1 || d % kRows != 0 || a % kRows != 0 ||
      f % kRows != 0 || d < kRows || f < kRows ||
      (slot_cap <= 0 && (tables == nullptr || maxp < 1)) ||
      kv8 != (k_scale != nullptr) || kv8 != (v_scale != nullptr) ||
      (kv8 && slot_cap > 0) || attn_split < 1 || attn_split > kMaxSplit ||
      n_split != live_splits((slot_cap > 0 ? slot_cap : maxp) * page,
                             attn_split) ||
      attn_part == nullptr || attn_count == nullptr || maps == nullptr ||
      counts == nullptr || ring < 2 || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (dh != 64 && dh != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = 8 * frags_of(s);
  const int mtiles = (s + mt - 1) / mt;
  const int a3 = (hq + 2 * hkv) * dh;
  // columns, boxes a stage, splits, contraction rows, box 1's offset
  const int spec[4][5] = {{a3, 1, ks_qkv, d, 0},
                          {d, 1, ks_wo, a, 0},
                          {f, 2, ks_gu, d, f},
                          {d, 1, ks_dn, f, 0}};
  LayerArgs p;
  memset(&p, 0, sizeof(p));
  memcpy(p.maps, maps, sizeof(p.maps));
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
      return static_cast<int>(cudaErrorInvalidValue);
    q.items = mtiles * q.ctiles * q.ks;
    q.base = base;
    base += q.items;
    most_tiles = mtiles * q.ctiles > most_tiles ? mtiles * q.ctiles
                                                : most_tiles;
  }
  p.c2 = c2;
  p.s2 = s2;
  p.anorm = attn_norm;
  p.wqkv_s = wqkv_s;
  p.qn = q_norm;
  p.kn = k_norm;
  p.page_idx = page_idx;
  p.off = off;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.lens = lens;
  p.tables = tables;
  p.hq = hq;
  p.hkv = hkv;
  p.page = page;
  p.maxp = maxp;
  p.slot_cap = slot_cap;
  p.slot_maxp = slot_maxp;
  p.slot_base = slot_base;
  p.noattn = noattn;
  p.attn_split = attn_split;
  p.n_split = n_split;
  p.attn_part = attn_part;
  p.attn_count = attn_count;
  p.qbuf = qbuf;
  p.aout = aout;
  p.tile_count = counts;
  p.ready = counts + most_tiles;
  p.mtiles = mtiles;
  p.ring = ring;
  p.total = base;
  p.mlp = MlpArgs{static_cast<const __nv_bfloat16*>(x), wo_q, wo_s, ffn_norm,
                  gateup_q, gateup_s, down_q, down_s, s, d, a, f, eps,
                  ks_wo, ks_gu, ks_dn, part_a, part_b, x1, y,
                  static_cast<__nv_bfloat16*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dh == 64 ? by_rows<64, TP>(p, grid, st) : by_rows<128, TP>(p, grid, st);
}

}  // namespace
