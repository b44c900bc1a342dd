// Decoder-layer decode megakernel for Hopper (sm_90a), bf16 KV pages: one
// int8-weight decoder layer, for one new token per slot, in ONE launch.
//
// Replaces the TPU kernel cmw_rag_tpu/ops/decoder_layer.py:264
// decoder_layer_int8 (body _decoder_layer_kernel :143). The function, the
// bound and the design are in csrc/decoder_layer.cuh; the int8-KV
// instantiation is csrc/decoder_layer_kv8.cu.

#include "decoder_layer.cuh"

extern "C" {

// Blocks of one cooperative launch for the row tile mt (4, 8, 16 or 32 rows;
// up to 8 take one kernel, past it the 16-row one) and head dim dh, at the
// most shared memory the plan may give it (one block a SM): the grid of
// layer_plan. Negative: a CUDA error code.
int decoder_layer_blocks(int mt, int dh) {
  return blocks_by_tile<__nv_bfloat16>(mt, dh);
}

// The tensor map of a layer weight w [k, n] int8 (k a multiple of 64, n of
// 16, 16-byte aligned; boxes of 64 rows x 128 columns, 128-byte swizzle)
// into the 128 bytes at `map`, for either megakernel. Returns the CUDA
// error code.
int decoder_layer_encode(const void* w, int k, int n, void* map) {
  return encode_weight(w, k, n, map);
}

// x [S, D] bf16 (16-byte aligned); c2, s2 [S, Dh] float32; attn_norm,
// q_norm, k_norm and every scale float32; wqkv_q [D, (Hq + 2 Hkv) Dh],
// wo_q [Hq Dh, D], gateup_q [D, 2F], down_q [F, D] int8, read through the
// four tensor maps at `maps` (4 x 128 bytes in that order,
// decoder_layer_encode); page_idx, off, lens [S] int32; k_pool, v_pool
// this layer's [P, page, Hkv, Dh] bf16, written in place (k_scale and
// v_scale null); tables [S, maxp] int32 for the paged route (slot_cap 0),
// null for the slot-major route (slot_cap > 0 pages from slot_base + s *
// slot_maxp). S <= 256, Dh 64 or 128, Hq / Hkv at most 8, D, Hq Dh and F
// multiples of 64. The plan (ops/decoder_layer.py layer_plan): ks_qkv,
// ks_wo, ks_gu and ks_dn split the contraction of the QKV, wo, gate/up and
// down products into parts of at most 16 stages of 64 rows; `ring` stages
// of 8 KB (2 to the row tile's most); `grid` blocks (at most
// decoder_layer_blocks). Workspace (16-byte aligned): part_a the split
// partial tiles (for each product split more than once, row tiles x column
// tiles x ks x MT x 128 (gate/up 256) floats, MT the row tile), part_b h
// (S * F bf16), qbuf and aout S * Hq * Dh floats, x1 S * D (y is not read:
// null); counts the products' arrival counters (the
// most row tiles x column tiles of a product) then the head groups' (row
// tiles x Hkv), int32 zeros that each launch leaves 0. out [S, D] bf16.
// noattn != 0: the attention output is q (the ablation). Attention is cut
// into splits of attn_split positions (1 to 128), n_split = ceil(cap *
// page / attn_split) a (slot, KV head) with cap slot_cap on the slot-major
// route and maxp on the paged one; attn_part holds S * Hkv * n_split *
// (Hq / Hkv) * (Dh + 2) floats, attn_count S * Hkv int32 zeros (left 0).
// Returns the CUDA error code of the launch.
int decoder_layer_int8(
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
  return run_layer<__nv_bfloat16>(
      x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s,
      ffn_norm, gateup_q, gateup_s, down_q, down_s, page_idx, off, k_pool,
      v_pool, lens, tables, part_a, s, d, hq, hkv, dh, f, page, maxp,
      slot_cap, slot_maxp, slot_base, eps, ks_qkv, ks_wo, ks_gu, ks_dn,
      part_b, qbuf, aout, x1, y, out, k_scale, v_scale, noattn, attn_split,
      n_split, attn_part, attn_count, maps, counts, ring, grid, stream);
}

}  // extern "C"
