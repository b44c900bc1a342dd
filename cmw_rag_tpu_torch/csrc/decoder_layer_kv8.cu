// Decoder-layer decode megakernel for Hopper (sm_90a), int8 KV pages.
//
// Replaces the TPU kernel cmw_rag_tpu/ops/decoder_layer.py:618
// decoder_layer_int8_kv8 (body _decoder_layer_kv8_kernel :480). The pools are int8 with a float32 scale
// per (page, KV head), this layer's [P, Hkv] planes (k_scale, v_scale),
// updated IN PLACE. Phase 2 follows the TPU kernel (:517-556): k after its
// norm and RoPE, and v, are rounded to bf16 (x's dtype) first; the first
// row of a page (off == 0) sets the page's scale to max(amax, 1e-8) *
// 1.25 / 127 (KV_HEADROOM, amax over the row's Dh values, one warp), any
// other row takes the page's scale as it stands; the row is quantized by
// division, rintf (half to even, as jnp.round) and a clip to +-127. A zero
// or unset scale (only the null page's rows of idle slots can meet one)
// gives +-inf or NaN before the clip, which fminf/fmaxf turn into +-127:
// nothing traps. Phase 3 reads this launch's rows and scales with
// ld.global.cg after the grid barrier; attend() folds the scales in as the
// TPU's int8 pipeline does. The bound adds the pages' scales to the int8
// K and V bytes (1 byte a value).
//
// The kernel is csrc/decoder_layer.cuh's, instantiated here for int8 pools
// only (the bf16 one is csrc/decoder_layer.cu), so that the two compile in
// parallel; the paged route only, as the TPU kernel.

#include "decoder_layer.cuh"

extern "C" {

// As decoder_layer_blocks of csrc/decoder_layer.cu, for int8 pools.
int decoder_layer_kv8_blocks(int mt, int dh) {
  return blocks_by_tile<int8_t>(mt, dh);
}

// As decoder_layer_encode of csrc/decoder_layer.cu.
int decoder_layer_kv8_encode(const void* w, int k, int n, void* map) {
  return encode_weight(w, k, n, map);
}

// As decoder_layer_int8 of csrc/decoder_layer.cu, over int8 pools with this
// layer's [P, Hkv] float32 scale planes k_scale and v_scale (both required,
// updated in place), on the paged route (slot_cap 0, tables given).
int decoder_layer_int8_kv8(
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
  return run_layer<int8_t>(
      x, c2, s2, attn_norm, wqkv_q, wqkv_s, q_norm, k_norm, wo_q, wo_s,
      ffn_norm, gateup_q, gateup_s, down_q, down_s, page_idx, off, k_pool,
      v_pool, lens, tables, part_a, s, d, hq, hkv, dh, f, page, maxp,
      slot_cap, slot_maxp, slot_base, eps, ks_qkv, ks_wo, ks_gu, ks_dn,
      part_b, qbuf, aout, x1, y, out, k_scale, v_scale, noattn, attn_split,
      n_split, attn_part, attn_count, maps, counts, ring, grid, stream);
}

}  // extern "C"
