// Dense flash-decode for Hopper (sm_90a): one new query token per
// sequence attends to its own contiguous KV cache, float, bfloat16 or int8.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention.py :: decode_attention
//   src/repro/kernels/decode_attention_q8.py :: decode_attention_q8
// and computes the same functions: GQA decode of q [B, H, hd] over caches
// [B, L, kv_heads, hd] (int8 with bf16 per-(token, kv head) scales
// [B, L, kv_heads, 1] for _q8), keys at positions < n_valid[b].  Unlike
// the TPU kernels (L % block_k == 0), any L is taken, and rows at or past
// n_valid are never loaded.
//
// The blocks themselves (what bounds them, and the designs) are shared
// with the paged decode kernels, the dense cache being their pool with one
// page of L rows per sequence: bf16 q, over bf16 or int8 caches, runs the
// split-KV tensor-core block of decode_attention_split_sm90.cuh (two
// launches when the ring is split, pass 1 and the combine), float32 q the
// scalar block of decode_attention_common.cuh.
#include "decode_attention_common.cuh"
#include "decode_attention_split_sm90.cuh"

// dtype (of q and out): 0 = float32, 1 = bfloat16; caches share it.
// bf16 takes num_splits ranges of split_len ring slots, with the f32
// partials part_acc [B, H, splits, hd], part_m / part_l [B, H, splits]
// when num_splits > 1; float32 ignores them.  Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for shapes the kernel does
// not take).
extern "C" int decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* n_valid, void* out, void* part_acc, void* part_m,
    void* part_l, int batch, int num_heads, int num_kv_heads, int head_dim,
    int cache_len, int num_splits, int split_len, int dtype, void* stream) {
  if (dtype == 1)
    return repro_decode_split::dispatch<__nv_bfloat16, false>(
        q, k_cache, v_cache, nullptr, nullptr, nullptr, n_valid, out,
        part_acc, part_m, part_l, batch, num_heads, num_kv_heads, head_dim,
        batch, cache_len, 1, 0, num_splits, split_len, stream);
  return repro_decode::dispatch<false, false>(
      q, k_cache, v_cache, nullptr, nullptr, nullptr, n_valid, out, batch,
      num_heads, num_kv_heads, head_dim, batch, cache_len, 1, 0, dtype,
      stream);
}

// int8 caches with bf16 scales; dtype is that of q and out.  bf16 takes
// the split arguments as decode_attention does; float32 ignores them.
extern "C" int decode_attention_q8(
    const void* q, const void* k_cache, const void* k_scale,
    const void* v_cache, const void* v_scale, const void* n_valid, void* out,
    void* part_acc, void* part_m, void* part_l, int batch, int num_heads,
    int num_kv_heads, int head_dim, int cache_len, int num_splits,
    int split_len, int dtype, void* stream) {
  if (dtype == 1)
    return repro_decode_split::dispatch<int8_t, false>(
        q, k_cache, v_cache, k_scale, v_scale, nullptr, n_valid, out,
        part_acc, part_m, part_l, batch, num_heads, num_kv_heads, head_dim,
        batch, cache_len, 1, 0, num_splits, split_len, stream);
  return repro_decode::dispatch<false, true>(
      q, k_cache, v_cache, k_scale, v_scale, nullptr, n_valid, out, batch,
      num_heads, num_kv_heads, head_dim, batch, cache_len, 1, 0, dtype,
      stream);
}
