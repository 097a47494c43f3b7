// Paged flash-decode for Hopper (sm_90a): one new query token per
// sequence attends to its KV cache through a block table, over float,
// bfloat16 or int8 pages.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention_paged.py :: decode_attention_paged
//   src/repro/kernels/decode_attention_paged.py :: decode_attention_paged_q8
// and computes the same functions: GQA decode over a shared page pool
// [num_blocks, page_size, kv_heads, head_dim] (int8 pages with bf16
// per-(token, kv head) scale pages [num_blocks, page_size, kv_heads, 1]
// for _q8), an online softmax over the sequence's live ring slots, and the
// token-id ring mask with an optional window.
//
// The blocks themselves (what bounds them, and the designs) are shared
// with the dense decode kernels: bf16 q, over bf16 or int8 pages, runs the
// split-KV tensor-core block of decode_attention_split_sm90.cuh (two
// launches when the ring is split, pass 1 and the combine), float32 q the
// scalar block of decode_attention_common.cuh; this file holds the two C
// entry points.
#include "decode_attention_common.cuh"
#include "decode_attention_split_sm90.cuh"

// dtype (of q and out): 0 = float32, 1 = bfloat16; pages share it.  bf16
// takes num_splits ranges of split_len ring slots, with the f32 partials
// part_acc [B, H, splits, hd], part_m / part_l [B, H, splits] when
// num_splits > 1; float32 ignores them.  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for shapes the kernel does not
// take).
extern "C" int decode_attention_paged(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, void* part_acc,
    void* part_m, void* part_l, int batch, int num_heads, int num_kv_heads,
    int head_dim, int num_blocks, int page_size, int pages_per_seq,
    int window, int num_splits, int split_len, int dtype, void* stream) {
  if (dtype == 1)
    return repro_decode_split::dispatch<__nv_bfloat16, true>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out,
        part_acc, part_m, part_l, batch, num_heads, num_kv_heads, head_dim,
        num_blocks, page_size, pages_per_seq, window, num_splits, split_len,
        stream);
  return repro_decode::dispatch<true, false>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out,
      batch, num_heads, num_kv_heads, head_dim, num_blocks, page_size,
      pages_per_seq, window, dtype, stream);
}

// int8 pages with bf16 scale pages; dtype is that of q and out.  bf16
// takes the split arguments as decode_attention_paged does; float32
// ignores them.
extern "C" int decode_attention_paged_q8(
    const void* q, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, void* part_acc, void* part_m,
    void* part_l, int batch, int num_heads, int num_kv_heads, int head_dim,
    int num_blocks, int page_size, int pages_per_seq, int window,
    int num_splits, int split_len, int dtype, void* stream) {
  if (dtype == 1)
    return repro_decode_split::dispatch<int8_t, true>(
        q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out,
        part_acc, part_m, part_l, batch, num_heads, num_kv_heads, head_dim,
        num_blocks, page_size, pages_per_seq, window, num_splits, split_len,
        stream);
  return repro_decode::dispatch<true, true>(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out,
      batch, num_heads, num_kv_heads, head_dim, num_blocks, page_size,
      pages_per_seq, window, dtype, stream);
}
