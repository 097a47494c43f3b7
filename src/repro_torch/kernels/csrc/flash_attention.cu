// Causal flash attention (prefill), forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py :: flash_attention
// and computes the same function: q [B,S,H,hd], k/v [B,S,KV,hd] ->
// out [B,S,H,hd].  The block, and what bounds it on the card, are in
// flash_attention_fwd.cuh (shared with the training forward, which also
// writes the log-sum-exp).
#include "flash_attention_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int seq_len,
                               int num_heads, int num_kv_heads, int head_dim,
                               int causal, int window, int dtype,
                               void* stream) {
  if (flash::bad_shape(batch, seq_len, num_heads, num_kv_heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T, HD)                                              \
  return (int)flash::launch_fwd<T, HD, false>(q, k, v, out, nullptr,     \
                                              batch, seq_len, num_heads, \
                                              num_kv_heads, causal,      \
                                              window, s)
  if (dtype == 0 && head_dim == 64) REPRO_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
