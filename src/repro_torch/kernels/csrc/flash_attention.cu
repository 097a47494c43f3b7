// Causal flash attention (prefill), forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py :: flash_attention
// and computes the same function: q [B,S,H,hd], k/v [B,S,KV,hd] ->
// out [B,S,H,hd]; beside it, q [B,Sq,H,hd] of the rows at key positions
// q_offset .. q_offset + Sq - 1 of k/v [B,Sk,KV,hd] (a sequence-parallel
// rank's rows, the reference's _causal_mask(Sq, Sk, q_offset, window)).  bf16 runs on the tensor cores
// (flash_attention_fwd_sm90.cuh: wgmma fed by TMA; its header says what
// bounds it on the card and how the design answers); float32 runs the
// scalar parity block of flash_attention_fwd.cuh.  Both are shared with
// the training forward, which also writes the log-sum-exp.
#include "flash_attention_fwd.cuh"
#include "flash_attention_fwd_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16; head_dim 64, 80 or 128.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes
// the kernel does not take).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int seq_q, int seq_k,
                               int q_offset, int num_heads,
                               int num_kv_heads, int head_dim, int causal,
                               int window, int dtype, void* stream) {
  if (flash::bad_shape(batch, seq_q, seq_k, q_offset, num_heads,
                       num_kv_heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_F32(HD)                                                        \
  return (int)flash::launch_fwd<float, HD, false>(                           \
      q, k, v, out, nullptr, batch, seq_q, seq_k, q_offset, num_heads,       \
      num_kv_heads, causal, window, s)
#define REPRO_BF16(HD)                                                       \
  return (int)flash_tc::launch_fwd_tc<HD, false>(                            \
      q, k, v, out, nullptr, batch, seq_q, seq_k, q_offset, num_heads,       \
      num_kv_heads, causal, window, s)
  if (dtype == 0 && head_dim == 64) REPRO_F32(64);
  if (dtype == 0 && head_dim == 80) REPRO_F32(80);
  if (dtype == 0 && head_dim == 128) REPRO_F32(128);
  if (dtype == 1 && head_dim == 64) REPRO_BF16(64);
  if (dtype == 1 && head_dim == 80) REPRO_BF16(80);
  if (dtype == 1 && head_dim == 128) REPRO_BF16(128);
#undef REPRO_F32
#undef REPRO_BF16
  return (int)cudaErrorInvalidValue;
}
