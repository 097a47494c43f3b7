// Flash-attention training kernels for Hopper (sm_90a): the forward that
// also writes the per-row log-sum-exp, and the dq and dk/dv backward
// kernels.  Causal, optional sliding window, grouped-query heads.
//
// Replaces the Pallas TPU kernels of
//   src/repro/kernels/flash_attention_bwd.py :: flash_attention_vjp
// and computes the same functions:
//   flash_attention_fwd_lse  (_fwd → _fwd_kernel)
//       q [B,S,H,hd], k/v [B,S,KV,hd] -> out [B,S,H,hd], lse [B,H,S] f32
//   flash_attention_dq       (_bwd → _dq_kernel)
//       dq = Σ_k P ⊙ (dP − Δ) · scale · K,  P = exp(q·k·scale − lse)
//   flash_attention_dkv      (_bwd → _dkv_kernel)
//       dv = Σ_q Pᵀ dO,  dk = Σ_q (P ⊙ (dP − Δ) · scale)ᵀ Q, each summed
//       over the H/KV q heads of the kv head's group
// with dP = dO·Vᵀ and Δ = rowsum(out ⊙ dO) (computed by the caller, as
// the JAX backward does outside its kernels).  Each also takes a
// sequence-parallel rank's rows: q, dO, out, lse, Δ and dq of Sq query
// rows at key positions q_offset .. q_offset + Sq - 1 of k, v, dk and dv
// [B,Sk,KV,hd] (the reference's _causal_mask(Sq, Sk, q_offset, window));
// every dk / dv row is written, zeros where no query row sees its key.
//
// bf16 runs on the tensor cores: the forward on the shared block of
// flash_attention_fwd_sm90.cuh, dq and dk/dv on the wgmma + TMA kernels
// of flash_attention_bwd_sm90.cuh (whose header says what bounds them
// and how the design answers).  float32 runs the scalar parity kernels
// below and the scalar forward block (flash_attention_fwd.cuh): they are
// held to 5e-5 of max |plain|, which TF32 tensor cores (10-bit mantissa)
// cannot meet.
//
// The float32 backward is simple and exact rather than fast: scalar f32
// FMAs from padded shared-memory tiles; hd 64, 80 or 128.  The TPU grids
// carried dq (resp. dk/dv) in VMEM scratch over a sequential k (resp.
// q × group) grid axis; here that axis is a loop inside the block:
//   * dq: one block of 128 threads per (batch, q head, 64-row q tile),
//     looping over 32-row K/V tiles up to the causal limit, each thread
//     pair owning one q row (half the columns, half of dq's dims);
//   * dk/dv: one block of 256 threads per (batch, kv head, 64-row key
//     tile), looping over the group's q heads and, for each, over the
//     32-row q tiles from the tile's causal start to its window end; four
//     threads own one key row (a quarter of the columns and of dk/dv's
//     dims).  Each block owns its dk/dv rows outright, so there are no
//     atomics and the gradients are bitwise repeatable run to run.
// Scores are recomputed in f32 from q pre-scaled by 1/sqrt(hd), and P =
// exp(s - lse) uses the forward's lse: the scalar forward's own
// arithmetic (the same FMA order over hd), so P matches it bit for bit.
#include "flash_attention_fwd.cuh"
#include "flash_attention_bwd_sm90.cuh"

namespace {

using flash::kBK;
using flash::kBQ;
using flash::kThreads;
using flash::stage_rows;
using flash::store;
using flash_tc::live;

constexpr int kDkvThreads = 256;
constexpr int kBKV = 64;  // key rows per dk/dv block (four threads per row)
constexpr int kBQV = 32;  // q rows per dk/dv step

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBQ * (HD + 1) +
                          2 * (size_t)kBK * (HD + 1) +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int q_off, int num_heads, int num_kv_heads,
                int causal, int window, float scale) {
  constexpr int kHalf = HD / 2;     // dq dims per thread
  constexpr int kCols = kBK / 2;    // score columns per thread
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;

  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBQ][HD + 1], pre-scaled
  float* sO = sQ + kBQ * (HD + 1);       // [kBQ][HD + 1] dout
  float* sK = sO + kBQ * (HD + 1);       // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);       // [kBK][HD + 1]
  float* sS = sV + kBK * (HD + 1);       // [kBQ][kBK + 1] dS

  const int q0 = qt * kBQ;
  stage_rows<T, HD, kBQ, kThreads>(q, sQ, HD + 1, b, q0, Sq, num_heads, h,
                                   tid, scale);
  stage_rows<T, HD, kBQ, kThreads>(dout, sO, HD + 1, b, q0, Sq, num_heads, h,
                                   tid, 1.f);
  const int qrow = q0 + row;  // this row of q, at key position q_off + qrow
  const size_t lrow = ((size_t)b * num_heads + h) * Sq + qrow;
  const float lse_r = qrow < Sq ? lse[lrow] : 0.f;
  const float del_r = qrow < Sq ? delta[lrow] : 0.f;

  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(Sk, q_off + q0 + kBQ) : Sk;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_off + q0 - window + 1) / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    stage_rows<T, HD, kBK, kThreads>(k, sK, HD + 1, b, k0, Sk, num_kv_heads,
                                     kvh, tid, 1.f);
    stage_rows<T, HD, kBK, kThreads>(v, sV, HD + 1, b, k0, Sk, num_kv_heads,
                                     kvh, tid, 1.f);
    __syncthreads();

    // scores and dP for the interleaved columns c = 2j + half
    float sc[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) sc[j] = dp[j] = 0.f;
    const float* qr = sQ + row * (HD + 1);
    const float* orow = sO + row * (HD + 1);
    const float* kr = sK + half * (HD + 1);
    const float* vr = sV + half * (HD + 1);
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d], od = orow[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        sc[j] = fmaf(qd, kr[2 * j * (HD + 1) + d], sc[j]);
        dp[j] = fmaf(od, vr[2 * j * (HD + 1) + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = 2 * j + half;
      const float p =
          live(qrow, k0 + c, Sq, Sk, q_off, causal, window)
              ? expf(sc[j] - lse_r)
              : 0.f;
      sS[row * (kBK + 1) + c] = p * (dp[j] - del_r) * scale;
    }
    __syncwarp();  // the partner's dS are visible

    // dq += dS · K for this thread's interleaved dims d = 2j + half
    const float* sr = sS + row * (kBK + 1);
    for (int c = 0; c < kBK; ++c) {
      const float ds = sr[c];
      const float* kc = sK + c * (HD + 1) + half;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) acc[j] = fmaf(ds, kc[2 * j], acc[j]);
    }
    __syncthreads();  // before the next tile overwrites sK/sV/sS
  }

  if (qrow < Sq) {
    T* drow = dq + (((size_t)b * Sq + qrow) * num_heads + h) * HD;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) store(drow + 2 * j + half, acc[j]);
  }
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBKV * (HD + 1) +
                          2 * (size_t)kBQV * (HD + 1) +
                          2 * (size_t)kBKV * (kBQV + 1) + 2 * (size_t)kBQV);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDkvThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int q_off, int num_heads,
                 int num_kv_heads, int causal, int window, float scale) {
  constexpr int kQuarter = HD / 4;  // dk/dv dims per thread
  constexpr int kCols = kBQV / 4;   // score columns per thread
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = num_heads / num_kv_heads;
  const int tid = threadIdx.x;
  const int row = tid >> 2, part = tid & 3;

  extern __shared__ float smem[];
  float* sK = smem;                      // [kBKV][HD + 1]
  float* sV = sK + kBKV * (HD + 1);      // [kBKV][HD + 1]
  float* sQ = sV + kBKV * (HD + 1);      // [kBQV][HD + 1], pre-scaled
  float* sO = sQ + kBQV * (HD + 1);      // [kBQV][HD + 1] dout
  float* sP = sO + kBQV * (HD + 1);      // [kBKV][kBQV + 1] P
  float* sS = sP + kBKV * (kBQV + 1);    // [kBKV][kBQV + 1] dS / scale
  float* sL = sS + kBKV * (kBQV + 1);    // [kBQV] lse
  float* sD = sL + kBQV;                 // [kBQV] delta

  const int k0 = kt * kBKV;
  stage_rows<T, HD, kBKV, kDkvThreads>(k, sK, HD + 1, b, k0, Sk,
                                       num_kv_heads, kvh, tid, 1.f);
  stage_rows<T, HD, kBKV, kDkvThreads>(v, sV, HD + 1, b, k0, Sk,
                                       num_kv_heads, kvh, tid, 1.f);
  const int kpos = k0 + row;

  float ak[kQuarter], av[kQuarter];
#pragma unroll
  for (int j = 0; j < kQuarter; ++j) ak[j] = av[j] = 0.f;

  // q rows that can see this key tile: from its causal start to the
  // window's end past its last key (q row i at key position q_off + i;
  // none where the tile lies past the last row or before the first
  // row's window, and its rows are then written as zeros)
  const int q_begin = causal ? (max(0, k0 - q_off) / kBQV) * kBQV : 0;
  const int q_end =
      window > 0 ? min(Sq, k0 + kBKV - 1 + window - q_off) : Sq;

  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const float* lse_h = lse + ((size_t)b * num_heads + h) * Sq;
    const float* del_h = delta + ((size_t)b * num_heads + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQV) {
      __syncthreads();  // the previous step is done with sQ/sO/sP/sS
      stage_rows<T, HD, kBQV, kDkvThreads>(q, sQ, HD + 1, b, q0, Sq,
                                           num_heads, h, tid, scale);
      stage_rows<T, HD, kBQV, kDkvThreads>(dout, sO, HD + 1, b, q0, Sq,
                                           num_heads, h, tid, 1.f);
      if (tid < kBQV) {
        const int qp = q0 + tid;
        sL[tid] = qp < Sq ? lse_h[qp] : 0.f;
        sD[tid] = qp < Sq ? del_h[qp] : 0.f;
      }
      __syncthreads();

      // scores and dP for the interleaved q columns c = 4j + part
      float sc[kCols], dp[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[j] = dp[j] = 0.f;
      const float* kr = sK + row * (HD + 1);
      const float* vr = sV + row * (HD + 1);
      const float* qc = sQ + part * (HD + 1);
      const float* oc = sO + part * (HD + 1);
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          sc[j] = fmaf(qc[4 * j * (HD + 1) + d], kd, sc[j]);
          dp[j] = fmaf(oc[4 * j * (HD + 1) + d], vd, dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = 4 * j + part;
        const float p = live(q0 + c, kpos, Sq, Sk, q_off, causal, window)
                            ? expf(sc[j] - sL[c])
                            : 0.f;
        sP[row * (kBQV + 1) + c] = p;
        // the scale is in the pre-scaled q that dS multiplies below
        sS[row * (kBQV + 1) + c] = p * (dp[j] - sD[c]);
      }
      __syncwarp();  // the row's other three threads' P/dS are visible

      // dv += Pᵀ dO, dk += dSᵀ Q for this thread's dims d = 4j + part
      const float* pr = sP + row * (kBQV + 1);
      const float* sr = sS + row * (kBQV + 1);
      for (int c = 0; c < kBQV; ++c) {
        const float p = pr[c], ds = sr[c];
        const float* oq = sO + c * (HD + 1) + part;
        const float* qq = sQ + c * (HD + 1) + part;
#pragma unroll
        for (int j = 0; j < kQuarter; ++j) {
          av[j] = fmaf(p, oq[4 * j], av[j]);
          ak[j] = fmaf(ds, qq[4 * j], ak[j]);
        }
      }
    }
  }

  if (kpos < Sk) {
    const size_t off = (((size_t)b * Sk + kpos) * num_kv_heads + kvh) * HD;
#pragma unroll
    for (int j = 0; j < kQuarter; ++j) {
      store(dk + off + 4 * j + part, ak[j]);
      store(dv + off + 4 * j + part, av[j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch, int Sq, int Sk, int q_off, int H,
                      int KV, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  static bool attr_set = false;
  cudaError_t e =
      flash_tc::raise_smem_once(flash_dq_kernel<T, HD>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  const float scale = flash_tc::bwd_scale(HD);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, batch);
  flash_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Sq, Sk, q_off, H, KV, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int batch,
                       int Sq, int Sk, int q_off, int H, int KV, int causal,
                       int window, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  static bool attr_set = false;
  cudaError_t e =
      flash_tc::raise_smem_once(flash_dkv_kernel<T, HD>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  const float scale = flash_tc::bwd_scale(HD);
  dim3 grid((Sk + kBKV - 1) / kBKV, KV, batch);
  flash_dkv_kernel<T, HD><<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, q_off, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar kernels), 1 = bfloat16 (the tensor
// cores); head_dim 64, 80 or 128.  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for shapes it does not take).
#define REPRO_DISPATCH(F32, BF16)                                     \
  if (dtype == 0 && head_dim == 64) return (int)F32(64);              \
  if (dtype == 0 && head_dim == 80) return (int)F32(80);              \
  if (dtype == 0 && head_dim == 128) return (int)F32(128);            \
  if (dtype == 1 && head_dim == 64) return (int)BF16(64);             \
  if (dtype == 1 && head_dim == 80) return (int)BF16(80);             \
  if (dtype == 1 && head_dim == 128) return (int)BF16(128);           \
  return (int)cudaErrorInvalidValue

extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int batch, int seq_q, int seq_k,
                                       int q_offset, int num_heads,
                                       int num_kv_heads, int head_dim,
                                       int causal, int window, int dtype,
                                       void* stream) {
  if (flash::bad_shape(batch, seq_q, seq_k, q_offset, num_heads,
                       num_kv_heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define REPRO_F32(HD)                                                       \
  flash::launch_fwd<float, HD, true>(q, k, v, out, l, batch, seq_q, seq_k, \
                                     q_offset, num_heads, num_kv_heads,     \
                                     causal, window, s)
#define REPRO_BF16(HD)                                                      \
  flash_tc::launch_fwd_tc<HD, true>(q, k, v, out, l, batch, seq_q, seq_k,  \
                                    q_offset, num_heads, num_kv_heads,      \
                                    causal, window, s)
  REPRO_DISPATCH(REPRO_F32, REPRO_BF16);
#undef REPRO_F32
#undef REPRO_BF16
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int batch, int seq_q, int seq_k,
                                  int q_offset, int num_heads,
                                  int num_kv_heads, int head_dim, int causal,
                                  int window, int dtype, void* stream) {
  if (flash::bad_shape(batch, seq_q, seq_k, q_offset, num_heads,
                       num_kv_heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
#define REPRO_F32(HD)                                                     \
  launch_dq<float, HD>(q, k, v, dout, l, d, dq, batch, seq_q, seq_k,      \
                       q_offset, num_heads, num_kv_heads, causal, window, s)
#define REPRO_BF16(HD)                                                    \
  flash_tc::launch_dq_tc<HD>(q, k, v, dout, l, d, dq, batch, seq_q, seq_k,\
                             q_offset, num_heads, num_kv_heads, causal,   \
                             window, s)
  REPRO_DISPATCH(REPRO_F32, REPRO_BF16);
#undef REPRO_F32
#undef REPRO_BF16
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int batch, int seq_q,
                                   int seq_k, int q_offset, int num_heads,
                                   int num_kv_heads, int head_dim,
                                   int causal, int window, int dtype,
                                   void* stream) {
  if (flash::bad_shape(batch, seq_q, seq_k, q_offset, num_heads,
                       num_kv_heads) ||
      num_kv_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
#define REPRO_F32(HD)                                                     \
  launch_dkv<float, HD>(q, k, v, dout, l, d, dk, dv, batch, seq_q, seq_k, \
                        q_offset, num_heads, num_kv_heads, causal, window, s)
#define REPRO_BF16(HD)                                                    \
  flash_tc::launch_dkv_tc<HD>(q, k, v, dout, l, d, dk, dv, batch, seq_q,  \
                              seq_k, q_offset, num_heads, num_kv_heads,   \
                              causal, window, s)
  REPRO_DISPATCH(REPRO_F32, REPRO_BF16);
#undef REPRO_F32
#undef REPRO_BF16
}
#undef REPRO_DISPATCH
