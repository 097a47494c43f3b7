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
// the JAX backward does outside its kernels).
//
// What bounds them on the card: operations (6 and 8 flops per q head ×
// hd × attended pair for dq and dk/dv, far above the byte bound at the
// training shapes).  Like the forward, these first versions are simple
// and exact rather than fast: scalar f32 FMAs from padded shared-memory
// tiles, f32 accumulators, no tensor cores.  The TPU grids carried dq
// (resp. dk/dv) in VMEM scratch over a sequential k (resp. q × group)
// grid axis; here that axis is a loop inside the block:
//   * dq: one block of 128 threads per (batch, q head, 64-row q tile),
//     looping over 32-row K/V tiles up to the causal limit, each thread
//     pair owning one q row (half the columns, half of dq's dims);
//   * dk/dv: one block of 256 threads per (batch, kv head, 64-row key
//     tile), looping over the group's q heads and, for each, over the
//     32-row q tiles from the tile's causal start to its window end; four
//     threads own one key row (a quarter of the columns and of dk/dv's
//     dims).  Each block owns its dk/dv rows outright, so there are no
//     atomics and the gradients are bitwise repeatable run to run.
// Scores are recomputed exactly as the forward computed them (q pre-
// scaled, the same FMA order over hd), so P matches the forward's lse.
#include "flash_attention_fwd.cuh"

namespace {

using flash::kBK;
using flash::kBQ;
using flash::kThreads;
using flash::stage_rows;
using flash::store;

constexpr int kDkvThreads = 256;
constexpr int kBKV = 64;  // key rows per dk/dv block (four threads per row)
constexpr int kBQV = 32;  // q rows per dk/dv step

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal,
                                     int window) {
  bool ok = kpos < S && qpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

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
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int num_heads, int num_kv_heads, int causal, int window,
                float scale) {
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
  stage_rows<T, HD, kBQ, kThreads>(q, sQ, HD + 1, b, q0, S, num_heads, h,
                                   tid, scale);
  stage_rows<T, HD, kBQ, kThreads>(dout, sO, HD + 1, b, q0, S, num_heads, h,
                                   tid, 1.f);
  const int qpos = q0 + row;
  const size_t lrow = ((size_t)b * num_heads + h) * S + qpos;
  const float lse_r = qpos < S ? lse[lrow] : 0.f;
  const float del_r = qpos < S ? delta[lrow] : 0.f;

  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    stage_rows<T, HD, kBK, kThreads>(k, sK, HD + 1, b, k0, S, num_kv_heads,
                                     kvh, tid, 1.f);
    stage_rows<T, HD, kBK, kThreads>(v, sV, HD + 1, b, k0, S, num_kv_heads,
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
          live(qpos, k0 + c, S, causal, window) ? expf(sc[j] - lse_r) : 0.f;
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

  if (qpos < S) {
    T* drow = dq + (((size_t)b * S + qpos) * num_heads + h) * HD;
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
                 T* __restrict__ dv, int S, int num_heads, int num_kv_heads,
                 int causal, int window, float scale) {
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
  stage_rows<T, HD, kBKV, kDkvThreads>(k, sK, HD + 1, b, k0, S,
                                       num_kv_heads, kvh, tid, 1.f);
  stage_rows<T, HD, kBKV, kDkvThreads>(v, sV, HD + 1, b, k0, S,
                                       num_kv_heads, kvh, tid, 1.f);
  const int kpos = k0 + row;

  float ak[kQuarter], av[kQuarter];
#pragma unroll
  for (int j = 0; j < kQuarter; ++j) ak[j] = av[j] = 0.f;

  // q rows that can see this key tile: from its causal start to the
  // window's end past its last key
  const int q_begin = causal ? (k0 / kBQV) * kBQV : 0;
  const int q_end = window > 0 ? min(S, k0 + kBKV - 1 + window) : S;

  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const float* lse_h = lse + ((size_t)b * num_heads + h) * S;
    const float* del_h = delta + ((size_t)b * num_heads + h) * S;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQV) {
      __syncthreads();  // the previous step is done with sQ/sO/sP/sS
      stage_rows<T, HD, kBQV, kDkvThreads>(q, sQ, HD + 1, b, q0, S,
                                           num_heads, h, tid, scale);
      stage_rows<T, HD, kBQV, kDkvThreads>(dout, sO, HD + 1, b, q0, S,
                                           num_heads, h, tid, 1.f);
      if (tid < kBQV) {
        const int qp = q0 + tid;
        sL[tid] = qp < S ? lse_h[qp] : 0.f;
        sD[tid] = qp < S ? del_h[qp] : 0.f;
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
        const float p = live(q0 + c, kpos, S, causal, window)
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

  if (kpos < S) {
    const size_t off = (((size_t)b * S + kpos) * num_kv_heads + kvh) * HD;
#pragma unroll
    for (int j = 0; j < kQuarter; ++j) {
      store(dk + off + 4 * j + part, ak[j]);
      store(dv + off + 4 * j + part, av[j]);
    }
  }
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int batch, int S, int H, int KV, int causal,
                      int window, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  static bool attr_set = false;
  cudaError_t e = raise_smem(flash_dq_kernel<T, HD>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid((S + kBQ - 1) / kBQ, H, batch);
  flash_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, KV, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int batch,
                       int S, int H, int KV, int causal, int window,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  static bool attr_set = false;
  cudaError_t e = raise_smem(flash_dkv_kernel<T, HD>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid((S + kBKV - 1) / kBKV, KV, batch);
  flash_dkv_kernel<T, HD><<<grid, kDkvThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for shapes it does not take).
#define REPRO_DISPATCH(CALL)                                  \
  if (dtype == 0 && head_dim == 64) return (int)CALL(float, 64); \
  if (dtype == 0 && head_dim == 128) return (int)CALL(float, 128); \
  if (dtype == 1 && head_dim == 64)                               \
    return (int)CALL(__nv_bfloat16, 64);                          \
  if (dtype == 1 && head_dim == 128)                              \
    return (int)CALL(__nv_bfloat16, 128);                         \
  return (int)cudaErrorInvalidValue

extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int batch, int seq_len, int num_heads,
                                       int num_kv_heads, int head_dim,
                                       int causal, int window, int dtype,
                                       void* stream) {
  if (flash::bad_shape(batch, seq_len, num_heads, num_kv_heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD(T, HD)                                                 \
  flash::launch_fwd<T, HD, true>(q, k, v, out, static_cast<float*>(lse), \
                                 batch, seq_len, num_heads, num_kv_heads, \
                                 causal, window, s)
  REPRO_DISPATCH(REPRO_FWD);
#undef REPRO_FWD
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int batch, int seq_len,
                                  int num_heads, int num_kv_heads,
                                  int head_dim, int causal, int window,
                                  int dtype, void* stream) {
  if (flash::bad_shape(batch, seq_len, num_heads, num_kv_heads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DQ(T, HD)                                                   \
  launch_dq<T, HD>(q, k, v, dout, static_cast<const float*>(lse),         \
                   static_cast<const float*>(delta), dq, batch, seq_len,  \
                   num_heads, num_kv_heads, causal, window, s)
  REPRO_DISPATCH(REPRO_DQ);
#undef REPRO_DQ
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int batch,
                                   int seq_len, int num_heads,
                                   int num_kv_heads, int head_dim,
                                   int causal, int window, int dtype,
                                   void* stream) {
  if (flash::bad_shape(batch, seq_len, num_heads, num_kv_heads) ||
      num_kv_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DKV(T, HD)                                                  \
  launch_dkv<T, HD>(q, k, v, dout, static_cast<const float*>(lse),        \
                    static_cast<const float*>(delta), dk, dv, batch,      \
                    seq_len, num_heads, num_kv_heads, causal, window, s)
  REPRO_DISPATCH(REPRO_DKV);
#undef REPRO_DKV
}
#undef REPRO_DISPATCH
