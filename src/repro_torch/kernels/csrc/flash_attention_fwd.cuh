// Causal flash attention (prefill) for Hopper (sm_90a), with an optional
// sliding window and grouped-query heads: the block shared by the
// forward-only kernel (flash_attention.cu) and the forward that also
// writes the per-row log-sum-exp for the backward (flash_attention_bwd.cu).
//
// q [B,S,H,hd], k/v [B,S,KV,hd] -> out [B,S,H,hd] (and lse [B,H,S] f32),
// q head h reading kv head h / (H/KV) in place (heads are never repeated
// in memory), online softmax over key tiles, key tiles wholly outside
// the causal/window band skipped.
//
// What bounds it on the card: operations.  Prefill attention does
// O(S) flops per byte, far above Hopper's ~295 flops/byte balance point
// at the prompt lengths the engine runs, so the limit is arithmetic.
// This first version is simple and exact rather than fast:
//   * one block of 128 threads per (batch, q head, 64-row q tile); the
//     TPU kernel's sequential k grid axis becomes a loop inside the block
//     over 32-row K/V tiles staged in shared memory, stopping at the
//     causal limit and starting at the window's first live tile;
//   * each thread pair owns one q row: the pair splits the tile's score
//     columns and the row's head_dim outputs, and combines max and sum
//     with one warp shuffle; max, denominator and accumulator are f32;
//   * scalar FMAs from shared memory (padded rows, no bank conflicts).
// Later work: mma.sync / wgmma tensor-core tiles fed by TMA, which is
// where the arithmetic bound can actually be approached.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace flash {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // q rows per block (two threads per row)
constexpr int kBK = 32;  // key rows per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte load holds kVec<T> consecutive elements
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* out) {
  const T* p = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) out[e] = to_float(p[e]);
}

// Stage rows [r0, r0 + kRows) of head `head` of a [B,S,heads,HD] tensor
// into shared memory as f32 rows of stride `stride`, each element times
// `mul`, by kNThreads threads with 16-byte loads
// all issued before any is used; rows past the end re-read the last row
// and are zeroed, so no load branches.
template <typename T, int HD, int kRows, int kNThreads>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int stride, int b,
                                           int r0, int S, int heads,
                                           int head, int tid, float mul) {
  constexpr int kRowVecs = HD / kVec<T>;
  constexpr int kLoads = kRows * kRowVecs / kNThreads;
  static_assert(kLoads * kNThreads == kRows * kRowVecs, "tile split");
  uint4 r4[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kNThreads;
    const int s = min(r0 + i / kRowVecs, S - 1);
    r4[j] = *reinterpret_cast<const uint4*>(
        src + (((size_t)b * S + s) * heads + head) * HD +
        (i % kRowVecs) * kVec<T>);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kNThreads;
    const int t = i / kRowVecs, d0 = (i % kRowVecs) * kVec<T>;
    const bool live = r0 + t < S;
    float f[kVec<T>];
    unpack<T>(r4[j], f);
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e)
      dst[t * stride + d0 + e] = live ? f[e] * mul : 0.f;
  }
}

template <int HD>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

// kLse: also write lse[b, h, row] = m + log(l) in f32 (the backward's
// residual); false compiles to the forward-only kernel.
template <typename T, int HD, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq_len, int num_heads,
                 int num_kv_heads, int causal, int window, float scale) {
  constexpr int kHalf = HD / 2;     // outputs per thread
  constexpr int kCols = kBK / 2;    // score columns per thread
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;
  const int S = seq_len;

  extern __shared__ float smem[];
  float* sQ = smem;                      // [kBQ][HD + 1], pre-scaled
  float* sK = sQ + kBQ * (HD + 1);       // [kBK][HD + 1]
  float* sV = sK + kBK * (HD + 1);       // [kBK][HD]
  float* sP = sV + kBK * HD;             // [kBQ][kBK + 1] probabilities

  const int q0 = qt * kBQ;
  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    sQ[r * (HD + 1) + d] =
        s < S ? to_float(q[(((size_t)b * S + s) * num_heads + h) * HD + d]) *
                    scale
              : 0.f;
  }

  const int qpos = q0 + row;
  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q0 - window + 1) / kBK) * kBK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // 16-byte loads, all issued before any is used (rows past the end
    // re-read the last row and are zeroed, so no load branches)
    constexpr int kRowVecs = HD / kVec<T>;
    constexpr int kLoads = kBK * kRowVecs / kThreads;
    uint4 kr4[kLoads], vr4[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int s = min(k0 + i / kRowVecs, S - 1);
      const size_t off = (((size_t)b * S + s) * num_kv_heads + kvh) * HD +
                         (i % kRowVecs) * kVec<T>;
      kr4[j] = *reinterpret_cast<const uint4*>(k + off);
      vr4[j] = *reinterpret_cast<const uint4*>(v + off);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kRowVecs, d0 = (i % kRowVecs) * kVec<T>;
      const bool live = k0 + t < S;
      float kf[kVec<T>], vf[kVec<T>];
      unpack<T>(kr4[j], kf);
      unpack<T>(vr4[j], vf);
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) {
        sK[t * (HD + 1) + d0 + e] = live ? kf[e] : 0.f;
        sV[t * HD + d0 + e] = live ? vf[e] : 0.f;
      }
    }
    __syncthreads();

    // scores for this thread's interleaved columns c = 2j + half; the
    // d loop is outermost so each q element is read from shared memory
    // once per tile, not once per column
    float sc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) sc[j] = 0.f;
    const float* qr = sQ + row * (HD + 1);
    const float* kr = sK + half * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sc[j] = fmaf(qd, kr[2 * j * (HD + 1) + d], sc[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + 2 * j + half;
      bool ok = kpos < S && qpos < S;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      if (!ok) sc[j] = -INFINITY;
      mx = fmaxf(mx, sc[j]);
    }
    // the row's partner thread is the neighbouring lane
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = (sc[j] == -INFINITY) ? 0.f : expf(sc[j] - m_new);
      sP[row * (kBK + 1) + 2 * j + half] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // the partner's probabilities are visible

    // accumulate P·V for this thread's interleaved dims d = 2j + half
    // (column loop outermost: each probability is read once)
    const float* pr = sP + row * (kBK + 1);
#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = pr[c];
      const float* vr = sV + c * HD + half;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) acc[j] = fmaf(p, vr[2 * j], acc[j]);
    }
    __syncthreads();  // before the next tile overwrites sK/sV/sP
  }

  if (qpos < S) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* orow = out + (((size_t)b * S + qpos) * num_heads + h) * HD;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) store(orow + 2 * j + half, acc[j] * inv);
    if (kLse && half == 0)
      lse[((size_t)b * num_heads + h) * S + qpos] = m + logf(lc);
  }
}

template <typename T, int HD, bool kLse>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int batch, int seq_len,
                       int num_heads, int num_kv_heads, int causal,
                       int window, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    // above 48 KB only after raising the kernel's dynamic-smem limit
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid((seq_len + kBQ - 1) / kBQ, num_heads, batch);
  flash_fwd_kernel<T, HD, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq_len,
      num_heads, num_kv_heads, causal, window, scale);
  return cudaGetLastError();
}

// Shapes every flash kernel refuses (grid limits, GQA divisibility).
inline bool bad_shape(int batch, int seq_len, int num_heads,
                      int num_kv_heads) {
  return batch <= 0 || seq_len <= 0 || num_kv_heads <= 0 ||
         num_heads % num_kv_heads != 0 || batch > 65535 ||
         num_heads > 65535;
}

}  // namespace flash
