// Paged flash-decode for Hopper (sm_90a): one new query token per
// sequence attends to its KV cache through a block table.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention_paged.py :: decode_attention_paged
// and computes the same function: GQA decode over a shared page pool
// [num_blocks, page_size, kv_heads, head_dim], an online softmax over the
// sequence's live ring slots, and the token-id ring mask
//   t_s = len-1 - floor_mod(len-1-s, L)      (L = pages_per_seq * page_size)
// that hides slots not yet written and, with a window, evicted tokens.
//
// What bounds it on the card: bytes.  Each (slot, kv head) reads its live
// K/V once and does 4*g flops per element read (g = q heads per kv head,
// 7 for Qwen2.5-7B), far below the ~295 flops/byte where Hopper's tensor
// cores would become the limit.  The design therefore spends nothing on
// tensor cores and aims at reading each live byte once:
//   * one block per (sequence, kv head); the block holds all g query rows
//     of its group (any g <= 16, not only powers of two), so every K/V row
//     is loaded from device memory once and reused by the g rows;
//   * the block reads its own block-table row and length, and walks only
//     the first min(len, L) ring slots: a dead page is never loaded, so
//     the TPU kernel's clamped "safe tables" are not needed;
//   * max, denominator and accumulator stay in float32 (registers and
//     shared memory); bf16 and float32 pages are accepted.
// Later work: the page walk is sequential inside one block, so a small
// batch fills only batch*kv_heads of the 132 SMs.  Splitting the walk
// across blocks with a second reduction pass (flash-decoding) and 16-byte
// vector loads are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;       // ring slots per step: one per lane
constexpr int kMaxGroup = 16;   // q heads per kv head

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int num_heads, int num_kv_heads, int num_blocks,
                    int page_size, int pages_per_seq, int window,
                    float scale) {
  constexpr int kAcc = kMaxGroup * HD / kThreads;  // outputs per thread
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = num_heads / num_kv_heads;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* sQ = smem;                      // [g][HD], pre-scaled
  float* sK = sQ + g * HD;               // [kTile][HD + 1] (padded rows)
  float* sV = sK + kTile * (HD + 1);     // [kTile][HD]
  float* sS = sV + kTile * HD;           // [g][kTile] scores, then probs
  float* sM = sS + g * kTile;            // [g] running max
  float* sL = sM + g;                    // [g] running denominator
  float* sA = sL + g;                    // [g] this step's rescale

  const int len = lengths[b];
  const int L = pages_per_seq * page_size;
  const int n_valid = min(len, L);
  const int* bt = block_tables + (size_t)b * pages_per_seq;

  const size_t row0 = (size_t)b * num_heads + (size_t)kvh * g;
  const T* qg = q + row0 * HD;
  for (int i = tid; i < g * HD; i += kThreads) sQ[i] = to_float(qg[i]) * scale;
  for (int r = tid; r < g; r += kThreads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < n_valid; s0 += kTile) {
    // 1. gather this step's K/V rows through the block table: 16-byte
    //    loads, all issued before any is used (slots past the frontier
    //    re-read the last live row and are zeroed, so no load branches)
    constexpr int kRowVecs = HD / kVec<T>;
    constexpr int kLoads = kTile * kRowVecs / kThreads;
    uint4 kr4[kLoads], vr4[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int slot = min(s0 + i / kRowVecs, n_valid - 1);
      int page = bt[slot / page_size];
      page = min(max(page, 0), num_blocks - 1);
      const size_t off =
          (((size_t)page * page_size + slot % page_size) * num_kv_heads +
           kvh) * HD + (i % kRowVecs) * kVec<T>;
      kr4[j] = *reinterpret_cast<const uint4*>(k_pages + off);
      vr4[j] = *reinterpret_cast<const uint4*>(v_pages + off);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kRowVecs, d0 = (i % kRowVecs) * kVec<T>;
      const bool live = s0 + t < n_valid;
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

    // 2. scores under the token-id ring mask (floor mod: the divisor's
    //    sign, as jnp.mod; C++ % truncates toward zero)
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int r = i / kTile, t = i % kTile;
      const int slot = s0 + t;
      float sc = -INFINITY;
      if (slot < n_valid) {
        const int a = len - 1 - slot;
        const int ts = len - 1 - (((a % L) + L) % L);
        bool valid = ts >= 0;
        if (window > 0) valid = valid && ts > len - 1 - window;
        if (valid) {
          const float* qr = sQ + r * HD;
          const float* kr = sK + t * (HD + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          sc = dot;
        }
      }
      sS[i] = sc;
    }
    __syncthreads();

    // 3. online softmax: one warp per query row, one lane per slot
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < g; r += kThreads / 32) {
      const float sc = sS[r * kTile + lane];
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[r];
      mx = fmaxf(mx, m_old);
      // mx stays -inf only while no valid key has been seen
      const float alpha = (mx == -INFINITY) ? 1.f : expf(m_old - mx);
      const float p = (sc == -INFINITY) ? 0.f : expf(sc - mx);
      sS[r * kTile + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = mx;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // 4. rescale the accumulator and add P·V
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < g * HD) {
        const int r = i / HD, d = i % HD;
        const float* pr = sS + r * kTile;
        float a = acc[j] * sA[r];
        for (int t = 0; t < kTile; ++t) a = fmaf(pr[t], sV[t * HD + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  T* og = out + row0 * HD;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < g * HD) store(og + i, acc[j] / fmaxf(sL[i / HD], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* lengths, void* out,
                   int batch, int num_heads, int num_kv_heads, int num_blocks,
                   int page_size, int pages_per_seq, int window,
                   cudaStream_t stream) {
  const int g = num_heads / num_kv_heads;
  const size_t smem =
      sizeof(float) * ((size_t)g * HD + (size_t)kTile * (HD + 1) +
                       (size_t)kTile * HD + (size_t)g * kTile + 3 * g);
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid(num_kv_heads, batch);
  decode_paged_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), num_heads,
      num_kv_heads, num_blocks, page_size, pages_per_seq, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int decode_attention_paged(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int batch,
    int num_heads, int num_kv_heads, int head_dim, int num_blocks,
    int page_size, int pages_per_seq, int window, int dtype, void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxGroup || num_blocks <= 0 ||
      page_size <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T, HD)                                                 \
  return (int)launch<T, HD>(q, k_pages, v_pages, block_tables, lengths, out, \
                            batch, num_heads, num_kv_heads, num_blocks,      \
                            page_size, pages_per_seq, window, s)
  if (dtype == 0 && head_dim == 64) REPRO_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) REPRO_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) REPRO_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) REPRO_LAUNCH(__nv_bfloat16, 128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
