// Flash-decode block shared by the paged (decode_attention_paged.cu) and
// dense (decode_attention.cu) decode kernels, for float32 q: float32 K/V
// and int8 K/V (the parity path).  bf16 q never reaches it: over bf16 or
// int8 K/V those instances are the split-KV tensor-core block of
// decode_attention_split_sm90.cuh.  One new query token per sequence
// attends to its cache: an online softmax over the sequence's live ring
// slots under the token-id mask
//   t_s = len-1 - floor_mod(len-1-s, L)      (L = pages_per_seq * page_size)
// that hides slots not yet written and, with a window, evicted tokens.
//
// Addressing.  Paged: slot s of sequence b lives in page
// block_tables[b][s / page_size] at offset s % page_size of a pool
// [num_blocks, page_size, kv_heads, head_dim].  Dense: the cache
// [B, L, kv_heads, head_dim] is the same pool with one page of L rows per
// sequence (page = b), so the dense kernel is this block with an implicit
// identity table; its n_valid plays the role of len (n_valid <= L makes
// every walked slot valid, n_valid > L keeps all L, as the TPU kernel).
//
// int8 KV (KT = int8_t): each row has one bf16 scale per (token, kv head)
// in a [..., kv_heads, 1] array beside it.  Rows are loaded 16 int8 values
// per 16-byte load, the scale once per row, and dequantized in float32 in
// registers (int8 * scale) before the QK dot and the PV sum, as the TPU
// kernels do.
//
// What bounds it on the card: bytes.  Each (slot, kv head) reads its live
// K/V once and does 4*g flops per element read (g = q heads per kv head,
// 7 for Qwen2.5-7B): far below the ~295 flops/byte where Hopper's tensor
// cores become the limit, but at 1-2 bytes an element (int8, bf16) it is
// 14-28 flops per byte at g = 7, which f32 FMAs on shared-memory operands
// can barely sustain at 3.35 TB/s.  This block reads each live byte once:
//   * one block per (sequence, kv head); the block holds all g query rows
//     of its group (any g <= 16, not only powers of two), so every K/V row
//     is loaded from device memory once and reused by the g rows;
//   * the block reads its own length (and block-table row) and walks only
//     the first min(len, L) ring slots: a dead page or a dead tail row is
//     never loaded, so the TPU kernels' clamped "safe tables" and their
//     L % block_k == 0 rule are not needed (any L works);
//   * 16-byte loads, all issued before any is used;
//   * max, denominator and accumulator stay in float32 (registers and
//     shared memory).
// What it leaves on the table, and the split block answers for bf16 q:
// one block per (sequence, kv head) fills only batch*kv_heads of the 132
// SMs, no load is in flight while a tile is computed, and the arithmetic
// is scalar f32.  float32 q keeps it because the split block rounds q
// and P to bf16, which the parity path's 1e-5 bounds do not allow.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace repro_decode {

constexpr int kThreads = 128;
constexpr int kTile = 32;       // ring slots per step: one per lane
constexpr int kMaxGroup = 16;   // q heads per kv head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// one 16-byte load holds kVec<T> consecutive elements
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// int8 rows are dequantized with their row's scale; float rows ignore it
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float scale,
                                       float* out) {
  const T* p = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e) {
    if constexpr (std::is_same<T, int8_t>::value)
      out[e] = to_float(p[e]) * scale;
    else
      out[e] = to_float(p[e]);
  }
}

// T: q/out element (float); KT: K/V element (T, or int8_t with
// bf16 scales).  kPaged: rows through block_tables, else page = b.
template <typename T, typename KT, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const KT* __restrict__ k_rows,
              const KT* __restrict__ v_rows,
              const __nv_bfloat16* __restrict__ k_scale,
              const __nv_bfloat16* __restrict__ v_scale,
              const int* __restrict__ block_tables,
              const int* __restrict__ lengths, T* __restrict__ out,
              int num_heads, int num_kv_heads, int num_blocks, int page_size,
              int pages_per_seq, int window, float scale) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kAcc = kMaxGroup * HD / kThreads;  // outputs per thread
  static_assert(kAcc * kThreads == kMaxGroup * HD, "accumulator split");
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
  const int* bt = kPaged ? block_tables + (size_t)b * pages_per_seq
                         : nullptr;

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
    // 1. gather this step's K/V rows (through the block table when
    //    paged): 16-byte loads, all issued before any is used (slots past
    //    the frontier re-read the last live row and are zeroed, so no load
    //    branches on the length).  The pieces need not divide evenly over
    //    the threads (hd 80 bf16: 32 rows x 10 pieces over 128 threads):
    //    the count rounds up and the last round is guarded.
    static_assert(HD % kVec<KT> == 0, "rows are whole 16-byte pieces");
    constexpr int kRowVecs = HD / kVec<KT>;
    constexpr int kPieces = kTile * kRowVecs;
    constexpr int kLoads = (kPieces + kThreads - 1) / kThreads;
    uint4 kr4[kLoads], vr4[kLoads];
    float ks[kLoads], vs[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kPieces) {
        const int slot = min(s0 + i / kRowVecs, n_valid - 1);
        int page = b;
        if constexpr (kPaged) {
          page = bt[slot / page_size];
          page = min(max(page, 0), num_blocks - 1);
        }
        const size_t row =
            ((size_t)page * page_size + slot % page_size) * num_kv_heads +
            kvh;
        const size_t off = row * HD + (i % kRowVecs) * kVec<KT>;
        kr4[j] = *reinterpret_cast<const uint4*>(k_rows + off);
        vr4[j] = *reinterpret_cast<const uint4*>(v_rows + off);
        if constexpr (kQuant) {
          ks[j] = __bfloat162float(k_scale[row]);
          vs[j] = __bfloat162float(v_scale[row]);
        } else {
          ks[j] = vs[j] = 1.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kPieces) {
        const int t = i / kRowVecs, d0 = (i % kRowVecs) * kVec<KT>;
        const bool live = s0 + t < n_valid;
        float kf[kVec<KT>], vf[kVec<KT>];
        unpack<KT>(kr4[j], ks[j], kf);
        unpack<KT>(vr4[j], vs[j], vf);
#pragma unroll
        for (int e = 0; e < kVec<KT>; ++e) {
          sK[t * (HD + 1) + d0 + e] = live ? kf[e] : 0.f;
          sV[t * HD + d0 + e] = live ? vf[e] : 0.f;
        }
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

template <typename T, typename KT, int HD, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
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
  decode_kernel<T, KT, HD, kPaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), num_heads, num_kv_heads, num_blocks, page_size,
      pages_per_seq, window, scale);
  return cudaGetLastError();
}

// dtype (of q and out): 0 = float32 only (bf16 q is the split block's);
// head_dim 64, 80 or 128.  K/V are float32, or int8 when kQuant.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
template <bool kPaged, bool kQuant>
int dispatch(const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale,
             const void* block_tables, const void* lengths, void* out,
             int batch, int num_heads, int num_kv_heads, int head_dim,
             int num_blocks, int page_size, int pages_per_seq, int window,
             int dtype, void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxGroup || num_blocks <= 0 ||
      page_size <= 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T, HD)                                                   \
  return (int)launch<T, typename std::conditional<kQuant, int8_t, T>::type, \
                     HD, kPaged>(q, k, v, k_scale, v_scale, block_tables,     \
                                 lengths, out, batch, num_heads,              \
                                 num_kv_heads, num_blocks, page_size,         \
                                 pages_per_seq, window, s)
  if (dtype == 0 && head_dim == 64) REPRO_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 80) REPRO_LAUNCH(float, 80);
  if (dtype == 0 && head_dim == 128) REPRO_LAUNCH(float, 128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_decode
