// Split-KV flash-decode for Hopper (sm_90a) in bf16 on the tensor cores:
// the block behind the bf16 instances of the dense (decode_attention.cu,
// K6) and paged (decode_attention_paged.cu, K1) decode kernels.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention.py :: decode_attention
//   src/repro/kernels/decode_attention_paged.py :: decode_attention_paged
// for bf16 q and bf16 K/V, and computes exactly what the scalar block of
// decode_attention_common.cuh computes: one new query token per sequence
// attends to its live ring slots [0, min(len, L)) under the token-id
// mask t_s = len-1 - floor_mod(len-1-s, L) and an optional window; dense
// is the same walk with page = b and L = cache_len (n_valid > L keeps
// all L).  Float32 q/KV (the parity path) and int8 K/V (K3, K7) keep the
// scalar block.
//
// What bounds it on the card: bytes.  Every live K/V element (2 bytes)
// is read once and used by the g q heads of its group in 4g flops: 14
// flops per byte at Qwen2.5-7B's g = 7, far below the ~295 where
// Hopper's bf16 tensor cores would become the limit.  The scalar block
// stayed far from that bound for three reasons, and the design answers
// each:
//   * too few blocks: it ran one block per (kv head, sequence), 16 at
//     the serve shape on 132 SMs.  Here pass 1 runs one block per
//     (split, kv head, sequence): each block walks one contiguous range
//     of split_len ring slots (a multiple of the page size and of the
//     64-slot key tile; the host picks the split count from static
//     shapes only, never from the lengths) and writes f32 partials m, l
//     and acc[hd] for its g rows.  A range wholly past min(len, L)
//     writes m = -inf, l = 0 and exits.  Pass 2 (decode_combine_kernel)
//     merges the splits in a fixed order for each (sequence, q head):
//     out = sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i, skipping
//     m_i = -inf.  With one split pass 1 writes out itself: one launch.
//     No atomics: the result is bitwise repeatable;
//   * no loads in flight while it computes: here K/V tiles of 64 slots
//     cycle through a three-stage ring in shared memory, filled by
//     16-byte cp.async copies that stay in flight while earlier tiles are
//     computed (two tiles ahead, up to 64 KB a block at hd 128).  Paged
//     rows go through the block table one slot at a time; rows past the
//     range are zero-filled by the copy itself and never read.  K and V
//     stay bf16 in shared memory, in rows padded by 16 bytes so the eight
//     rows one ldmatrix reads fall in distinct banks;
//   * scalar f32 arithmetic on shared-memory operands (4g flops per
//     element read: at g = 7 and 3.35 TB/s ~47 TFLOP/s of f32 FMA, 70%
//     of the f32 peak, above it at g = 12): here S = Q·Kᵀ and O += P·V
//     run on mma.sync m16n8k16 (bf16 in, f32 accumulate).  The group's
//     g <= 16 q rows are one m16 tile (rows past g are zero and never
//     stored); Q stays in registers as the A operand for the whole walk;
//     K tiles load with ldmatrix, V tiles with ldmatrix.trans.  Each of
//     the four warps takes 16 slots of the tile and keeps its own online
//     softmax (f32 max and sum in the log2 domain, the hd^-0.5 scale
//     applied to S in f32, P rounded to bf16 as the P·V operand, as the
//     flash forward does); the warps merge through shared memory at the
//     end.  hd 64, 80 and 128 are all multiples of 16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace repro_decode_split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16 * kWarps;   // key tile: 16 ring slots per warp
constexpr int kStages = 3;           // K/V ring depth
constexpr int kPad = 8;              // bf16 of padding per shared row
constexpr int kMaxGroup = 16;        // q heads per kv head: one m16 tile

template <int HD>
constexpr size_t smem_bytes() {
  constexpr size_t ring = (size_t)kStages * 2 * kKeys * (HD + kPad) * 2;
  constexpr size_t merge = sizeof(float) * kWarps * kMaxGroup * (HD + 2);
  return ring > merge ? ring : merge;
}

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; live == false zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a·b on one m16n8k16 tile, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 of a q row as one A-operand register (no
// alignment asked of q)
__device__ __forceinline__ uint32_t q_pair(const unsigned short* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
}

// ---------------------------------------------------------------- pass 1
// grid (splits, kv heads, batch), kThreads threads.  kPaged: rows through
// block_tables, else page = b with page_size = L (pages_per_seq = 1).
// Partials: part_acc [B, H, splits, HD], part_m / part_l [B, H, splits],
// m in the log2 domain of the scaled scores; unused with one split.
template <int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_rows,
                    const __nv_bfloat16* __restrict__ v_rows,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int num_heads,
                    int num_kv_heads, int num_blocks, int page_size,
                    int pages_per_seq, int window, int split_len,
                    float scale_log2) {
  constexpr int kPitch = HD + kPad;     // shared row pitch, bf16
  constexpr int kChunks = HD / 8;       // 16-byte pieces per row
  constexpr int kKSteps = HD / 16;      // k16 steps of Q·Kᵀ
  constexpr int kNTiles = HD / 8;       // n8 tiles of O
  static_assert(HD % 16 == 0, "head_dim is a multiple of 16");
  static_assert(kKeys * kChunks % kThreads == 0, "whole copy rounds");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int num_splits = gridDim.x;
  const int g = num_heads / num_kv_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int L = pages_per_seq * page_size;
  const int n_valid = min(len, L);
  const int lo = split * split_len;
  const int hi = min(lo + split_len, n_valid);
  const size_t row0 = (size_t)b * num_heads + (size_t)kvh * g;

  if (lo >= hi) {   // nothing live in this range
    for (int i = tid; i < g * HD; i += kThreads) {
      const size_t r = row0 + i / HD;
      if (num_splits == 1) {
        out[r * HD + i % HD] = __float2bfloat16(0.f);
      } else if (i % HD == 0) {
        part_m[r * num_splits + split] = -INFINITY;
        part_l[r * num_splits + split] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kStages * kKeys * kPitch;
  const int* bt = kPaged ? block_tables + (size_t)b * pages_per_seq
                         : nullptr;

  // tile t (slots lo + t*kKeys ...) into ring stage st: every thread
  // issues kKeys*kChunks/kThreads copies each of K and V
  auto load_tile = [&](int t, int st) {
    const int s0 = lo + t * kKeys;
#pragma unroll
    for (int j = 0; j < kKeys * kChunks / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const int slot = s0 + r;
      const bool live = slot < hi;
      size_t row = kvh;   // a valid address for the zero-filled copies
      if (live) {
        if constexpr (kPaged) {
          int page = __ldg(bt + slot / page_size);
          page = min(max(page, 0), num_blocks - 1);
          row = ((size_t)page * page_size + slot % page_size) *
                    num_kv_heads + kvh;
        } else {
          row = ((size_t)b * L + slot) * num_kv_heads + kvh;
        }
      }
      const size_t off = row * HD + c * 8;
      const int so = (st * kKeys + r) * kPitch + c * 8;
      cp_async16(smem_u32(sK + so), k_rows + off, live);
      cp_async16(smem_u32(sV + so), v_rows + off, live);
    }
  };

  const int n_tiles = (hi - lo + kKeys - 1) / kKeys;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // Q as the A operand, rows = the group's q heads (zero past g): thread
  // holds rows qr and qr + 8, columns qc, qc + 1 (+ 8) of each k16 step
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const unsigned short* qs =
      reinterpret_cast<const unsigned short*>(q) + row0 * HD;
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qr + (e % 2) * 8, d = kk * 16 + (e / 2) * 8 + qc;
      qa[kk][e] = r < g ? q_pair(qs + (size_t)r * HD + d) : 0u;
    }
  }

  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows qr, qr + 8
  float l_run[2] = {0.f, 0.f};               // this thread's share

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; stage (t-1) % kStages is free
    if (t + kStages - 1 < n_tiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const int st = t % kStages;
    const __nv_bfloat16* tK = sK + (st * kKeys + warp * 16) * kPitch;
    const __nv_bfloat16* tV = sV + (st * kKeys + warp * 16) * kPitch;

    // S = Q·Kᵀ over this warp's 16 slots: two n8 tiles.  ldmatrix x4:
    // lanes 0-15 address slots 0-7, 16-31 slots 8-15; odd eighths take
    // the upper 8 columns of the k16 step
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t kb[4];
      const int key = (lane / 16) * 8 + lane % 8;
      const int col = kk * 16 + ((lane / 8) % 2) * 8;
      ldsm_x4(smem_u32(tK + key * kPitch + col), kb);
      mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }

    // the token-id ring mask (floor mod: the divisor's sign, as jnp.mod;
    // C++ % truncates toward zero) and the window, per slot of the
    // thread's fragment: slot of s[nt][e] = 8 nt + qc + e % 2
    const int sw = lo + t * kKeys + warp * 16;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int slot = sw + nt * 8 + qc + e2;
        bool valid = slot < hi;
        if (valid) {
          const int a = len - 1 - slot;
          const int ts = len - 1 - (((a % L) + L) % L);
          valid = ts >= 0;
          if (window > 0) valid = valid && ts > len - 1 - window;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[nt][h * 2 + e2];
          x = valid ? x * scale_log2 : -INFINITY;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      // m_new stays -inf only while no valid slot has been seen
      alpha[h] = m_new == -INFINITY ? 1.f : exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[nt][e];
        x = x == -INFINITY ? 0.f : exp2f(x - m_run[e / 2]);
        psum[e / 2] += x;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + psum[h];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P·V: the S fragments, rounded to bf16, are the A operand
    // (k = the 16 slots); ldmatrix.trans x4 gives two n8 tiles of V:
    // lanes 0-7 / 16-23 address slots 0-7, 8-15 / 24-31 slots 8-15, the
    // upper half of the lanes the next 8 columns
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < kNTiles / 2; ++j) {
      uint32_t vb[4];
      const int key = ((lane / 8) % 2) * 8 + lane % 8;
      const int col = j * 16 + (lane / 16) * 8;
      ldsm_x4_trans(smem_u32(tV + key * kPitch + col), vb);
      mma_bf16(o[2 * j], pa, vb[0], vb[1]);
      mma_bf16(o[2 * j + 1], pa, vb[2], vb[3]);
    }
  }

  // merge the four warps through shared memory (the ring is done)
  cp_async_wait<0>();
  __syncthreads();
  float* mM = reinterpret_cast<float*>(smem_raw);   // [kWarps][16]
  float* mL = mM + kWarps * kMaxGroup;              // [kWarps][16]
  float* mO = mL + kWarps * kMaxGroup;              // [kWarps][16][HD]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if (lane % 4 == 0) {
      mM[warp * kMaxGroup + qr + 8 * h] = m_run[h];
      mL[warp * kMaxGroup + qr + 8 * h] = l_run[h];
    }
  }
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = mO + (size_t)(warp * kMaxGroup + qr + 8 * h) * HD + n * 8 +
                 qc;
      p[0] = o[n][2 * h];
      p[1] = o[n][2 * h + 1];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mM[w * kMaxGroup + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mM[w * kMaxGroup + r];
      if (mw != -INFINITY) {
        const float a = exp2f(mw - M);
        num += a * mO[(size_t)(w * kMaxGroup + r) * HD + d];
        den += a * mL[w * kMaxGroup + r];
      }
    }
    const size_t hr = row0 + r;
    if (num_splits == 1) {
      out[hr * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      part_acc[(hr * num_splits + split) * HD + d] = num;
      if (d == 0) {
        part_m[hr * num_splits + split] = M;
        part_l[hr * num_splits + split] = den;
      }
    }
  }
}

// ---------------------------------------------------------------- pass 2
// one block of HD threads per (sequence, q head): the splits in order
template <int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      __nv_bfloat16* __restrict__ out, int num_splits) {
  const size_t hr = blockIdx.x;   // b * H + h
  const int d = threadIdx.x;
  const float* pm = part_m + hr * num_splits;
  const float* pl = part_l + hr * num_splits;
  const float* pa = part_acc + hr * num_splits * HD + d;
  float M = -INFINITY;
  for (int i = 0; i < num_splits; ++i) M = fmaxf(M, pm[i]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < num_splits; ++i) {
    const float mi = pm[i];
    if (mi != -INFINITY) {
      const float a = exp2f(mi - M);
      num += a * pa[(size_t)i * HD];
      den += a * pl[i];
    }
  }
  out[hr * HD + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <int HD, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* block_tables, const void* lengths, void* out,
                   void* part_acc, void* part_m, void* part_l, int batch,
                   int num_heads, int num_kv_heads, int num_blocks,
                   int page_size, int pages_per_seq, int window,
                   int num_splits, int split_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<HD, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const float scale_log2 =
      (float)(1.0 / sqrt((double)HD) * 1.4426950408889634);
  dim3 grid(num_splits, num_kv_heads, batch);
  decode_split_kernel<HD, kPaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_m), static_cast<float*>(part_l), num_heads,
      num_kv_heads, num_blocks, page_size, pages_per_seq, window, split_len,
      scale_log2);
  if (num_splits == 1) return cudaGetLastError();
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<HD><<<batch * num_heads, HD, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(out),
      num_splits);
  return cudaGetLastError();
}

// bf16 q, K/V and out; head_dim 64, 80 or 128.  The splits must cover
// the ring: (num_splits - 1) * split_len < L <= num_splits * split_len,
// and the partials be given when num_splits > 1.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for shapes
// the kernel does not take).
template <bool kPaged>
int dispatch(const void* q, const void* k, const void* v,
             const void* block_tables, const void* lengths, void* out,
             void* part_acc, void* part_m, void* part_l, int batch,
             int num_heads, int num_kv_heads, int head_dim, int num_blocks,
             int page_size, int pages_per_seq, int window, int num_splits,
             int split_len, void* stream) {
  const long long L = (long long)pages_per_seq * page_size;
  if (batch <= 0 || batch > 65535 || num_kv_heads <= 0 ||
      num_kv_heads > 65535 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxGroup || num_blocks <= 0 ||
      page_size <= 0 || pages_per_seq <= 0 || L > 0x7fffffffLL ||
      num_splits <= 0 || split_len <= 0 ||
      (long long)(num_splits - 1) * split_len >= L ||
      (long long)num_splits * split_len < L ||
      (num_splits > 1 && (!part_acc || !part_m || !part_l)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HD)                                                      \
  return (int)launch<HD, kPaged>(q, k, v, block_tables, lengths, out,        \
                                 part_acc, part_m, part_l, batch, num_heads, \
                                 num_kv_heads, num_blocks, page_size,        \
                                 pages_per_seq, window, num_splits,          \
                                 split_len, s)
  if (head_dim == 64) REPRO_LAUNCH(64);
  if (head_dim == 80) REPRO_LAUNCH(80);
  if (head_dim == 128) REPRO_LAUNCH(128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_decode_split
