// The 3xTF32 tensor-core helpers and the C·Bᵀ-per-chunk kernel shared by
// the SSD scan (csrc/ssd_scan.cu, K4) and its backward
// (csrc/ssd_scan_bwd.cu, K4b): operand staging by cp.async, the TF32 split,
// mma.sync.m16n8k8 and ssd_cb_kernel.  Each source includes it into its
// own library.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // the C·Bᵀ kernel's four warps
constexpr int kQ = 32;          // rows per chunk: two m16 tiles
constexpr int kHD = 64;         // widest head (ssd_scan.py MAX_HEAD_DIM)
constexpr int kDS = 128;        // widest state (ssd_scan.py MAX_D_STATE)
constexpr int kCBP = kQ + 8;    // f32 pitch of the C·Bᵀ tile
// Shared row pitches are the width + 8 elements: 8 words mod 32 in f32
// (4 in bf16), so the fragment loads of a warp fall in distinct banks.

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared: the first src_bytes are read,
// the rest zero-filled (src_bytes 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = hi + lo as CUTLASS's 3xTF32 (NumericConverterFastF32) splits it:
// hi = a truncated to TF32, lo = a − hi (exact) rounded to nearest, ties
// away, by adding half a TF32 ulp: the tensor core reads the top 19 bits
// of a .tf32 operand and drops the other 13.  Three integer and float
// operations, where two cvt.rna.tf32.f32 are about ten on sm_90.  A NaN
// stays a NaN in lo, so it reaches the sums.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// d += a·b on one m16n8k8 tile, TF32 operands, f32 accumulator.
// Fragments (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g+8, q),
// a2 (g, q+4), a3 (g+8, q+4); b0 (k q, n g), b1 (k q+4, n g);
// d0 (g, 2q), d1 (g, 2q+1), d2 (g+8, 2q), d3 (g+8, 2q+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment split once, used for several B fragments
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ AFrag(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// a B fragment split once
struct BFrag {
  uint32_t hi[2], lo[2];
  BFrag() = default;
  __device__ __forceinline__ BFrag(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// 3xTF32: d += a·b to ~f32 accuracy, the two small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a,
                                     const BFrag& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// kQ rows of kWidth elements (a multiple of 16 bytes) into shared rows
// of pitch kPitch; source row r at src + r * stride, its first `cols`
// elements live and only rows < nrows; the rest zero.  vec: 16-byte
// cp.async (src, stride and the row starts 16-byte aligned), else plain
// loads and stores.
template <typename T, int kWidth, int kPitch, int kThr>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           size_t stride, int nrows, int cols,
                                           bool vec, int tid) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kPieces = kWidth / kE, kAll = kQ * kPieces;
  static_assert(kWidth % kE == 0, "whole 16-byte pieces");
  if (vec && nrows == kQ && cols == kWidth) {   // whole rows: no masks
#pragma unroll
    for (int k = 0; k < (kAll + kThr - 1) / kThr; ++k) {
      const int i = tid + k * kThr;
      if (kAll % kThr != 0 && i >= kAll) break;
      const int r = i / kPieces, c = (i % kPieces) * kE;
      cp_async16(dst + r * kPitch + c, src + r * stride + c, 16);
    }
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < (kAll + kThr - 1) / kThr; ++k) {
      const int i = tid + k * kThr;
      if (kAll % kThr != 0 && i >= kAll) break;
      const int r = i / kPieces, c = (i % kPieces) * kE;
      const int n = r < nrows ? max(0, min(kE, cols - c)) : 0;
      cp_async16(dst + r * kPitch + c, n > 0 ? src + r * stride + c : src,
                 n * (int)sizeof(T));
    }
  } else {
    for (int i = tid; i < kQ * kWidth; i += kThr) {
      const int r = i / kWidth, c = i % kWidth;
      dst[r * kPitch + c] =
          (r < nrows && c < cols) ? src[r * stride + c] : zero<T>();
    }
  }
}

// ------------------------------------------------------ C·Bᵀ per chunk
// grid (nc, b), kThreads threads: cb[b][c][i][j] = C_i · B_j over the
// chunk's 32 rows (rows past s are zero), 3xTF32.  Warp w computes rows
// 16(w/2).. and columns 16(w%2)..; the tile above the diagonal (rows
// 0-15, columns 16-31) is skipped: the scan never reads it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int S, int DS, int vec) {
  __shared__ __align__(16) float sC[kQ][kDS + 8];
  __shared__ __align__(16) float sB[kQ][kDS + 8];
  // the scan grid may launch now: it waits for this grid's results
  // (griddepcontrol.wait) only where it first reads them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = c * kQ, nrows = min(kQ, S - r0);
  const int width = (DS + 7) & ~7;
  const size_t row = (size_t)b * S + r0;
  if (vec && sizeof(T) == sizeof(float)) {   // f32 rows straight in
    stage_rows<float, kDS, kDS + 8, kThreads>(
        &sC[0][0], reinterpret_cast<const float*>(Cm) + row * DS, DS, nrows,
        DS, true, tid);
    stage_rows<float, kDS, kDS + 8, kThreads>(
        &sB[0][0], reinterpret_cast<const float*>(Bm) + row * DS, DS, nrows,
        DS, true, tid);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int e = tid; e < kQ * width; e += kThreads) {
      const int r = e / width, n = e % width;
      const bool live = r < nrows && n < DS;
      const size_t off = (row + r) * DS + n;
      sC[r][n] = live ? to_float(Cm[off]) : 0.f;
      sB[r][n] = live ? to_float(Bm[off]) : 0.f;
    }
  }
  __syncthreads();
  const int m = warp >> 1, nb = 2 * (warp & 1);
  if (m == 0 && nb == 2) return;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < width; k0 += 8) {
    // k permuted (k q -> column k0 + 2q, k q+4 -> k0 + 2q + 1) on both
    // operands, so each takes one two-element load
    const float2 c0 = load2(&sC[16 * m + g][k0 + 2 * q]);
    const float2 c1 = load2(&sC[16 * m + g + 8][k0 + 2 * q]);
    const AFrag a(c0.x, c1.x, c0.y, c1.y);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const float2 bv = load2(&sB[8 * (nb + nn) + g][k0 + 2 * q]);
      mma3(acc[nn], a, BFrag(bv.x, bv.y));
    }
  }
  float* out = cb + ((size_t)b * nc + c) * kQ * kQ;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(16 * m + g + 8 * (e >> 1)) * kQ + 8 * (nb + nn) + 2 * q +
          (e & 1)] = acc[nn][e];
}

}  // namespace
