// Causal flash attention forward for Hopper (sm_90a) in bf16 on the
// tensor cores: the block behind the bf16 instances of the forward-only
// kernel (flash_attention.cu, K2) and of the training forward that also
// writes the per-row log-sum-exp (flash_attention_bwd.cu, K5a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention.py :: flash_attention
//   src/repro/kernels/flash_attention_bwd.py :: _fwd (_fwd_kernel)
// and computes their function: q [B,S,H,hd], k/v [B,S,KV,hd] (KV divides
// H; q head h reads kv head h / (H/KV) in place, never repeated in
// memory) -> out [B,S,H,hd] and, with kLse, lse [B,H,S] in f32; causal,
// an optional sliding window, any S >= 1 (ragged last tiles masked),
// key tiles wholly outside the band never loaded.  A sequence-parallel
// rank passes its Sq query rows and the offset q_off of the first
// (query row i at key position q_off + i, q_off + Sq <= Sk keys): the
// tile bounds and masks then read positions, the q tensors (q, out, lse)
// are Sq rows long and k / v Sk.
//
// What bounds it on the card: operations.  4·hd flops per attended
// (q, key) pair against ~4 bytes per q row, far above Hopper's ~295
// bf16 flops/byte at the prompt lengths the engine and the trainer run,
// so only the tensor cores (989 TFLOP/s bf16 dense) can approach the
// bound; the f32 pipes (67 TFLOP/s) cannot.  The design:
//   * warp-specialised blocks: warpgroup 0 is the producer (one thread
//     issues every TMA load), warpgroups 1..NC are consumers, each owning
//     64 q rows.  NC = 2 (128-row q tiles) when the grid of 128-row tiles
//     fills the SMs, else NC = 1 (64-row tiles: the serve bucket
//     B1 S128 H28 gives 28 blocks of 128 rows but 56 of 64);
//   * TMA with tensor maps over the 4-D [B, S, heads, hd] view, so the
//     hardware does the per-head strides and zero-fills rows past S.
//     Each tile lands as 64-column blocks of 128-byte rows in the 128B
//     swizzle that wgmma reads.  Q is loaded once per block; K/V tiles of
//     128 rows cycle through a two-stage ring guarded by full/empty
//     mbarriers, so tile j+1 arrives while tile j is computed;
//   * S = Q·Kᵀ by wgmma m64n128k16 (f32 accumulate), both operands
//     K-major from swizzled shared memory (q rows and k rows are
//     contiguous along hd);
//   * the online softmax runs in registers on the accumulator fragment:
//     the 1/sqrt(hd) scale is applied to the f32 scores (pre-scaling bf16
//     q would round: 1/sqrt(128) is not a power of two), row max and row
//     sum go over the four threads that share a row by shuffles, and only
//     tiles that cross the causal diagonal, the window edge or S are
//     masked; interior tiles run unmasked;
//   * O += P·V by wgmma with A = P from registers (the f32 probabilities
//     rounded to bf16, as the TPU's default-precision dot rounds its
//     inputs) and B = V from shared memory, MN-major (wgmma's transpose
//     for 16-bit types).  O stays in f32 registers; l sums the unrounded
//     f32 probabilities, so lse = m + log(l) is the f32 value the
//     backward kernels expect; out = O / l is rounded to bf16 once and
//     leaves through shared memory in 16-byte row stores;
//   * q tiles are issued longest rows first (the block index walks the q
//     tiles from the last), so the causal tail of short tiles fills the
//     last wave;
//   * hd 80 runs as hd 128: TMA zero-fills columns 80-127 of each box, so
//     Q·Kᵀ (which stops at column 80) is unchanged, and the P·V columns
//     80-127 are computed as zeros and never stored.
// Float32 keeps the scalar block of flash_attention_fwd.cuh: it is the
// parity path, held to 2e-5 against the plain version, which TF32 tensor
// cores (10-bit mantissa) cannot meet.
//
// The host side encodes the three tensor maps at each launch with
// cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime's entry-point query, so the library links nothing beyond
// cudart.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace flash_tc {

constexpr int kBN = 128;     // key rows per K/V tile
constexpr int kStages = 2;   // K/V ring depth
constexpr int kRowBytes = 128;     // one swizzled row: 64 bf16 columns
constexpr int kAtomBytes = 1024;   // 8 swizzled rows: the 128B pattern

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of `bar` with parity `parity` to complete.  A wait
// that outlasts any real load (2^28 polls, seconds) traps, so a lost
// transaction fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 28)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma shared-memory descriptors for the 128B swizzle (layout type 1):
// start address >> 4, leading byte offset >> 4 at bit 16, stride byte
// offset >> 4 at bit 32.  K-major tiles (Q, K): rows of 128 bytes, 8-row
// atoms 1024 bytes apart (SBO); a k16 slice is 32 bytes inside the row,
// so LBO is unused.  MN-major tiles (V for P·V): K runs down the rows,
// 8-row atoms 1024 bytes apart (SBO), and the next 64 columns of N sit
// `lbo` bytes on (LBO).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the wgmma that owns it (the asm statements are ordered, plain code is
// not).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64x128] (+)= A·B, A and B K-major bf16 tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64x64] (+)= A·B, A and B K-major bf16 tiles in shared memory (the
// backward's score tiles, flash_attention_bwd_sm90.cuh)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64x64] += A·B, A (four bf16x2 registers a thread, the m64k16
// fragment) from registers, B an MN-major bf16 tile in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64x128] += A·B, A (four bf16x2 registers a thread, the m64k16
// fragment) from registers, B an MN-major bf16 tile in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}


// O += P·V for the padded head width (64 or 128 output columns)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a0, a1, a2, a3, desc_b);
  else
    wgmma_rs_n128(d, a0, a1, a2, a3, desc_b);
}

// ------------------------------------------------------------------ kernel
// HD: the head_dim (64, 80 or 128); NC: consumer warpgroups (64 q rows
// each); kLse: also write lse[b, h, row] = m + log(l) in f32.
template <int HD, int NC, bool kLse>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int Sk, int q_off, int num_heads,
                    int num_kv_heads, int n_qt, int causal, int window,
                    float scale_log2) {
  constexpr int HDP = HD == 64 ? 64 : 128;  // hd 80 runs as 128
  constexpr int kCB = HDP / 64;             // 64-column blocks of a row
  constexpr int BM = 64 * NC;               // q rows per block
  constexpr uint32_t kQBytes = BM * HDP * 2;
  constexpr uint32_t kTileBytes = kBN * HDP * 2;  // one K or one V tile
  static_assert(HD % 16 == 0 && HD <= HDP, "head_dim");

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * kStages];
  // the 128B swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;                         // [kCB][BM][64]
  const uint32_t sK = sQ + kQBytes;                 // [kStages][kCB][kBN][64]
  const uint32_t sV = sK + kStages * kTileBytes;    // [kStages][kCB][kBN][64]
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);               // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);    // + 8 * stage

  // block -> (q tile, head, batch), the q tiles with the most keys first
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / hb;
  const int rem = (int)blockIdx.x % hb;
  const int h = rem % num_heads, b = rem / num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int q0 = qt * BM;   // the tile's first q row, at key q_off + q0
  const int k_end = causal ? min(Sk, q_off + q0 + BM) : Sk;
  const int k_first = window > 0 ? max(0, q_off + q0 - window + 1) / kBN : 0;
  const int n_tiles = (k_end + kBN - 1) / kBN - k_first;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
      for (int c = 0; c < kCB; ++c)
        tma_load_4d(sQ + c * BM * kRowBytes, &tm_q, bar_q, c * 64, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages)
          mbar_wait(bar_empty + 8 * st, ((j / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * kTileBytes);
        const int k0 = (k_first + j) * kBN;
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          const uint32_t off = st * kTileBytes + c * kBN * kRowBytes;
          tma_load_4d(sK + off, &tm_k, full, c * 64, kvh, k0, b);
          tma_load_4d(sV + off, &tm_v, full, c * 64, kvh, k0, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int cq = lane & 3;
    // this thread's two rows of the consumer's 64 (accumulator fragment)
    const int ra = 16 * warp + (lane >> 2);
    const int q_lo = q0 + 64 * cw;
    const int qa = q_lo + ra, qb = qa + 8;
    // the key positions of rows q_lo, qa and qb
    const int p_lo = q_off + q_lo, pa = q_off + qa, pb = pa + 8;
    const uint32_t q_base = sQ + cw * 64 * kRowBytes;

    float o[HDP / 2];
    float s[kBN / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
    // running max (log2 units of the scaled score) and this thread's share
    // of the running denominator, for rows qa and qb
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    mbar_wait(bar_q, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
      const int k0 = (k_first + j) * kBN;
      const uint32_t k_base = sK + st * kTileBytes;
      const uint32_t v_base = sV + st * kTileBytes;

      // S = Q·Kᵀ over the hd columns (hd 80: five k16 slices)
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n128(s,
                      desc_k_major(q_base + (kk / 4) * BM * kRowBytes + col),
                      desc_k_major(k_base + (kk / 4) * kBN * kRowBytes + col),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // mask only where the tile crosses the diagonal, the window edge or S
      const bool edge = k0 + kBN > Sk || (causal && k0 + kBN - 1 > p_lo) ||
                        (window > 0 && k0 <= p_lo + 63 - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * i + 2 * cq + (e & 1);
            const int qp = (e & 2) ? pb : pa;
            bool ok = kp < Sk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) s[4 * i + e] = -INFINITY;
          }
        }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      // a row with no live key yet keeps max -inf: subtract 0 instead
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = ex2(m_a - mu_a), al_b = ex2(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;

      // P in f32 (summed into l unrounded), packed to bf16 as the A
      // fragment of P·V: register n holds columns 2n, 2n+1 of the
      // accumulator layout, which is the m64k16 A layout slice by slice
      uint32_t p[kBN / 4];
      float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const float p0 = ex2(fmaf(s[4 * i], scale_log2, -mu_a));
        const float p1 = ex2(fmaf(s[4 * i + 1], scale_log2, -mu_a));
        const float p2 = ex2(fmaf(s[4 * i + 2], scale_log2, -mu_b));
        const float p3 = ex2(fmaf(s[4 * i + 3], scale_log2, -mu_b));
        ls_a += p0 + p1;
        ls_b += p2 + p3;
        p[2 * i] = pack_bf16(p0, p1);
        p[2 * i + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * al_a + ls_a;
      l_b = l_b * al_b + ls_b;
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        o[4 * i] *= al_a;
        o[4 * i + 1] *= al_a;
        o[4 * i + 2] *= al_b;
        o[4 * i + 3] *= al_b;
      }

      // O += P·V, V MN-major: 16 key rows (two atoms) per k16 slice
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<HDP>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                      p[4 * kk + 3],
                      desc_mn_major(v_base + kk * 2 * kAtomBytes,
                                    kBN * kRowBytes));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // stage st is free
    }

    // epilogue: row sums over the quad, lse, out = O / l through shared
    // memory (this consumer's Q rows, read by no wgmma any more)
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float lc_a = fmaxf(l_a, 1e-30f), lc_b = fmaxf(l_b, 1e-30f);
    if (kLse && cq == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lrow = lse + ((size_t)b * num_heads + h) * Sq;
      if (qa < Sq) lrow[qa] = m_a * kLn2 + logf(lc_a);
      if (qb < Sq) lrow[qb] = m_b * kLn2 + logf(lc_b);
    }
    const float inv_a = 1.f / lc_a, inv_b = 1.f / lc_b;
    named_bar_sync(1 + cw, 128);  // every warp is past its last Q read
    uint8_t* so = smem + cw * 64 * kRowBytes;  // + c * BM * kRowBytes
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      // columns 8i + 2cq, +1: 16-byte chunk i % 8 of column block i / 8,
      // stored in the 128B swizzle (chunk ^ row % 8) so the quad's rows
      // hit distinct banks
      uint8_t* blk = so + (i / 8) * BM * kRowBytes;
      const int sw = ((i % 8) ^ (ra & 7)) * 16 + cq * 4;
      *reinterpret_cast<uint32_t*>(blk + ra * kRowBytes + sw) =
          pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(blk + (ra + 8) * kRowBytes + sw) =
          pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
    named_bar_sync(1 + cw, 128);
    constexpr int kChunks = HD / 8;  // 16-byte chunks of an output row
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks, ch = idx % kChunks;
      const int qp = q_lo + r;
      if (qp >= Sq) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(
          so + (ch / 8) * BM * kRowBytes + r * kRowBytes +
          (((ch % 8) ^ (r & 7)) * 16));
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * Sq + qp) * num_heads + h) * HD + ch * 8) = val;
    }
  }
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime
// (nullptr if the installed CUDA does not offer it)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The [B, S, heads, hd] bf16 tensor at `ptr` as a 4-D tensor map (hd
// innermost) with boxes of 64 columns x `rows` rows of one head of one
// sequence, 128B-swizzled; out-of-range elements read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                     int S, int B, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NC, bool kLse>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int batch, int Sq, int Sk, int q_off,
                      int H, int KV, int causal, int window,
                      cudaStream_t stream) {
  constexpr int HDP = HD == 64 ? 64 : 128;
  constexpr int BM = 64 * NC;
  constexpr size_t smem = kAtomBytes + (size_t)BM * HDP * 2 +
                          2 * (size_t)kStages * kBN * HDP * 2;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<HD, NC, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, HD, H, Sq, batch, BM) ||
      !make_map(&tm_k, k, HD, KV, Sk, batch, kBN) ||
      !make_map(&tm_v, v, HD, KV, Sk, batch, kBN))
    return cudaErrorInvalidValue;
  const int n_qt = (Sq + BM - 1) / BM;
  const long long blocks = (long long)n_qt * H * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale_log2 =
      (float)(1.0 / sqrt((double)HD) * 1.4426950408889634);
  flash_fwd_tc_kernel<HD, NC, kLse>
      <<<(unsigned)blocks, 128 * (NC + 1), smem, stream>>>(
          tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk,
          q_off, H, KV, n_qt, causal, window, scale_log2);
  return cudaGetLastError();
}

// 128-row q tiles (two consumers) when they fill the card, else 64-row
inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int HD, bool kLse>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* out, float* lse, int batch, int Sq, int Sk,
                          int q_off, int H, int KV, int causal, int window,
                          cudaStream_t stream) {
  const long long tiles128 = (long long)((Sq + 127) / 128) * H * batch;
  if (tiles128 >= num_sms())
    return launch_nc<HD, 2, kLse>(q, k, v, out, lse, batch, Sq, Sk, q_off, H,
                                  KV, causal, window, stream);
  return launch_nc<HD, 1, kLse>(q, k, v, out, lse, batch, Sq, Sk, q_off, H,
                                KV, causal, window, stream);
}

}  // namespace flash_tc
