// Split-KV flash-decode for Hopper (sm_90a) on the tensor cores: the
// block behind the bf16-q instances of the dense (decode_attention.cu;
// K6 over bf16 K/V, K7 over int8 K/V) and paged
// (decode_attention_paged.cu; K1 bf16, K3 int8) decode kernels.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention.py :: decode_attention
//   src/repro/kernels/decode_attention_q8.py :: decode_attention_q8
//   src/repro/kernels/decode_attention_paged.py :: decode_attention_paged
//   src/repro/kernels/decode_attention_paged.py :: decode_attention_paged_q8
// for bf16 q over bf16 or int8 K/V (KT), and computes what the scalar
// block of decode_attention_common.cuh computes: one new query token per
// sequence attends to its live ring slots [0, min(len, L)) under the
// token-id mask t_s = len-1 - floor_mod(len-1-s, L) and an optional
// window; dense is the same walk with page = b and L = cache_len
// (n_valid > L keeps all L).  Float32 q (the parity path) keeps the
// scalar block.
//
// What bounds it on the card: bytes.  Every live K/V element (2 bytes in
// bf16, 1 in int8 plus one bf16 scale per row) is read once and used by
// the g q heads of its group in 4g flops: 14 (bf16) or 28 (int8) flops
// per byte at Qwen2.5-7B's g = 7, far below the ~295 where Hopper's bf16
// tensor cores would become the limit.  The scalar block stayed far from
// that bound for three reasons, and the design answers each:
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
//     computed (two tiles ahead, up to 64 KB a block at hd 128 in bf16,
//     32 KB in int8).  Each warp runs its own pipeline over its 16 rows of
//     every tile (copies, scales, pool rows) and waits on it with a warp
//     barrier, so the four warps drift apart instead of meeting at every
//     tile; the block meets once, to merge.  Paged rows go through the
//     block table: each warp reads the pool rows of its slots one tile
//     ahead of their copies into a small shared table, so no copy waits
//     on a table read; rows past the range are zero-filled by the copy
//     itself.  bf16 K and V stay bf16 in shared memory, in rows padded by
//     16 bytes so the eight rows one ldmatrix reads fall in distinct
//     banks;
//   * scalar f32 arithmetic on shared-memory operands (4g flops per
//     element read: at g = 7 and 3.35 TB/s ~47 TFLOP/s of f32 FMA, 70%
//     of the f32 peak, above it at g = 12, and twice that per byte in
//     int8): here S = Q·Kᵀ and O += P·V run on mma.sync m16n8k16 (bf16
//     in, f32 accumulate).  The group's g <= 16 q rows are one m16 tile
//     (rows past g are zero and never stored); Q is the A operand, held
//     in registers for the whole walk (int8: read from shared memory by
//     ldmatrix for each tile, to free 32 registers); K tiles load with
//     ldmatrix, V tiles with ldmatrix.trans.  Each of the four warps
//     takes 16 slots of the tile and keeps its own online softmax (f32
//     max and sum in the log2 domain, the hd^-0.5 scale applied to S in
//     f32, P rounded to bf16 as the P·V operand, as the flash forward
//     does; the accumulator is rescaled only when the max moved); the
//     warps merge through shared memory at the end.  hd 64, 80 and 128
//     are all multiples of 16.
//
// int8 K/V (KT = int8_t, with bf16 scales [..., kv_heads, 1] per (token,
// kv head)).  An int8 value is exact in bf16 (|x| <= 128), and a bf16 q
// times it is exact in the f32 accumulator, so the tensor cores compute
// q·k_int exactly up to the order of the f32 sums.  The int8 tile lands
// unpadded (HD bytes a row: HD/16 cp.async pieces, 5 at hd 80, so a
// warp's last copy round is guarded).  Each warp converts its own 16
// rows of K, then of V, into a private bf16 tile laid out as the bf16
// ring (padded pitch) and runs the bf16 path's ldmatrix and mma on it:
// every element is converted once per block, never once per q head.
// The conversion is exact and stays on the integer and FADD pipes (I2F
// and the bf16 pack F2FP issue at 16 a clock per SM on sm_90, a quarter
// of the integer pipe's rate): each byte, biased by 128, is placed in
// the mantissa of the float 2^23 by one PRMT, 2^23 + 128 is subtracted
// in f32, and two such floats, integers below 2^8, are exactly their
// upper halves in bf16, which one PRMT packs (11 instructions for 4
// values).  The conversion is most of a tile's instructions, so the
// int8 instances run three blocks an SM (12 warps) to hide its latency.
// The scales (2-byte values at a stride of kv_heads) cannot go through
// cp.async: each lane plain-loads one (K for lanes 0-15, V for 16-31)
// when its warp's copies are issued, and stores it to a small per-stage
// shared array at the start of the next loop iteration (a tile of
// compute hides the load); a slot past the range gets scale 0 and no
// load.  The K scale multiplies the accumulator fragment together with
// hd^-0.5 · log2 e before the running max, and a masked score is set to
// -inf after that, never multiplied; the V scale is folded into P
// before P's bf16 rounding (P'_j = bf16(p_j s_v[j]), the A operand of
// P·V over v_int), while the denominator l sums the unscaled p_j.  The
// one rounding that differs from the f32 plain version is then P's, as
// in bf16.  (Building the B fragments from the int8 ring in registers,
// without the bf16 tile, measured slower: tools/decode_variants.py.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace repro_decode_split {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 16 * kWarps;   // key tile: 16 ring slots per warp
constexpr int kStages = 3;           // K/V ring depth
constexpr int kPad = 8;              // bf16 of padding per shared row
constexpr int kMaxGroup = 16;        // q heads per kv head: one m16 tile

template <typename KT>
constexpr bool kQ8 = std::is_same<KT, int8_t>::value;

// ring row pitch in elements: bf16 rows padded by 16 bytes (ldmatrix's
// eight rows in distinct banks), int8 rows (converted to a bf16 tile)
// unpadded
template <typename KT, int HD>
__host__ __device__ constexpr int ring_pitch() {
  return kQ8<KT> ? HD : HD + kPad;
}

// int8: three blocks an SM (12 warps to hide the conversion's latency;
// 168 registers, with Q read from shared memory for each tile instead of
// held, and 72 KB of shared memory at hd 128), else ptxas's choice (two
// blocks of the bf16 ring fit an SM)
template <typename KT>
constexpr int kMinBlocks = kQ8<KT> ? 3 : 1;
// the warps' merge: f32 rows of HD + 8 (a half-warp's float2 stores of
// four rows fall in distinct banks)
template <int HD>
constexpr int kMergePitch = HD + 8;

// bytes of dynamic shared memory: the K/V ring, paged its pool rows, for
// int8 also the ring's scales (f32), each warp's bf16 tile (K, then V)
// and the group's Q; the warps' merge reuses the front
template <typename KT, int HD, bool kPaged>
constexpr size_t smem_bytes() {
  constexpr size_t ring =
      (size_t)kStages * 2 * kKeys * ring_pitch<KT, HD>() * sizeof(KT) +
      (kPaged ? (size_t)kStages * kKeys * sizeof(size_t) : 0);
  constexpr size_t q8 =
      (kQ8<KT> ? (size_t)kStages * 2 * kKeys * 4 : 0) +
      (kQ8<KT> ? (size_t)(kWarps + 1) * 16 * (HD + kPad) * 2 : 0);
  constexpr size_t merge =
      sizeof(float) * kWarps * kMaxGroup * (kMergePitch<HD> + 2);
  return ring + q8 > merge ? ring + q8 : merge;
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

// four int8 (one word, byte 0 first) -> four bf16 (two words), exactly:
// byte i + 128 into the low mantissa byte of 2^23, minus 2^23 + 128 in
// f32; an integer below 2^8 in magnitude is its f32's upper half in bf16
// byte i (0-3) of a word biased by 0x80808080, as an exact f32
__device__ __forceinline__ float biased_byte(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
         8388736.f;
}
// the bf16 pair (lo, hi) of two exact small-integer floats
__device__ __forceinline__ uint32_t upper_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  return make_uint2(upper_halves(biased_byte(u, 0), biased_byte(u, 1)),
                    upper_halves(biased_byte(u, 2), biased_byte(u, 3)));
}

// ---------------------------------------------------------------- pass 1
// grid (splits, kv heads, batch), kThreads threads.  kPaged: rows through
// block_tables, else page = b with page_size = L (pages_per_seq = 1).
// KT: bf16 K/V (scales unused) or int8 K/V with bf16 scales.  Partials:
// part_acc [B, H, splits, HD], part_m / part_l [B, H, splits], m in the
// log2 domain of the scaled scores; unused with one split.
template <typename KT, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks<KT>)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const KT* __restrict__ k_rows,
                    const KT* __restrict__ v_rows,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int num_heads,
                    int num_kv_heads, int num_blocks, int page_size,
                    int pages_per_seq, int window, int split_len,
                    float scale_log2) {
  constexpr bool kInt8 = kQ8<KT>;
  constexpr int kPitch = HD + kPad;     // bf16 tile row pitch, elements
  constexpr int kRing = ring_pitch<KT, HD>();   // ring row pitch
  constexpr int kPiece = 16 / (int)sizeof(KT);  // elements per cp.async
  constexpr int kChunks = HD / kPiece;  // 16-byte pieces per row
  constexpr int kPieces = 16 * kChunks;  // a warp's 16 rows of a tile
  constexpr int kCopyRounds = (kPieces + 31) / 32;
  constexpr int kKSteps = HD / 16;      // k16 steps of Q·Kᵀ
  constexpr int kNTiles = HD / 8;       // n8 tiles of O
  static_assert(HD % 16 == 0, "head_dim is a multiple of 16");
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
  KT* sK = reinterpret_cast<KT*>(smem_raw);
  KT* sV = sK + kStages * kKeys * kRing;
  // Each warp runs its own pipeline over its 16 rows of every tile (rows
  // wr0 ...): it copies them, their scales and (paged) their pool rows,
  // and waits for them with a warp barrier only; the block meets once,
  // to merge.  Paged only: the pool row of each slot of the ring's tiles
  // [stage][slot]
  size_t* sRow = reinterpret_cast<size_t*>(sV + kStages * kKeys * kRing);
  // int8 only: the ring's scales [stage][K, V][slot], this warp's bf16
  // tile [16 slots][kPitch] (K, then V) and the group's Q [16 rows][kPitch]
  // (zero past g)
  float* sScale = reinterpret_cast<float*>(
      kPaged ? sRow + kStages * kKeys
             : reinterpret_cast<size_t*>(sV + kStages * kKeys * kRing));
  __nv_bfloat16* sConv = reinterpret_cast<__nv_bfloat16*>(
                             sScale + kStages * 2 * kKeys) +
                         warp * 16 * kPitch;
  __nv_bfloat16* sQ = sConv + (kWarps - warp) * 16 * kPitch;
  const int* bt = kPaged ? block_tables + (size_t)b * pages_per_seq
                         : nullptr;
  const int wr0 = warp * 16;

  // the pool row of a live ring slot
  auto row_of = [&](int slot) -> size_t {
    if constexpr (kPaged) {
      int page = __ldg(bt + slot / page_size);
      page = min(max(page, 0), num_blocks - 1);
      return ((size_t)page * page_size + slot % page_size) * num_kv_heads +
             kvh;
    } else {
      return ((size_t)b * L + slot) * num_kv_heads + kvh;
    }
  };

  // the pool row of slot r of tile t (kvh, a valid address, past the
  // range).  Paged: read from the tile's stage of sRow, which lane r - wr0
  // of the warp filled from the block table one tile ahead (tile_row), so
  // that no copy waits on a table read
  auto tile_row = [&](int t, int r) -> size_t {
    const int slot = lo + t * kKeys + r;
    return slot < hi ? row_of(slot) : (size_t)kvh;
  };
  auto row_at = [&](int t, int r) -> size_t {
    if constexpr (kPaged)
      return sRow[(t % kStages) * kKeys + r];
    else
      return tile_row(t, r);
  };

  // this warp's rows of tile t (slots lo + t*kKeys + wr0 ...) into ring
  // stage st: kPieces copies each of K and V over the lanes, the last
  // round guarded where they do not divide (int8 at hd 80: 80 pieces)
  auto load_tile = [&](int t, int st) {
    const int s0 = lo + t * kKeys;
#pragma unroll
    for (int j = 0; j < kCopyRounds; ++j) {
      const int i = lane + j * 32;
      if (kPieces % 32 == 0 || i < kPieces) {
        const int r = wr0 + i / kChunks, c = i % kChunks;
        const bool live = s0 + r < hi;
        const size_t row = row_at(t, r);
        const size_t off = row * HD + c * kPiece;
        const int so = (st * kKeys + r) * kRing + c * kPiece;
        cp_async16(smem_u32(sK + so), k_rows + off, live);
        cp_async16(smem_u32(sV + so), v_rows + off, live);
      }
    }
  };
  // int8: this lane's scale of tile t (K for lanes 0-15, V for 16-31, of
  // row wr0 + lane % 16), 0 past the range; a plain load, stored to
  // shared by store_scale later
  auto load_scale = [&](int t) -> float {
    const int r = wr0 + lane % 16;
    if (lo + t * kKeys + r >= hi) return 0.f;
    return __bfloat162float((lane < 16 ? k_scale : v_scale)[row_at(t, r)]);
  };
  auto store_scale = [&](int st, float s) {
    sScale[st * 2 * kKeys + (lane / 16) * kKeys + wr0 + lane % 16] = s;
  };
  // int8, converting to a tile: this warp's 16 rows of ring stage st (K or
  // V) into its bf16 tile, 8 int8 (one 8-byte read) into 8 bf16 (one
  // 16-byte write) per piece
  auto convert_rows = [&](const KT* ring, int st) {
    constexpr int kRowPieces = HD / 8;
    __syncwarp();   // the tile's last ldmatrix reads are done
#pragma unroll
    for (int j = 0; j < kRowPieces / 2; ++j) {   // 16 rows over 32 lanes
      const int i = lane + 32 * j;
      const int r = i / kRowPieces, c = i % kRowPieces;
      const uint2 w = *reinterpret_cast<const uint2*>(
          ring + (st * kKeys + warp * 16 + r) * kRing + c * 8);
      const uint2 lo4 = i8x4_to_bf16x4(w.x), hi4 = i8x4_to_bf16x4(w.y);
      *reinterpret_cast<uint4*>(sConv + r * kPitch + c * 8) =
          make_uint4(lo4.x, lo4.y, hi4.x, hi4.y);
    }
    __syncwarp();
  };

  const int n_tiles = (hi - lo + kKeys - 1) / kKeys;
  // paged: the rows of the first kStages tiles (their table reads all in
  // flight at once)
  if constexpr (kPaged) {
    if (lane < 16) {
      size_t rows[kStages];
#pragma unroll
      for (int t = 0; t < kStages; ++t) rows[t] = tile_row(t, wr0 + lane);
#pragma unroll
      for (int t = 0; t < kStages; ++t) sRow[t * kKeys + wr0 + lane] = rows[t];
    }
    __syncwarp();
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }
  // int8: the scales of tile 0 now; tile 1's wait in a register until the
  // start of iteration 0
  float sc = 0.f;
  if constexpr (kInt8) {
    store_scale(0, load_scale(0));
    if (n_tiles > 1) sc = load_scale(1);
  }

  // Q as the A operand, rows = the group's q heads (zero past g): thread
  // holds rows qr and qr + 8, columns qc, qc + 1 (+ 8) of each k16 step;
  // int8 keeps Q in shared memory and reads it by ldmatrix for each tile
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const unsigned short* qs =
      reinterpret_cast<const unsigned short*>(q) + row0 * HD;
  uint32_t qa[kInt8 ? 1 : kKSteps][4];
  if constexpr (kInt8) {
    for (int i = tid; i < 16 * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      reinterpret_cast<unsigned short*>(sQ)[r * kPitch + d] =
          r < g ? qs[(size_t)r * HD + d] : 0;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qr + (e % 2) * 8, d = kk * 16 + (e / 2) * 8 + qc;
        qa[kk][e] = r < g ? q_pair(qs + (size_t)r * HD + d) : 0u;
      }
    }
  }

  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // the token-id ring mask t_s = len-1 - floor_mod(len-1-s, L) (the
  // divisor's sign, as jnp.mod; C++ % truncates toward zero): for s in
  // [0, L) it is len-1 - (r0 - s), plus L where r0 < s
  const int r0 = (((len - 1) % L) + L) % L;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows qr, qr + 8
  float l_run[2] = {0.f, 0.f};               // this thread's share

  for (int t = 0; t < n_tiles; ++t) {
    // int8: the scales of tile t + 1, loaded an iteration ago, into their
    // stage (tile t - 2's, last read by this warp in iteration t - 2)
    if constexpr (kInt8)
      if (t + 1 < n_tiles) store_scale((t + 1) % kStages, sc);
    cp_async_wait<kStages - 2>();
    __syncwarp();   // the warp's rows of tile t landed; stage (t-1) % 3 free
    if (t + kStages - 1 < n_tiles) {
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
      if constexpr (kInt8) sc = load_scale(t + kStages - 1);
    }
    cp_async_commit();
    // paged: the rows of tile t + kStages, stored at the end into the
    // stage of tile t (whose copies were issued two iterations ago)
    size_t next_row = 0;
    const bool row_ahead = kPaged && lane < 16 && t + kStages < n_tiles;
    if (row_ahead) next_row = tile_row(t + kStages, wr0 + lane);

    const int st = t % kStages;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const __nv_bfloat16* tK;
    if constexpr (kInt8) {
      convert_rows(sK, st);
      tK = sConv;
    } else {
      tK = sK + (st * kKeys + warp * 16) * kPitch;
    }
    // S = Q·Kᵀ over this warp's 16 slots: two n8 tiles, the odd k16 steps
    // into a second accumulator (four chains of mma).  ldmatrix x4: lanes
    // 0-15 address slots 0-7, 16-31 slots 8-15; odd eighths take the
    // upper 8 columns of the k16 step
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t kb[4], qf[4];
      const int key = (lane / 16) * 8 + lane % 8;
      const int col = kk * 16 + ((lane / 8) % 2) * 8;
      ldsm_x4(smem_u32(tK + key * kPitch + col), kb);
      if constexpr (kInt8) {   // A: lanes 0-15 rows at k, 16-31 at k + 8
        ldsm_x4(smem_u32(sQ + (lane % 16) * kPitch + kk * 16 +
                         (lane / 16) * 8),
                qf);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
      }
      mma_bf16(kk % 2 ? s2[0] : s[0], qf, kb[0], kb[1]);
      mma_bf16(kk % 2 ? s2[1] : s[1], qf, kb[2], kb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];
    // int8: V into the same tile, its conversion beside the softmax
    if constexpr (kInt8) convert_rows(sV, st);

    // the token-id ring mask and the window, per slot of the thread's
    // fragment: slot of s[nt][e] = 8 nt + qc + e % 2.  int8: the K scale
    // joins the score scale; a masked score is -inf, never scaled
    const int sw = lo + t * kKeys + warp * 16;
    const float* scK = sScale + st * 2 * kKeys + warp * 16;
    float vs[2][2] = {{1.f, 1.f}, {1.f, 1.f}};   // int8: V scales
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float sk[2] = {1.f, 1.f};
      if constexpr (kInt8) {
        const float2 k2 = *reinterpret_cast<const float2*>(scK + nt * 8 + qc);
        const float2 v2 =
            *reinterpret_cast<const float2*>(scK + kKeys + nt * 8 + qc);
        sk[0] = k2.x;
        sk[1] = k2.y;
        vs[nt][0] = v2.x;
        vs[nt][1] = v2.y;
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int slot = sw + nt * 8 + qc + e2;
        const int ts = len - 1 - (r0 - slot + (r0 < slot ? L : 0));
        const bool valid = slot < hi && ts >= 0 &&
                           (window <= 0 || ts > len - 1 - window);
        const float mul = kInt8 ? sk[e2] * scale_log2 : scale_log2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = s[nt][h * 2 + e2];
          x = valid ? x * mul : -INFINITY;
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
        psum[e / 2] += x;   // l sums the unscaled p
        if constexpr (kInt8) x *= vs[nt][e % 2];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] = l_run[h] * alpha[h] + psum[h];
      if (alpha[h] != 1.f) {   // the max moved: rescale (x 1 is exact)
#pragma unroll
        for (int n = 0; n < kNTiles; ++n) {
          o[n][2 * h] *= alpha[h];
          o[n][2 * h + 1] *= alpha[h];
        }
      }
    }

    // O += P·V: the S fragments (int8: times the V scale), rounded to
    // bf16, are the A operand (k = the 16 slots); ldmatrix.trans x4
    // gives two n8 tiles of V: lanes 0-7 / 16-23 address slots 0-7, 8-15
    // / 24-31 slots 8-15, the upper half of the lanes the next 8 columns
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    const __nv_bfloat16* tV =
        kInt8 ? sConv
              : reinterpret_cast<const __nv_bfloat16*>(sV) +
                    (st * kKeys + warp * 16) * kPitch;
#pragma unroll
    for (int j = 0; j < kNTiles / 2; ++j) {
      uint32_t vb[4];
      const int key = ((lane / 8) % 2) * 8 + lane % 8;
      const int col = j * 16 + (lane / 16) * 8;
      ldsm_x4_trans(smem_u32(tV + key * kPitch + col), vb);
      mma_bf16(o[2 * j], pa, vb[0], vb[1]);
      mma_bf16(o[2 * j + 1], pa, vb[2], vb[3]);
    }

    if (row_ahead) sRow[(t % kStages) * kKeys + wr0 + lane] = next_row;
  }

  // merge the four warps through shared memory (the ring is done)
  cp_async_wait<0>();
  __syncthreads();
  float* mM = reinterpret_cast<float*>(smem_raw);   // [kWarps][16]
  float* mL = mM + kWarps * kMaxGroup;              // [kWarps][16]
  float* mO = mL + kWarps * kMaxGroup;   // [kWarps][16][kMergePitch]
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
      float* p =
          mO + (size_t)(warp * kMaxGroup + qr + 8 * h) * kMergePitch<HD>;
      p[n * 8 + qc] = o[n][2 * h];
      p[n * 8 + qc + 1] = o[n][2 * h + 1];
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
        num += a * mO[(size_t)(w * kMaxGroup + r) * kMergePitch<HD> + d];
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

template <typename KT, int HD, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* lengths, void* out,
                   void* part_acc, void* part_m, void* part_l, int batch,
                   int num_heads, int num_kv_heads, int num_blocks,
                   int page_size, int pages_per_seq, int window,
                   int num_splits, int split_len, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KT, HD, kPaged>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<KT, HD, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const float scale_log2 =
      (float)(1.0 / sqrt((double)HD) * 1.4426950408889634);
  dim3 grid(num_splits, num_kv_heads, batch);
  decode_split_kernel<KT, HD, kPaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
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

// bf16 q and out; KT = bf16 K/V (scales ignored) or int8 K/V with bf16
// scales; head_dim 64, 80 or 128.  The splits must cover the ring:
// (num_splits - 1) * split_len < L <= num_splits * split_len, and the
// partials be given when num_splits > 1.  Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for shapes the kernel does
// not take).
template <typename KT, bool kPaged>
int dispatch(const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale,
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
      (num_splits > 1 && (!part_acc || !part_m || !part_l)) ||
      (kQ8<KT> && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(HD)                                                     \
  return (int)launch<KT, HD, kPaged>(                                       \
      q, k, v, k_scale, v_scale, block_tables, lengths, out, part_acc,      \
      part_m, part_l, batch, num_heads, num_kv_heads, num_blocks, page_size, \
      pages_per_seq, window, num_splits, split_len, s)
  if (head_dim == 64) REPRO_LAUNCH(64);
  if (head_dim == 80) REPRO_LAUNCH(80);
  if (head_dim == 128) REPRO_LAUNCH(128);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_decode_split
