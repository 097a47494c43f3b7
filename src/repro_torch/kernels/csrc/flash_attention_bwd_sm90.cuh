// Flash-attention backward for Hopper (sm_90a) in bf16 on the tensor
// cores: the bf16 instances of the dq kernel (K5b) and the dk/dv kernel
// (K5c) of flash_attention_bwd.cu.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/flash_attention_bwd.py :: _bwd (_dq_kernel, _dkv_kernel)
// and computes their functions from q, dO [B,S,H,hd], k, v [B,S,KV,hd]
// and the forward's f32 lse and Δ = rowsum(out ⊙ dO) [B,H,S]:
//   P  = exp(q·kᵀ·scale − lse), masked to causal and window
//   dS = P ⊙ (dO·vᵀ − Δ) · scale
//   dq = dS·k;  dk = Σ_group dSᵀ·q;  dv = Σ_group Pᵀ·dO
// with any S >= 1 (ragged last tiles masked), GQA groups read in place,
// and hd 64, 80 or 128 (80 runs as 128: TMA zero-fills columns 80-127,
// the products over hd stop at 80, and the padded output columns are
// never stored).  A sequence-parallel rank passes its Sq query rows
// (q, dO, lse, Δ, dq) at key position q_off onwards of Sk keys (k, v,
// dk, dv): the tile bounds and masks read positions, and a key tile no
// query row sees (past the rank's last query, or before the window of
// its first) gets no q tile and writes zero dk / dv rows.
//
// What bounds them on the card: operations, 6 (dq) and 8 (dk/dv) flops
// per q head × hd × attended pair against a few bytes per row, so only
// the tensor cores can approach the bound.  The design is the forward
// block's (flash_attention_fwd_sm90.cuh), whose TMA maps, mbarrier waits,
// swizzled descriptors and wgmma wrappers it reuses:
//   * warp-specialised blocks: one thread issues every TMA load, and
//     consumer warpgroups own 64 rows of the block's output each;
//   * dq: one block per (batch, q head, q tile), q tiles with the most
//     keys first; warpgroup 0 produces, NC consume (NC = 2 when the grid
//     of 128-row tiles fills the SMs, else 1, as the forward chooses).
//     Q and dO are loaded once; 64-row K/V tiles cycle through a
//     two-stage TMA ring guarded by full/empty mbarriers.  Per tile,
//     S = Q·Kᵀ and dP = dO·Vᵀ by wgmma m64n64k16 (all operands K-major:
//     rows are contiguous along hd), then P and dS in registers on the
//     f32 fragments (the scale applied to the f32 scores, as the forward
//     does), then dq += dS·K by wgmma with dS from registers (rounded to
//     bf16, as the TPU's default-precision dot rounds its inputs) and K
//     read MN-major, as the forward reads V for P·V;
//   * dk/dv: one block per (batch, kv head, 64-key tile): one consumer
//     warpgroup and one producer warp.  K and V are loaded once; 64-row
//     (Q, dO) tiles of every q head of the group cycle through the ring,
//     with the rows' lse and Δ staged beside them by the producer warp.
//     The consumer computes the transposed products, so nothing is
//     transposed in shared memory: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K-major),
//     Pᵀ and dSᵀ on the fragment (lse and Δ run along its columns), then
//     dv += Pᵀ·dO and dk += dSᵀ·Q with Pᵀ and dSᵀ from registers and dO,
//     Q MN-major.  dk and dv stay in f32 registers across the whole group
//     loop: 128 a thread at hd 128, beside 64 for the two score
//     fragments.  A block of two consumers and a producer puts three
//     warps on some SM sub-partition (16K registers), so ptxas caps it
//     at 168 registers a thread, setmaxnreg or not: that block spilled
//     ~1 KB a thread and ran 2.9x slower than this one (PERF.md), which
//     holds 255 with no spill;
//   * only tiles that cross the diagonal, the window edge or S are
//     masked; tiles outside the band are never loaded, and a dq consumer
//     skips the (released) tiles that lie wholly outside its own rows'
//     band;
//   * no atomics: every block owns its output rows, so dq, dk and dv
//     are bitwise repeatable; Δ comes from the caller.
#pragma once

#include "flash_attention_fwd_sm90.cuh"

namespace flash_tc {

constexpr int kBwdN = 64;       // rows of a streamed tile: keys (dq), q (dk/dv)
constexpr int kBwdStages = 2;   // ring depth
constexpr float kLog2e = 1.4426950408889634f;

// query row qi (key position q_off + qi) attends key kp
__device__ __forceinline__ bool live(int qi, int kp, int Sq, int Sk,
                                     int q_off, int causal, int window) {
  const int qp = q_off + qi;
  bool ok = kp < Sk && qi < Sq;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// A 64-row f32 accumulator fragment of a warpgroup (rows ra, ra + 8 of
// each warp's 16; columns 8i + 2cq, +1), rounded to bf16 through the
// warpgroup's 64 swizzled rows at `so` (64-column blocks `blk` bytes
// apart, read by no wgmma any more), then stored in 16-byte row pieces:
// row r to dst + r * stride elements, for r < rows.
template <int HD, int HDP>
__device__ __forceinline__ void store_rows(const float (&acc)[HDP / 2],
                                           uint8_t* so, uint32_t blk,
                                           int ra, int cq, int t, int bar,
                                           __nv_bfloat16* dst, size_t stride,
                                           int rows) {
  named_bar_sync(bar, 128);  // every warp is past its last read of `so`
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i) {
    uint8_t* b = so + (i / 8) * blk;
    const int sw = ((i % 8) ^ (ra & 7)) * 16 + cq * 4;
    *reinterpret_cast<uint32_t*>(b + ra * kRowBytes + sw) =
        pack_bf16(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(b + (ra + 8) * kRowBytes + sw) =
        pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
  named_bar_sync(bar, 128);
  constexpr int kChunks = HD / 8;  // 16-byte pieces of an output row
  for (int idx = t; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, ch = idx % kChunks;
    if (r >= rows) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        so + (ch / 8) * blk + r * kRowBytes + (((ch % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(dst + r * stride + ch * 8) = val;
  }
}

// ------------------------------------------------------------------- dq
template <int HD, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                   int q_off, int num_heads, int num_kv_heads, int n_qt,
                   int causal, int window, float scale, float scale_log2) {
  constexpr int HDP = HD == 64 ? 64 : 128;  // hd 80 runs as 128
  constexpr int kCB = HDP / 64;             // 64-column blocks of a row
  constexpr int BM = 64 * NC;               // q rows per block
  constexpr uint32_t kQBytes = BM * HDP * 2;          // Q or dO
  constexpr uint32_t kTileBytes = kBwdN * HDP * 2;    // one K or V tile
  static_assert(HD % 16 == 0 && HD <= HDP, "head_dim");

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * kBwdStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;                          // [kCB][BM][64]
  const uint32_t sO = sQ + kQBytes;                  // [kCB][BM][64] dO
  const uint32_t sK = sO + kQBytes;                  // [stages][kCB][64][64]
  const uint32_t sV = sK + kBwdStages * kTileBytes;  // [stages][kCB][64][64]
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kBwdStages]);

  // block -> (q tile, head, batch), the q tiles with the most keys first
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / hb;
  const int rem = (int)blockIdx.x % hb;
  const int h = rem % num_heads, b = rem / num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int q0 = qt * BM;   // the tile's first q row, at key q_off + q0
  const int k_end = causal ? min(Sk, q_off + q0 + BM) : Sk;
  const int k_first =
      window > 0 ? max(0, q_off + q0 - window + 1) / kBwdN : 0;
  const int n_tiles = (k_end + kBwdN - 1) / kBwdN - k_first;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) {
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
      mbar_expect_tx(bar_q, 2 * kQBytes);
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        tma_load_4d(sQ + c * BM * kRowBytes, &tm_q, bar_q, c * 64, h, q0, b);
        tma_load_4d(sO + c * BM * kRowBytes, &tm_do, bar_q, c * 64, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kBwdStages;
        if (j >= kBwdStages)
          mbar_wait(bar_empty + 8 * st, ((j / kBwdStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * kTileBytes);
        const int k0 = (k_first + j) * kBwdN;
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          const uint32_t off = st * kTileBytes + c * kBwdN * kRowBytes;
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
    const int ra = 16 * warp + (lane >> 2);  // rows ra, ra + 8 of the 64
    const int q_lo = q0 + 64 * cw;
    const int qa = q_lo + ra, qb = qa + 8;
    const int p_lo = q_off + q_lo;  // the key position of row q_lo
    const uint32_t q_base = sQ + cw * 64 * kRowBytes;
    const uint32_t o_base = sO + cw * 64 * kRowBytes;
    const size_t row0 = ((size_t)b * num_heads + h) * Sq;
    // lse in log2 units, so P = 2^(s·scale·log2e − lse·log2e)
    const float la = qa < Sq ? lse[row0 + qa] * kLog2e : 0.f;
    const float lb = qb < Sq ? lse[row0 + qb] * kLog2e : 0.f;
    const float da = qa < Sq ? delta[row0 + qa] : 0.f;
    const float db = qb < Sq ? delta[row0 + qb] : 0.f;

    float acc[HDP / 2];
    float s[kBwdN / 2], dp[kBwdN / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdN / 2; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(bar_q, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kBwdStages;
      mbar_wait(bar_full + 8 * st, (j / kBwdStages) & 1);
      const int k0 = (k_first + j) * kBwdN;
      const uint32_t k_base = sK + st * kTileBytes;
      const uint32_t v_base = sV + st * kTileBytes;
      // a tile wholly outside this consumer's rows' band adds nothing
      const bool dead = q_lo >= Sq || (causal && k0 > p_lo + 63) ||
                        (window > 0 && k0 + kBwdN - 1 <= p_lo - window);
      if (!dead) {
        // S = Q·Kᵀ and dP = dO·Vᵀ over the hd columns
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk / 4) * BM * kRowBytes + (kk % 4) * 32;
          const uint32_t kcol = (kk / 4) * kBwdN * kRowBytes + (kk % 4) * 32;
          wgmma_ss_n64(s, desc_k_major(q_base + col),
                       desc_k_major(k_base + kcol), kk > 0);
          wgmma_ss_n64(dp, desc_k_major(o_base + col),
                       desc_k_major(v_base + kcol), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        fence_regs(dp);

        // dS on the fragment, packed to bf16 as the A fragment of dS·K
        const bool edge = k0 + kBwdN > Sk ||
                          (causal && k0 + kBwdN - 1 > p_lo) ||
                          (window > 0 && k0 <= p_lo + 63 - window);
        uint32_t a[kBwdN / 4];
#pragma unroll
        for (int i = 0; i < kBwdN / 8; ++i) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 2;
            float p = ex2(fmaf(s[4 * i + e], scale_log2, -(hi ? lb : la)));
            if (edge && !live(hi ? qb : qa, k0 + 8 * i + 2 * cq + (e & 1), Sq,
                              Sk, q_off, causal, window))
              p = 0.f;
            ds[e] = p * (dp[4 * i + e] - (hi ? db : da)) * scale;
          }
          a[2 * i] = pack_bf16(ds[0], ds[1]);
          a[2 * i + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dq += dS·K, K MN-major: 16 key rows (two atoms) per k16 slice
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwdN / 16; ++kk)
          wgmma_rs<HDP>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                        a[4 * kk + 3],
                        desc_mn_major(k_base + kk * 2 * kAtomBytes,
                                      kBwdN * kRowBytes));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // stage st is free
    }

    // epilogue through this consumer's Q rows
    store_rows<HD, HDP>(acc, smem + cw * 64 * kRowBytes, BM * kRowBytes, ra,
                        cq, t, 1 + cw,
                        dq + (((size_t)b * Sq + q_lo) * num_heads + h) * HD,
                        (size_t)num_heads * HD, Sq - q_lo);
  }
}

// ----------------------------------------------------------------- dk/dv
// One consumer warpgroup owning the block's 64 key rows, and one producer
// warp: 160 threads, so the consumer may hold 255 registers.  kOffset:
// query rows at an offset (a sequence-parallel rank's); without it the
// whole sequence (Sq == Sk, no offset), whose instance folds the offset
// arithmetic away (compiled in, it made the whole-sequence call slower on
// the card).
template <int HD, bool kOffset>
__global__ void __launch_bounds__(160, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Sq_arg, int Sk,
                    int q_off_arg, int num_heads, int num_kv_heads, int n_kt,
                    int causal, int window, float scale, float scale_log2) {
  const int Sq = kOffset ? Sq_arg : Sk;
  const int q_off = kOffset ? q_off_arg : 0;
  constexpr int HDP = HD == 64 ? 64 : 128;
  constexpr int kCB = HDP / 64;
  constexpr uint32_t kTileBytes = kBwdN * HDP * 2;  // K, V, one Q or dO tile
  static_assert(HD % 16 == 0 && HD <= HDP, "head_dim");

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * kBwdStages];
  // lse (log2 units) and Δ of each staged q tile's rows
  __shared__ float2 sLD[kBwdStages][kBwdN / 2][2];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sK = base;                          // [kCB][64][64]
  const uint32_t sV = sK + kTileBytes;               // [kCB][64][64]
  const uint32_t sQ = sV + kTileBytes;               // [stages][kCB][64][64]
  const uint32_t sO = sQ + kBwdStages * kTileBytes;  // [stages][kCB][64][64]
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kBwdStages]);

  // block -> (key tile, kv head, batch), the key tiles with the most q
  // rows first
  const int hb = gridDim.x / n_kt;
  const int kt = (int)blockIdx.x / hb;
  const int rem = (int)blockIdx.x % hb;
  const int kvh = rem % num_kv_heads, b = rem / num_kv_heads;
  const int rep = num_heads / num_kv_heads;
  const int k0 = kt * kBwdN;
  // q tiles that can see this key tile, from its causal start to the
  // window's end past its last key (each holds a live pair), the same
  // run for each group head; q row i sits at key q_off + i.  A tile past
  // the last query row, or before the first one's window, has none: its
  // dk / dv rows are written as zeros all the same
  const int q_first = !causal ? 0 : kOffset ? max(0, k0 - q_off) / kBwdN
                                            : kt;
  const int q_end =
      window > 0 ? min(Sq, k0 + kBwdN - 1 + window - q_off) : Sq;
  const int n_q =
      kOffset ? max(0, (max(q_end, 0) + kBwdN - 1) / kBwdN - q_first)
              : (q_end + kBwdN - 1) / kBwdN - q_first;
  const int n_items = rep * n_q;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) {
      // the TMA's expect_tx, then one arrival per producer lane once its
      // lse/Δ rows are in shared memory
      mbar_init(bar_full + 8 * st, 1 + 32);
      mbar_init(bar_empty + 8 * st, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------- producer (one warp)
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < kCB; ++c) {
        const uint32_t off = c * kBwdN * kRowBytes;
        tma_load_4d(sK + off, &tm_k, bar_kv, c * 64, kvh, k0, b);
        tma_load_4d(sV + off, &tm_v, bar_kv, c * 64, kvh, k0, b);
      }
    }
    for (int j = 0; j < n_items; ++j) {
      const int st = j % kBwdStages;
      if (j >= kBwdStages)
        mbar_wait(bar_empty + 8 * st, ((j / kBwdStages) - 1) & 1);
      const int h = kvh * rep + j / n_q;
      const int q0 = (q_first + j % n_q) * kBwdN;
      const uint32_t full = bar_full + 8 * st;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * kTileBytes);
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          const uint32_t off = st * kTileBytes + c * kBwdN * kRowBytes;
          tma_load_4d(sQ + off, &tm_q, full, c * 64, h, q0, b);
          tma_load_4d(sO + off, &tm_do, full, c * 64, h, q0, b);
        }
      }
      // lane l stages rows 2l, 2l + 1 (rows past Sq read as zeros and
      // are masked by the consumer)
      const size_t row0 = ((size_t)b * num_heads + h) * Sq;
      const int qp = q0 + 2 * lane;
      float2 l2 = make_float2(0.f, 0.f), d2 = make_float2(0.f, 0.f);
      if (qp < Sq) {
        l2.x = lse[row0 + qp] * kLog2e;
        d2.x = delta[row0 + qp];
      }
      if (qp + 1 < Sq) {
        l2.y = lse[row0 + qp + 1] * kLog2e;
        d2.y = delta[row0 + qp + 1];
      }
      sLD[st][lane][0] = l2;
      sLD[st][lane][1] = d2;
      mbar_arrive(full);
    }
  } else {
    // ---------------------------------------------------------- consumer
    const int t = threadIdx.x;
    const int warp = t >> 5, lane = t & 31;
    const int cq = lane & 3;
    const int ra = 16 * warp + (lane >> 2);  // key rows ra, ra + 8 of the 64
    const int ka = k0 + ra, kb = ka + 8;

    float adk[HDP / 2], adv[HDP / 2];
    float s[kBwdN / 2], dp[kBwdN / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) adk[i] = adv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdN / 2; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(bar_kv, 0);

    for (int j = 0; j < n_items; ++j) {
      const int st = j % kBwdStages;
      mbar_wait(bar_full + 8 * st, (j / kBwdStages) & 1);
      const int q0 = (q_first + j % n_q) * kBwdN;
      const uint32_t q_base = sQ + st * kTileBytes;
      const uint32_t o_base = sO + st * kTileBytes;

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over the hd columns
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk / 4) * kBwdN * kRowBytes + (kk % 4) * 32;
        wgmma_ss_n64(s, desc_k_major(sK + col), desc_k_major(q_base + col),
                     kk > 0);
        wgmma_ss_n64(dp, desc_k_major(sV + col), desc_k_major(o_base + col),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);

      // Pᵀ and dSᵀ on the fragment (q along the columns), packed to bf16
      // as the A fragments of Pᵀ·dO and dSᵀ·Q
      const bool edge = k0 + kBwdN > Sk || q0 + kBwdN > Sq ||
                        (causal && k0 + kBwdN - 1 > q_off + q0) ||
                        (window > 0 && q_off + q0 + kBwdN - 1 >= k0 + window);
      uint32_t ap[kBwdN / 4], ad[kBwdN / 4];
#pragma unroll
      for (int i = 0; i < kBwdN / 8; ++i) {
        const float2 l2 = sLD[st][4 * i + cq][0];  // columns 8i + 2cq, +1
        const float2 d2 = sLD[st][4 * i + cq][1];
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          p[e] = ex2(fmaf(s[4 * i + e], scale_log2, -(odd ? l2.y : l2.x)));
          if (edge && !live(q0 + 8 * i + 2 * cq + odd, (e & 2) ? kb : ka, Sq,
                            Sk, q_off, causal, window))
            p[e] = 0.f;
          ds[e] = p[e] * (dp[4 * i + e] - (odd ? d2.y : d2.x)) * scale;
        }
        ap[2 * i] = pack_bf16(p[0], p[1]);
        ap[2 * i + 1] = pack_bf16(p[2], p[3]);
        ad[2 * i] = pack_bf16(ds[0], ds[1]);
        ad[2 * i + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dv += Pᵀ·dO, dk += dSᵀ·Q, dO and Q MN-major: 16 q rows (two
      // atoms) per k16 slice
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdN / 16; ++kk) {
        wgmma_rs<HDP>(adv, ap[4 * kk], ap[4 * kk + 1], ap[4 * kk + 2],
                      ap[4 * kk + 3],
                      desc_mn_major(o_base + kk * 2 * kAtomBytes,
                                    kBwdN * kRowBytes));
        wgmma_rs<HDP>(adk, ad[4 * kk], ad[4 * kk + 1], ad[4 * kk + 2],
                      ad[4 * kk + 3],
                      desc_mn_major(q_base + kk * 2 * kAtomBytes,
                                    kBwdN * kRowBytes));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(adv);
      fence_regs(adk);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // stage st is free
    }

    // epilogue through the K and V tiles
    const size_t out0 = (((size_t)b * Sk + k0) * num_kv_heads + kvh) * HD;
    const size_t stride = (size_t)num_kv_heads * HD;
    store_rows<HD, HDP>(adk, smem, kBwdN * kRowBytes, ra, cq, t, 1,
                        dk + out0, stride, Sk - k0);
    store_rows<HD, HDP>(adv, smem + kTileBytes, kBwdN * kRowBytes, ra, cq,
                        t, 1, dv + out0, stride, Sk - k0);
  }
}

// ------------------------------------------------------------------- host
template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, size_t smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *done = true;
  return e;
}

// the resident tiles (2 x BM rows) and the two-tensor ring
template <int HD, int NC>
constexpr size_t bwd_smem_bytes() {
  constexpr size_t hdp = HD == 64 ? 64 : 128;
  return kAtomBytes + 2 * (size_t)(64 * NC) * hdp * 2 +
         2 * (size_t)kBwdStages * kBwdN * hdp * 2;
}

// q, k, v, dO as the 4-D tensor maps of the two kernels (q, dO over Sq
// rows, k, v over Sk): the resident tensors in boxes of BM rows, the
// streamed ones in boxes of kBwdN rows
inline bool bwd_maps(CUtensorMap* tm, const void* q, const void* k,
                     const void* v, const void* dout, int hd, int batch,
                     int Sq, int Sk, int H, int KV, int q_rows,
                     int kv_rows) {
  return make_map(&tm[0], q, hd, H, Sq, batch, q_rows) &&
         make_map(&tm[1], k, hd, KV, Sk, batch, kv_rows) &&
         make_map(&tm[2], v, hd, KV, Sk, batch, kv_rows) &&
         make_map(&tm[3], dout, hd, H, Sq, batch, q_rows);
}

inline float bwd_scale(int hd) { return (float)(1.0 / sqrt((double)hd)); }
inline float bwd_scale_log2(int hd) {
  return (float)(1.0 / sqrt((double)hd) * 1.4426950408889634);
}

template <int HD, int NC>
cudaError_t launch_dq_nc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int batch, int Sq,
                         int Sk, int q_off, int H, int KV, int causal,
                         int window, cudaStream_t stream) {
  constexpr int BM = 64 * NC;
  constexpr size_t smem = bwd_smem_bytes<HD, NC>();
  static bool attr_set = false;
  cudaError_t e =
      raise_smem_once(flash_dq_tc_kernel<HD, NC>, smem, &attr_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tm[4];
  if (!bwd_maps(tm, q, k, v, dout, HD, batch, Sq, Sk, H, KV, BM, kBwdN))
    return cudaErrorInvalidValue;
  const int n_qt = (Sq + BM - 1) / BM;
  const long long blocks = (long long)n_qt * H * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_dq_tc_kernel<HD, NC><<<(unsigned)blocks, 128 * (NC + 1), smem,
                               stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse, delta,
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, q_off, H, KV, n_qt, causal,
      window, bwd_scale(HD), bwd_scale_log2(HD));
  return cudaGetLastError();
}

// dq: 128-row blocks (two consumers) when their grid fills the SMs,
// else 64-row blocks, as the forward chooses
template <int HD>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int batch, int Sq,
                         int Sk, int q_off, int H, int KV, int causal,
                         int window, cudaStream_t stream) {
  const long long tiles128 = (long long)((Sq + 127) / 128) * H * batch;
  if (tiles128 >= num_sms())
    return launch_dq_nc<HD, 2>(q, k, v, dout, lse, delta, dq, batch, Sq, Sk,
                               q_off, H, KV, causal, window, stream);
  return launch_dq_nc<HD, 1>(q, k, v, dout, lse, delta, dq, batch, Sq, Sk,
                             q_off, H, KV, causal, window, stream);
}

template <int HD, bool kOffset>
cudaError_t launch_dkv_off(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv,
                           int batch, int Sq, int Sk, int q_off, int H,
                           int KV, int causal, int window,
                           cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD, 1>();
  static bool attr_set = false;
  cudaError_t e = raise_smem_once(flash_dkv_tc_kernel<HD, kOffset>, smem,
                                  &attr_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tm[4];
  if (!bwd_maps(tm, q, k, v, dout, HD, batch, Sq, Sk, H, KV, kBwdN, kBwdN))
    return cudaErrorInvalidValue;
  const int n_kt = (Sk + kBwdN - 1) / kBwdN;
  const long long blocks = (long long)n_kt * KV * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_dkv_tc_kernel<HD, kOffset><<<(unsigned)blocks, 160, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Sk, q_off, H, KV, n_kt, causal, window, bwd_scale(HD),
      bwd_scale_log2(HD));
  return cudaGetLastError();
}

// dk/dv: always 64-key blocks of one consumer (see the kernel); the
// whole-sequence instance where there is no offset
template <int HD>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv, int batch,
                          int Sq, int Sk, int q_off, int H, int KV,
                          int causal, int window, cudaStream_t stream) {
  if (q_off == 0 && Sq == Sk)
    return launch_dkv_off<HD, false>(q, k, v, dout, lse, delta, dk, dv,
                                     batch, Sq, Sk, 0, H, KV, causal, window,
                                     stream);
  return launch_dkv_off<HD, true>(q, k, v, dout, lse, delta, dk, dv, batch,
                                  Sq, Sk, q_off, H, KV, causal, window,
                                  stream);
}

}  // namespace flash_tc
