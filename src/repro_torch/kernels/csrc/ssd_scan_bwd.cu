// Backward of the Mamba2 SSD chunk scan (state-space duality,
// arXiv:2405.21060) for Hopper (sm_90a), on f32-accurate 3xTF32
// tensor-core products.
//
// Replaces no Pallas kernel: the JAX model differentiates its jnp scan
// (src/repro/models/ssm.py :: ssd_chunked) by autodiff, and the Pallas
// scan (src/repro/kernels/ssd_scan.py :: ssd_scan) has no backward.  The
// port's forward is a hand-written kernel (csrc/ssd_scan.cu) that autograd
// cannot see through, so this kernel is its gradient:
//   x [b,s,nh,hd], dt [b,s,nh] (post-softplus), A [nh] (negative),
//   B, C [b,s,ds] (one group, shared by every head), init_state
//   [b,nh,hd,ds] or null (zeros), dy [b,s,nh,hd], dfinal [b,nh,hd,ds] or
//   null (zeros), all float32
//   -> dx [b,s,nh,hd], dinit [b,nh,hd,ds], and partials the wrapper sums
//      in a fixed order: ddt [slices,b,s,nh], dA [slices,b,nh], dB and dC
//      [b,s,nh/group,ds] (one per cluster: see below).
// Any s >= 1 (the ragged last chunk is zero-filled: dt 0, and nothing is
// read or written past s), hd <= 64, ds <= 128.
//
// Per head and 32-row chunk (c = running sum of a = dt·A inside the
// chunk, L its last row, u_j = dt_j x_j, S the [hd, ds] state before the
// chunk, dS' the gradient of the state after it), walking the chunks in
// reverse from dS' = dfinal:
//   du_j  = Σ_{i>=j} (C_i·B_j) e^{c_i−c_j} dy_i + e^{c_L−c_j} dS' B_j
//   dC_i  = Σ_{j<=i} e^{c_i−c_j} (dy_i·u_j) B_j + e^{c_i} Sᵀ dy_i
//   dB_j  = Σ_{i>=j} e^{c_i−c_j} (dy_i·u_j) C_i + e^{c_L−c_j} dS'ᵀ u_j
//   dS    = e^{c_L} dS' + Σ_i e^{c_i} dy_i ⊗ C_i      (carried back)
//   dc_i  = Σ_{j<i} w_ij − Σ_{k>i} w_ki + e^{c_i} dy_i·(S C_i)
//           − e^{c_L−c_i} u_i·(dS' B_i)
//           + [i = L] (e^{c_L} <dS', S> + Σ_j e^{c_L−c_j} u_j·(dS' B_j)),
//           w_ij = (C_i·B_j) e^{c_i−c_j} (dy_i·u_j)
//   da_k  = Σ_{i>=k} dc_i;  dx = dt du;  ddt = x·du + A da;  dA = Σ dt da.
// Exponentials are taken on the causal side only (j <= i, and c_L − c_j,
// c_i <= 0 since A < 0), so none overflows and none is masked after the
// fact.  A padded row (past s) has dt 0, x 0, B 0, C 0 and dy 0: every
// term it would add is 0, and e^{c_L} equals e^{c} at the last real row.
//
// What bounds it on the card: operations.  Per head and chunk of n rows:
// the tile dy·uᵀ (2n²·hd), the tiles' products with dy, B and C (2n²·hd +
// 4n²·ds), five n x hd x ds products (the recomputed state, dS'·B, Sᵀ·dy,
// dS'ᵀ·u and the carried dS: 10n·hd·ds), and C·Bᵀ once per batch row and
// chunk (2n²·ds): 3.41 MFLOP a head and chunk at hd 64 / ds 128, 41.9
// GFLOP at Mamba2-780M's B4 S2048 (nh 48), 30.1 at Zamba2-1.2B's (nh 64,
// ds 64) (chip_smoke.py :: ssd_bwd_flops): 0.63 / 0.45 ms at the f32
// CUDA-core peak, 0.25 / 0.18 ms at the 3xTF32 rate (495/3 TFLOP/s).
//
// The design, and what it answers in the kernel it replaces (PR 26: one
// 256-thread block per (batch, head), f32 FMAs on operands loaded from
// shared memory, ~138 KB of shared memory so one block an SM, C·Bᵀ per
// head, per-head dB and dC partials):
//   * every product on the tensor cores at f32 accuracy: 3xTF32
//     mma.sync.m16n8k8 as K4 splits it (csrc/ssd_tc.cuh: hi = a truncated
//     to TF32, lo = a − hi rounded; lo·hi + hi·lo + hi·hi in f32).  The
//     tiles that feed dc (dy·uᵀ, C·Bᵀ) too: emulated on the CPU, 3xTF32
//     everywhere stays within 1e-5 of each gradient's max of the float64
//     truth at Mamba2's and Zamba2's widths over 2048 rows, where one
//     TF32 pass is ~5e-4 off (tests/test_torch_ssd_bwd_tc.py).
//   * more blocks in flight: every term that sums over hd (dc and through
//     it da, ddt, dA; dB, dC) is linear in the columns, so a block owns
//     (batch, head, SSD_BWD_COLS columns of hd) and writes partials of
//     those; four warps, 109 KB of shared memory at ds 128 (69 KB at ds
//     64) and 224-255 registers a thread, two blocks an SM.  Each warp
//     owns a quarter of the state columns of the carried dS (mma
//     accumulators for the whole sequence), of dB and of dC.  16-column
//     blocks measured 1.4-1.6x slower (tools/ssd_variants.py --bwd).
//   * C·Bᵀ once per (batch, chunk): ssd_cb_kernel (csrc/ssd_tc.cuh, K4's)
//     writes it to a workspace [b, nc, 32, 32] every head reads.
//   * the states before each chunk: a first launch walks the chunks
//     forward, (batch, head, column slice) a block with the state slice
//     in mma accumulators as K4 carries it, and writes each state to a
//     float32 workspace [b, nc, nh, hd, ds] (402 MB at Mamba2-780M's B4
//     S2048, written once and read once: 0.24 ms at 3.35 TB/s; on an H100
//     this launch and C·Bᵀ take 0.30 ms there, and copying three chunks
//     ahead instead of one changed nothing, tools/ssd_variants.py --bwd);
//     the reverse launch loads the chunk's slice straight into B-fragment
//     registers one chunk ahead.
//   * fewer partial bytes: the blocks of one batch row's `slices` column
//     slices and `group` heads form a thread-block cluster; after each
//     chunk every block leaves its dC and dB partial tiles in its shared
//     memory and each block sums its share of the rows over the cluster's
//     blocks, in rank order, four ranks' loads in flight at once, through
//     distributed shared memory, so the dB and dC partials are [b, s,
//     nh/group, ds] (50 MB each at Mamba2 B4 with group 4; PR 26 wrote
//     201 MB each, one per head).  The wrapper picks the group that runs
//     the launch in the fewest rounds of the clusters the card holds at
//     once (ssd_scan.py cuda_bwd_plan): at Zamba2's B4 S2048, 64 clusters
//     of 8 blocks need three rounds of 30 and 256 of 2 two rounds of 132.
//   * staged ahead: B, C, C·Bᵀ and dt of chunk c−1 come by cp.async into
//     the other of two stages once the cluster has read the partials it
//     held (early in chunk c); x and dy (one stage) as soon as chunk c has
//     read them; the S fragments by plain loads into registers at the same
//     point.  Each cluster barrier is split into arrive and wait, with
//     work between.
// No atomics: every output and partial is bitwise repeatable run to run.
#include <cooperative_groups.h>

#include "ssd_tc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBwdThreads = 128;   // four warps, in both launches
// The columns of hd a block owns (16 or 32; ssd_scan.py BWD_SLICE).  32
// is the build; tools/ssd_variants.py --bwd builds 16 to time the plans.
#ifndef SSD_BWD_COLS
#define SSD_BWD_COLS 32
#endif
constexpr int kP = SSD_BWD_COLS;
static_assert(kP == 16 || kP == 32, "16 or 32 columns");
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
// the sum over the four lanes of a quad (lane % 4), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
// two consecutive columns n, n+1 of a row of width w (even: one 8-byte
// store)
__device__ __forceinline__ void store_pair(float* p, float v0, float v1,
                                           int n, int w) {
  if ((w & 1) == 0 && n + 1 < w) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (n < w) p[0] = v0;
    if (n + 1 < w) p[1] = v1;
  }
}
// the two halves of a cluster barrier (every thread of every block of the
// cluster): arrive releases this thread's shared-memory writes and reads,
// wait returns once every thread has arrived and acquires theirs
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this block's shared `p` in the block of cluster rank
// `rank`, and a 16-byte load from there (distributed shared memory)
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
// per row (lane = row) of a 32-row chunk, dt·A in log2 units: the running
// sum cum (an inclusive shuffle scan)
__device__ __forceinline__ float chunk_cumsum(float dtl, float a2,
                                              int lane) {
  float cum = dtl * a2;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, cum, o);
    if (lane >= o) cum += v;
  }
  return cum;
}

// mma accumulator tiles a[m][t] (rows 16m + g (+8), columns col0 + 8t +
// 2q (+1)) into shared rows of pitch `pitch`
template <int M, int NT>
__device__ __forceinline__ void put_tiles(float* dst, int pitch,
                                          const float (&a)[M][NT][4],
                                          int col0, int g, int q) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(dst + (16 * m + g + 8 * hf) * pitch +
                                   col0 + 8 * t + 2 * q) =
            make_float2(a[m][t][2 * hf], a[m][t][2 * hf + 1]);
}
// rows p0 + 8ks + q (+4) and columns d0 + 8t + g of a [HD, DS] state as
// the B fragments (k = row, n = column) of a product over the rows
template <int KS, int NT>
__device__ __forceinline__ void load_state_frags(float (&sf)[KS][NT][2],
                                                 const float* sp, int p0,
                                                 int d0, int g, int q, int HD,
                                                 int DS) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = p0 + 8 * ks + q + 4 * e, d = d0 + 8 * t + g;
        sf[ks][t][e] =
            p < HD && d < DS ? __ldg(sp + (size_t)p * DS + d) : 0.f;
      }
}

// --------------------------------------------- launch 2: the states
// Shared memory of a state block: two stages of (B, x slice, dt).
template <int DSP>
struct StateSmem {
  static constexpr int XP = kP + 8, BP = DSP + 8;
  static constexpr size_t kB = sizeof(float) * kQ * BP;
  static constexpr size_t kX = sizeof(float) * kQ * XP;
  static constexpr size_t kDt = sizeof(float) * kQ;
  static constexpr size_t kStage = kB + kX + kDt;
  static constexpr size_t kBytes = 2 * kStage;
};

// grid (slices, nh, b), four warps.  Block (slice, h, b) carries the state
// slice S[kP·slice .. +kP, :] of head h forward through the chunks, as
// K4's scan carries it (warp w: 16 columns of the slice by DSP/NG state
// columns, in mma accumulators), and writes the state before each chunk
// to states [b, nc, nh, hd, ds].  The last chunk's update is never needed.
template <int DSP>
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ init,
                     float* __restrict__ states, int S, int NH, int HD,
                     int DS, int vec) {
  using L = StateSmem<DSP>;
  constexpr int XP = L::XP, BP = L::BP;
  constexpr int PT = kP / 16, NG = 4 / PT, NT = DSP / (8 * NG);
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pw = 16 * (warp % PT), nw = (warp / PT) * DSP / NG;
  const int p0 = slice * kP;
  const int nc = (S + kQ - 1) / kQ;
  extern __shared__ __align__(16) unsigned char smem[];
  auto sB = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage);
  };
  auto sX = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + L::kB);
  };
  auto sDt = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + L::kB + L::kX);
  };
  const float a2 = A[h] * kLog2e;
  auto stage = [&](int c, int st) {
    const int r0 = c * kQ, nrows = min(kQ, S - r0);
    const size_t row = (size_t)b * S + r0;
    stage_rows<float, kP, XP, kBwdThreads>(
        sX(st), x + (row * NH + h) * HD + p0, (size_t)NH * HD, nrows,
        min(kP, HD - p0), vec != 0, tid);
    stage_rows<float, DSP, BP, kBwdThreads>(sB(st), Bm + row * DS, DS, nrows,
                                            DS, vec != 0, tid);
    if (tid < kQ)
      cp_async4(sDt(st) + tid, tid < nrows ? dt + (row + tid) * NH + h : dt,
                tid < nrows ? 4 : 0);
  };

  // the state tile: rows p0 + pw + g (+8), columns nw + 8t + 2q (+1)
  const size_t head = ((size_t)b * NH + h) * HD;
  float st[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pw + g + 8 * (e >> 1);
      const int n = nw + 8 * t + 2 * q + (e & 1);
      st[t][e] = (init != nullptr && p < HD && n < DS)
                     ? init[(head + p) * DS + n]
                     : 0.f;
    }
  if (nc > 1) stage(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    float* out = states + (((size_t)b * nc + c) * NH + h) * (size_t)HD * DS;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = p0 + pw + g + 8 * hf, n = nw + 8 * t + 2 * q;
        if (p < HD)
          store_pair(out + (size_t)p * DS + n, st[t][2 * hf],
                     st[t][2 * hf + 1], n, DS);
      }
    if (c == nc - 1) break;
    if (c + 1 < nc - 1) stage(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int sg = c & 1;
    const float* cB = sB(sg);
    const float* cX = sX(sg);
    const float dtl = sDt(sg)[lane];
    const float cum = chunk_cumsum(dtl, a2, lane);
    const float cum_last = __shfl_sync(kFull, cum, 31);
    const float w_out = dtl * exp2f(cum_last - cum);
    const float decay = exp2f(cum_last);
    // S = exp(cum_last) S + Σ_j (x_j dt_j exp(cum_last − cum_j)) ⊗ B_j
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] *= decay;
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const int j0 = 8 * ks + q, j1 = j0 + 4;
      const float w0 = __shfl_sync(kFull, w_out, j0);
      const float w1 = __shfl_sync(kFull, w_out, j1);
      const AFrag af(cX[j0 * XP + pw + g] * w0, cX[j0 * XP + pw + g + 8] * w0,
                     cX[j1 * XP + pw + g] * w1,
                     cX[j1 * XP + pw + g + 8] * w1);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = nw + 8 * t + g;
        mma3(st[t], af, BFrag(cB[j0 * BP + n], cB[j1 * BP + n]));
      }
    }
    __syncthreads();   // the stage is refilled next
  }
}

// --------------------------------------- launch 3: the chunks in reverse
// Shared memory of a chunk block: two stages of (B, C, C·Bᵀ, dt), one of
// (x, dy), then dS' (the gradient of the state after the chunk, for the
// products that read it across warps), the tile P, and the row partials.
// After a chunk, its stage's B and C rows hold the block's dC and dB
// partial tiles (64 rows) for the cluster to sum.
template <int DSP>
struct ChunkSmem {
  static constexpr int BP = DSP + 8;   // B, C, dS' and the partial rows
  static constexpr int XP = kP + 4;    // x and dy rows
  static constexpr int TP = kQ + 4;    // C·Bᵀ and P rows
  static constexpr size_t kB = sizeof(float) * kQ * BP;
  static constexpr size_t kT = sizeof(float) * kQ * TP;
  static constexpr size_t kDt = sizeof(float) * kQ;
  static constexpr size_t kStage = 2 * kB + kT + kDt;
  static constexpr size_t kX = sizeof(float) * kQ * XP;
  static constexpr size_t kDS = sizeof(float) * kP * BP;
  // r [4 warps][32], q and x·du [2 column halves][32], <dS', S> [4]
  static constexpr size_t kRed = sizeof(float) * (4 * kQ + 4 * kQ + 4 + 12);
  static constexpr size_t kBytes = 2 * kStage + 2 * kX + kDS + kT + kRed;
  static_assert(kB % 16 == 0 && kT % 16 == 0 && kX % 16 == 0 &&
                    kDS % 16 == 0 && kRed % 16 == 0,
                "16-byte aligned regions");
};

// grid (slices, nh, b), four warps, clusters of (slices, group, 1): the
// column slices of `group` heads of one batch row.  Block (slice, h, b)
// owns columns [kP·slice, kP·slice + kP) of head h.  Warp w owns state
// columns [w·DSP/4, (w+1)·DSP/4) of the carried dS (rows: the slice's
// columns), of dB and dC (rows: the chunk's 32), and of the products that
// feed them; and a 16-row by kP/2-column tile of du (row tile w / 2,
// column half w % 2) and of dy·uᵀ (row tile w / 2, j columns 16(w % 2)..).
template <int DSP>
__global__ void __launch_bounds__(kBwdThreads, 2)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ cb,
                     const float* __restrict__ states,
                     const float* __restrict__ dy,
                     const float* __restrict__ dfinal, float* __restrict__ dx,
                     float* __restrict__ ddt_part, float* __restrict__ dA_part,
                     float* __restrict__ dB_part, float* __restrict__ dC_part,
                     float* __restrict__ dinit, int S, int NH, int HD, int DS,
                     int group, int vec) {
  using L = ChunkSmem<DSP>;
  constexpr int BP = L::BP, XP = L::XP, TP = L::TP;
  constexpr int MP = kP / 16;     // m16 row tiles of the slice (dS rows)
  constexpr int NTD = DSP / 32;   // n8 tiles of a warp's state columns
  constexpr int NTW = kP / 16;    // n8 tiles of du a warp owns
  constexpr int KP = kP / 8;      // k steps over the slice's columns
  cg::cluster_group cluster = cg::this_cluster();
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int d0 = warp * (DSP / 4);   // the warp's first state column
  const int mw = warp >> 1;          // the warp's row tile of du, dy·uᵀ
  const int half = warp & 1;         // ... and its column half
  const int p0 = slice * kP;
  const int nc = (S + kQ - 1) / kQ;
  const bool vec_ok = vec != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  auto sB = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage);
  };
  auto sC = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + L::kB);
  };
  auto sCB = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + 2 * L::kB);
  };
  auto sDt = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + 2 * L::kB +
                                    L::kT);
  };
  unsigned char* rest = smem + 2 * L::kStage;
  float* sX = reinterpret_cast<float*>(rest);
  float* sDy = reinterpret_cast<float*>(rest + L::kX);
  float* sDS = reinterpret_cast<float*>(rest + 2 * L::kX);
  float* sP = reinterpret_cast<float*>(rest + 2 * L::kX + L::kDS);
  float* sR = reinterpret_cast<float*>(rest + 2 * L::kX + L::kDS + L::kT);
  float* sQv = sR + 4 * kQ;       // [2][32]
  float* sXdu = sQv + 2 * kQ;     // [2][32]
  float* sDot = sXdu + 2 * kQ;    // [4]
  const float Ah = A[h], a2 = Ah * kLog2e;
  const size_t head = ((size_t)b * NH + h) * HD;
  const size_t hds = (size_t)HD * DS;

  auto stage_bc = [&](int c, int st) {   // B, C, C·Bᵀ, dt of chunk c
    const int r0 = c * kQ, nrows = min(kQ, S - r0);
    const size_t row = (size_t)b * S + r0;
    stage_rows<float, DSP, BP, kBwdThreads>(sB(st), Bm + row * DS, DS, nrows,
                                            DS, vec_ok, tid);
    stage_rows<float, DSP, BP, kBwdThreads>(sC(st), Cm + row * DS, DS, nrows,
                                            DS, vec_ok, tid);
    stage_rows<float, kQ, TP, kBwdThreads>(
        sCB(st), cb + ((size_t)b * nc + c) * kQ * kQ, kQ, kQ, kQ, true, tid);
    if (tid < kQ)
      cp_async4(sDt(st) + tid, tid < nrows ? dt + (row + tid) * NH + h : dt,
                tid < nrows ? 4 : 0);
  };
  auto stage_x = [&](int c) {            // the x and dy slices of chunk c
    const int r0 = c * kQ, nrows = min(kQ, S - r0);
    const size_t off = (((size_t)b * S + r0) * NH + h) * HD + p0;
    const int cols = min(kP, HD - p0);
    stage_rows<float, kP, XP, kBwdThreads>(sX, x + off, (size_t)NH * HD,
                                           nrows, cols, vec_ok, tid);
    stage_rows<float, kP, XP, kBwdThreads>(sDy, dy + off, (size_t)NH * HD,
                                           nrows, cols, vec_ok, tid);
  };
  // S[p][d] as the B fragments of Sᵀ·dy: k p = 8ks + q (+4), n d = d0 +
  // 8t + g; a warp reads its own state columns only
  float sf[KP][NTD][2];
  auto states_at = [&](int c) {
    return states + (((size_t)b * nc + c) * NH + h) * hds;
  };
  // the carried dS: rows (slice columns) 16m + g (+8), state columns d0 +
  // 8t + 2q (+1)
  float dS[MP][NTD][4];
#pragma unroll
  for (int m = 0; m < MP; ++m)
#pragma unroll
    for (int t = 0; t < NTD; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * m + g + 8 * (e >> 1);
        const int d = d0 + 8 * t + 2 * q + (e & 1);
        dS[m][t][e] = dfinal != nullptr && p < HD && d < DS
                          ? dfinal[(head + p) * DS + d]
                          : 0.f;
      }
  stage_bc(nc - 1, (nc - 1) & 1);
  stage_x(nc - 1);
  cp_async_commit();
  load_state_frags(sf, states_at(nc - 1), p0, d0, g, q, HD, DS);
  put_tiles(sDS, BP, dS, d0, g, q);
  float dA_acc = 0.f;   // warp 0, lane = row
  cluster_arrive();     // the other stage is free
  for (int n = nc - 1; n >= 0; --n) {
    const int sg = n & 1, chunk0 = n * kQ;
    cp_async_wait<0>();   // this chunk's stage, x and dy
    __syncthreads();
    const float* cB = sB(sg);
    const float* cC = sC(sg);
    const float* cCB = sCB(sg);
    // per row (lane = row): cum in log2 units, e^{c_i}, e^{c_L − c_i}
    const float dtl = sDt(sg)[lane];
    const float cum = chunk_cumsum(dtl, a2, lane);
    const float cum_last = __shfl_sync(kFull, cum, 31);
    const float eCl = exp2f(cum), eLl = exp2f(cum_last - cum);
    const float decay = exp2f(cum_last);

    // ---- dC = e^{c_i} Sᵀ dy_i over the warp's state columns; r_i = C_i ·
    // Sᵀ dy_i and <dS', S> over them
    float dC[2][NTD][4] = {};
#pragma unroll
    for (int ks = 0; ks < KP; ++ks) {
      BFrag bs[NTD];
#pragma unroll
      for (int t = 0; t < NTD; ++t) bs[t] = BFrag(sf[ks][t][0], sf[ks][t][1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* r = sDy + (16 * m + g) * XP + 8 * ks + q;
        const AFrag af(r[0], r[8 * XP], r[4], r[8 * XP + 4]);
#pragma unroll
        for (int t = 0; t < NTD; ++t) mma3(dC[m][t], af, bs[t]);
      }
    }
    {
      float dot = 0.f;
#pragma unroll
      for (int ks = 0; ks < KP; ++ks)
#pragma unroll
        for (int t = 0; t < NTD; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dot = fmaf(sf[ks][t][e],
                       sDS[(8 * ks + q + 4 * e) * BP + d0 + 8 * t + g], dot);
      dot = warp_sum(dot);
      if (lane == 0) sDot[warp] = dot;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * m + g + 8 * hf;
          float rp = 0.f;
#pragma unroll
          for (int t = 0; t < NTD; ++t) {
            const float2 c2 = load2(cC + i * BP + d0 + 8 * t + 2 * q);
            rp = fmaf(c2.x, dC[m][t][2 * hf], rp);
            rp = fmaf(c2.y, dC[m][t][2 * hf + 1], rp);
          }
          rp = quad_sum(rp);
          if (q == 0) sR[warp * kQ + i] = rp;
          const float e = __shfl_sync(kFull, eCl, i);
#pragma unroll
          for (int t = 0; t < NTD; ++t) {
            dC[m][t][2 * hf] *= e;
            dC[m][t][2 * hf + 1] *= e;
          }
        }
    }

    // every block of the cluster has read its partials out of the other
    // stage (the previous chunk's): refill it with chunk n − 1
    cluster_wait();
    if (n > 0) stage_bc(n - 1, sg ^ 1);
    cp_async_commit();

    // ---- P = (dy·uᵀ) ∘ e^{c_i − c_j} over j <= i, into shared memory:
    // rows 16 mw + g (+8), j columns 16 half + 8k + 2q (+1)
    {
      float acc[2][4] = {};
      const bool above = mw == 0 && half == 1;   // every j > i
      if (!above) {
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) {
          const float* r = sDy + (16 * mw + g) * XP + 8 * ks + q;
          const AFrag af(r[0], r[8 * XP], r[4], r[8 * XP + 4]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int j = 16 * half + 8 * k + g;
            const float dj = __shfl_sync(kFull, dtl, j);
            const float* xr = sX + j * XP + 8 * ks + q;
            mma3(acc[k], af, BFrag(xr[0] * dj, xr[4] * dj));
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mw + g + 8 * hf;
        const float ci = __shfl_sync(kFull, cum, i);
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * half + 8 * k + 2 * q + e;
            const float cj = __shfl_sync(kFull, cum, j);
            sP[i * TP + j] =
                j <= i ? acc[k][2 * hf + e] * exp2f(ci - cj) : 0.f;
          }
      }
    }
    __syncthreads();   // P and dS' in shared memory

    // ---- du = e^{c_L − c_j} B_j·dS'ᵀ + Σ_{i>=j} M_ij dy_i (M = C·Bᵀ ∘
    // e^{c_i − c_j}); dx = dt du; q_j = u_j · (B_j·dS'ᵀ); x_j · du_j.
    // Rows j = 16 mw + g (+8), columns 8n + 2q (+1), n = NTW·half + k.
    {
      float du[NTW][4] = {};
#pragma unroll
      for (int ks = 0; ks < DSP / 8; ++ks) {
        // k (a state column) permuted: k q -> 2q, k q+4 -> 2q+1
        const float2 b0 = load2(cB + (16 * mw + g) * BP + 8 * ks + 2 * q);
        const float2 b1 = load2(cB + (16 * mw + g + 8) * BP + 8 * ks + 2 * q);
        const AFrag af(b0.x, b1.x, b0.y, b1.y);
#pragma unroll
        for (int k = 0; k < NTW; ++k) {
          const int n = NTW * half + k;
          const float2 s = load2(sDS + (8 * n + g) * BP + 8 * ks + 2 * q);
          mma3(du[k], af, BFrag(s.x, s.y));
        }
      }
      float qp[2] = {}, xp[2] = {};
      float djs[2], eLs[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 16 * mw + g + 8 * hf;
        djs[hf] = __shfl_sync(kFull, dtl, j);
        eLs[hf] = __shfl_sync(kFull, eLl, j);
#pragma unroll
        for (int k = 0; k < NTW; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 8 * (NTW * half + k) + 2 * q + e;
            qp[hf] = fmaf(sX[j * XP + p] * djs[hf], du[k][2 * hf + e], qp[hf]);
            du[k][2 * hf + e] *= eLs[hf];
          }
      }
      const float cj0 = __shfl_sync(kFull, cum, 16 * mw + g);
      const float cj1 = __shfl_sync(kFull, cum, 16 * mw + g + 8);
#pragma unroll
      for (int ks = 0; ks < kQ / 8; ++ks) {
        if (8 * ks + 7 < 16 * mw) continue;   // every i < j
        const int i0 = 8 * ks + q, i1 = i0 + 4;
        const int j0 = 16 * mw + g, j1 = j0 + 8;
        const float ci0 = __shfl_sync(kFull, cum, i0);
        const float ci1 = __shfl_sync(kFull, cum, i1);
        // Mᵀ: rows j, k i
        const AFrag af(
            j0 <= i0 ? cCB[i0 * TP + j0] * exp2f(ci0 - cj0) : 0.f,
            j1 <= i0 ? cCB[i0 * TP + j1] * exp2f(ci0 - cj1) : 0.f,
            j0 <= i1 ? cCB[i1 * TP + j0] * exp2f(ci1 - cj0) : 0.f,
            j1 <= i1 ? cCB[i1 * TP + j1] * exp2f(ci1 - cj1) : 0.f);
#pragma unroll
        for (int k = 0; k < NTW; ++k) {
          const int col = 8 * (NTW * half + k) + g;
          mma3(du[k], af, BFrag(sDy[i0 * XP + col], sDy[i1 * XP + col]));
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 16 * mw + g + 8 * hf, t = chunk0 + j;
#pragma unroll
        for (int k = 0; k < NTW; ++k) {
          const int p = 8 * (NTW * half + k) + 2 * q;
          const float v0 = du[k][2 * hf], v1 = du[k][2 * hf + 1];
          xp[hf] = fmaf(sX[j * XP + p], v0, xp[hf]);
          xp[hf] = fmaf(sX[j * XP + p + 1], v1, xp[hf]);
          if (t < S && p0 + p < HD)
            store_pair(dx + (((size_t)b * S + t) * NH + h) * HD + p0 + p,
                       djs[hf] * v0, djs[hf] * v1, p0 + p, HD);
        }
        const float qs = quad_sum(qp[hf]), xs = quad_sum(xp[hf]);
        if (q == 0) {
          sQv[half * kQ + j] = qs;
          sXdu[half * kQ + j] = xs;
        }
      }
    }

    // ---- dB = e^{c_L − c_j} dS'ᵀ u_j + Σ_{i>=j} P_ij C_i; dC += Σ_{j<=i}
    // P_ij B_j; dS = e^{c_L} dS' + Σ_i e^{c_i} dy_i ⊗ C_i.  Rows 16m + g
    // (+8), the warp's state columns d0 + 8t + 2q (+1).
    float dB[2][NTD][4] = {};
#pragma unroll
    for (int ks = 0; ks < KP; ++ks) {
      BFrag bs[NTD];
#pragma unroll
      for (int t = 0; t < NTD; ++t) {
        const float* r = sDS + (8 * ks + q) * BP + d0 + 8 * t + g;
        bs[t] = BFrag(r[0], r[4 * BP]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int j0 = 16 * m + g;
        const float u0 = __shfl_sync(kFull, dtl, j0);
        const float u1 = __shfl_sync(kFull, dtl, j0 + 8);
        const float* r = sX + j0 * XP + 8 * ks + q;
        const AFrag af(r[0] * u0, r[8 * XP] * u1, r[4] * u0,
                       r[8 * XP + 4] * u1);
#pragma unroll
        for (int t = 0; t < NTD; ++t) mma3(dB[m][t], af, bs[t]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float e = __shfl_sync(kFull, eLl, 16 * m + g + 8 * hf);
#pragma unroll
        for (int t = 0; t < NTD; ++t) {
          dB[m][t][2 * hf] *= e;
          dB[m][t][2 * hf + 1] *= e;
        }
      }
#pragma unroll
    for (int t = 0; t < NTD; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 0; m < MP; ++m) dS[m][t][e] *= decay;
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const int i0 = 8 * ks + q, i1 = i0 + 4;
      BFrag bc[NTD], bb[NTD];
#pragma unroll
      for (int t = 0; t < NTD; ++t) {
        const int col = d0 + 8 * t + g;
        bc[t] = BFrag(cC[i0 * BP + col], cC[i1 * BP + col]);
        bb[t] = BFrag(cB[i0 * BP + col], cB[i1 * BP + col]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r0 = 16 * m + g;
        if (8 * ks + 7 >= 16 * m) {   // Pᵀ: rows j, k i >= j
          const AFrag af(sP[i0 * TP + r0], sP[i0 * TP + r0 + 8],
                         sP[i1 * TP + r0], sP[i1 * TP + r0 + 8]);
#pragma unroll
          for (int t = 0; t < NTD; ++t) mma3(dB[m][t], af, bc[t]);
        }
        if (8 * ks <= 16 * m + 15) {  // P: rows i, k j <= i
          const AFrag af(sP[r0 * TP + i0], sP[(r0 + 8) * TP + i0],
                         sP[r0 * TP + i1], sP[(r0 + 8) * TP + i1]);
#pragma unroll
          for (int t = 0; t < NTD; ++t) mma3(dC[m][t], af, bb[t]);
        }
      }
      const float e0 = __shfl_sync(kFull, eCl, i0);
      const float e1 = __shfl_sync(kFull, eCl, i1);
#pragma unroll
      for (int m = 0; m < MP; ++m) {   // (e^{c_i} dy_i)ᵀ: rows p, k i
        const int pc = 16 * m + g;
        const AFrag af(sDy[i0 * XP + pc] * e0, sDy[i0 * XP + pc + 8] * e0,
                       sDy[i1 * XP + pc] * e1, sDy[i1 * XP + pc + 8] * e1);
#pragma unroll
        for (int t = 0; t < NTD; ++t) mma3(dS[m][t], af, bc[t]);
      }
    }
    __syncthreads();   // every read of B, C, x, dy and dS' is done

    // ---- hand over: dC rows 0-31, dB rows 32-63 into this stage's B and
    // C rows; the next chunk's x, dy, S fragments and dS' on their way
    put_tiles(sB(sg), BP, dC, d0, g, q);
    put_tiles(sB(sg) + kQ * BP, BP, dB, d0, g, q);
    cluster_arrive();
    if (n > 0) {
      stage_x(n - 1);
      load_state_frags(sf, states_at(n - 1), p0, d0, g, q, HD, DS);
    }
    cp_async_commit();

    // ---- dc, its suffix sums da, ddt and dA (warp 0, lane = row); w_ij
    // = (C·Bᵀ)_ij P_ij
    if (warp == 0) {
      const int i = lane, t = chunk0 + i;
      float wr = 0.f, wc = 0.f;
      for (int j = 0; j < i; ++j)
        wr = fmaf(cCB[i * TP + j], sP[i * TP + j], wr);
      for (int k = i + 1; k < kQ; ++k)
        wc = fmaf(cCB[k * TP + i], sP[k * TP + i], wc);
      const float r = ((sR[i] + sR[kQ + i]) + sR[2 * kQ + i]) + sR[3 * kQ + i];
      const float qv = sQv[i] + sQv[kQ + i];
      const float xd = sXdu[i] + sXdu[kQ + i];
      const float dot = ((sDot[0] + sDot[1]) + sDot[2]) + sDot[3];
      const float lq = eLl * qv;
      float dc = wr - wc + eCl * r - lq;
      const float tot = warp_sum(lq);
      if (i == kQ - 1) dc += decay * dot + tot;
      float da = dc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nbv = __shfl_down_sync(kFull, da, o);
        if (lane + o < 32) da += nbv;
      }
      if (t < S)
        ddt_part[(((size_t)slice * nb + b) * S + t) * NH + h] =
            fmaf(Ah, da, xd);
      dA_acc = fmaf(dtl, da, dA_acc);
    }
    put_tiles(sDS, BP, dS, d0, g, q);   // dS' of chunk n − 1

    // ---- the cluster's dC and dB partials: this block sums its share of
    // the 64 rows over the cluster's blocks, in rank order, four ranks'
    // pieces in flight at once
    cluster_wait();
    {
      const int R = (int)cluster.num_blocks();
      const int rank = (int)cluster.block_rank();
      const int per = (2 * kQ + R - 1) / R;
      const int rlo = rank * per, rhi = min(2 * kQ, rlo + per);
      const int hg = h / group, nhg = NH / group;
      constexpr int V = DSP / 4;   // 16-byte pieces a row
      for (int e = tid; e < (rhi - rlo) * V; e += kBwdThreads) {
        const int row = rlo + e / V, c4 = 4 * (e % V);
        const int i = row & (kQ - 1), t = chunk0 + i;
        const float* mine = sB(sg) + row * BP + c4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k0 = 0; k0 < kMaxCluster; k0 += 4) {
          float4 w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k0 + k < R) w[k] = ld_cluster4(cluster_addr(mine, k0 + k));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k0 + k < R) {
              v.x = k0 + k == 0 ? w[k].x : v.x + w[k].x;
              v.y = k0 + k == 0 ? w[k].y : v.y + w[k].y;
              v.z = k0 + k == 0 ? w[k].z : v.z + w[k].z;
              v.w = k0 + k == 0 ? w[k].w : v.w + w[k].w;
            }
        }
        if (t < S && c4 < DS) {
          float* out = (row < kQ ? dC_part : dB_part) +
                       (((size_t)b * S + t) * nhg + hg) * DS + c4;
          if ((DS & 3) == 0) {
            *reinterpret_cast<float4*>(out) = v;
          } else {
            out[0] = v.x;
            if (c4 + 1 < DS) out[1] = v.y;
            if (c4 + 2 < DS) out[2] = v.z;
            if (c4 + 3 < DS) out[3] = v.w;
          }
        }
      }
    }
    cluster_arrive();   // this block has read the partials: that stage is free
  }
  cluster_wait();       // no block leaves while another reads its partials

  if (dinit != nullptr)
#pragma unroll
    for (int m = 0; m < MP; ++m)
#pragma unroll
      for (int t = 0; t < NTD; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + 16 * m + g + 8 * hf, d = d0 + 8 * t + 2 * q;
          if (p < HD)
            store_pair(dinit + (head + p) * DS + d, dS[m][t][2 * hf],
                       dS[m][t][2 * hf + 1], d, DS);
        }
  if (warp == 0) {
    const float v = warp_sum(dA_acc);
    if (lane == 0) dA_part[((size_t)slice * nb + b) * NH + h] = v;
  }
}

template <int DSP>
cudaError_t launch_bwd(const float* x, const float* dt, const float* A,
                       const float* B, const float* C, const float* init,
                       const float* dy, const float* dfinal, float* cb,
                       float* states, float* dx, float* ddt_part,
                       float* dA_part, float* dB_part, float* dC_part,
                       float* dinit, int batch, int S, int NH, int HD, int DS,
                       int slices, int group, int vec, cudaStream_t stream) {
  using LS = StateSmem<DSP>;
  using LC = ChunkSmem<DSP>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_state_kernel<DSP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LS::kBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<DSP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)LC::kBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int nc = (S + kQ - 1) / kQ;
  ssd_cb_kernel<float><<<dim3(nc, batch), kThreads, 0, stream>>>(B, C, cb, S,
                                                                  DS, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_state_kernel<DSP><<<dim3(slices, NH, batch), kBwdThreads,
                              LS::kBytes, stream>>>(x, dt, A, B, init, states,
                                                    S, NH, HD, DS, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = group;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, NH, batch);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = LC::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_kernel<DSP>, x, dt, A, B, C,
                            static_cast<const float*>(cb),
                            static_cast<const float*>(states), dy, dfinal, dx,
                            ddt_part, dA_part, dB_part, dC_part, dinit, S, NH,
                            HD, DS, group, vec);
}

bool plan_ok(int num_heads, int head_dim, int slices, int group) {
  return slices == (head_dim + kP - 1) / kP && group >= 1 &&
         num_heads % group == 0 && slices * group <= kMaxCluster;
}

}  // namespace

// All pointers float32.  init_state and dfinal may be null (zeros), and
// dinit null when no gradient of the initial state is wanted.
// Workspaces, written and read within the call: cb [batch, nc, 32, 32]
// (C·Bᵀ per 32-row chunk, nc = ceil(seq_len / 32)) and states [batch, nc,
// num_heads, head_dim, d_state].  The plan (ssd_scan.py bwd_plan): slices
// = ceil(head_dim / 32) column slices, and clusters of `group` heads
// (num_heads % group == 0, slices x group <= 8).  Partials, summed by the
// caller: ddt_part [slices, batch, seq_len, num_heads], dA_part [slices,
// batch, num_heads], dB_part and dC_part [batch, seq_len, num_heads /
// group, d_state].  Three launches: C·Bᵀ, the states, the chunks in
// reverse (in clusters).  Returns the launches' error
// (cudaErrorInvalidValue for shapes or plans the kernel does not take).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C,
                            const void* init_state, const void* dy,
                            const void* dfinal, void* cb, void* states,
                            void* dx, void* ddt_part, void* dA_part,
                            void* dB_part, void* dC_part, void* dinit,
                            int batch, int seq_len, int num_heads,
                            int head_dim, int d_state, int slices, int group,
                            void* stream) {
  if (batch <= 0 || batch > 65535 || seq_len <= 0 || num_heads <= 0 ||
      num_heads > 65535 || head_dim <= 0 || head_dim > kHD || d_state <= 0 ||
      d_state > kDS || !plan_ok(num_heads, head_dim, slices, group))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte aligned rows of x, dy, B and C
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
      reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C);
  const int vec = ptrs % 16 == 0 && head_dim % 4 == 0 && d_state % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (d_state <= 64)
    return (int)launch_bwd<64>(
        f(x), f(dt), f(A), f(B), f(C), f(init_state), f(dy), f(dfinal), w(cb),
        w(states), w(dx), w(ddt_part), w(dA_part), w(dB_part), w(dC_part),
        w(dinit), batch, seq_len, num_heads, head_dim, d_state, slices, group,
        vec, s);
  return (int)launch_bwd<128>(
      f(x), f(dt), f(A), f(B), f(C), f(init_state), f(dy), f(dfinal), w(cb),
      w(states), w(dx), w(ddt_part), w(dA_part), w(dB_part), w(dC_part),
      w(dinit), batch, seq_len, num_heads, head_dim, d_state, slices, group,
      vec, s);
}

// The chunk launch's clusters that fit on the card at once for a plan
// (cudaOccupancyMaxActiveClusters), 0 if the query fails.  Launches
// nothing.
extern "C" int ssd_scan_bwd_clusters(int num_heads, int d_state, int slices,
                                     int group, int batch) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = group;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, num_heads, batch);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e;
  if (d_state <= 64) {
    cfg.dynamicSmemBytes = ChunkSmem<64>::kBytes;
    cudaFuncSetAttribute(ssd_bwd_chunk_kernel<64>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)ChunkSmem<64>::kBytes);
    e = cudaOccupancyMaxActiveClusters(&n, ssd_bwd_chunk_kernel<64>, &cfg);
  } else {
    cfg.dynamicSmemBytes = ChunkSmem<128>::kBytes;
    cudaFuncSetAttribute(ssd_bwd_chunk_kernel<128>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)ChunkSmem<128>::kBytes);
    e = cudaOccupancyMaxActiveClusters(&n, ssd_bwd_chunk_kernel<128>, &cfg);
  }
  return e == cudaSuccess ? n : 0;
}
