// Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060) for
// Hopper (sm_90a), on f32-accurate 3xTF32 tensor-core products.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py :: ssd_scan
// and computes the function of the JAX model's jnp scan
// (src/repro/models/ssm.py :: ssd_chunked), initial state included:
//   x [b,s,nh,hd] (float or bf16), dt [b,s,nh] f32 (post-softplus),
//   A [nh] f32 (negative), B, C [b,s,ds] (x's type; one group, shared by
//   every head), init_state [b,nh,hd,ds] f32 or null (zeros)
//   -> y [b,s,nh,hd] (x's type), final_state [b,nh,hd,ds] f32,
// with, per head and chunk (cum = running sum of dt·A inside the chunk):
//   y_i   = Σ_{j<=i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j
//           + exp(cum_i) C_i · S_prev
//   S_new = exp(cum_last) S_prev + Σ_j exp(cum_last − cum_j) dt_j x_j ⊗ B_j
// Every sum and exponential is f32.  Any s >= 1 (a ragged last chunk is
// zero-filled: dt 0 means no decay, no update, no contribution), hd <= 64,
// ds <= 128.
//
// What bounds it on the card: operations.  Per chunk of n rows the
// function needs 2n²·ds flops for C·Bᵀ once (B and C are shared by every
// head) and, per head, 2n²·hd + 4n·hd·ds (the product with x·dt, the
// inter-chunk term and the state update), ~150 flops per input byte at
// the Mamba2-780M widths (nh 48, hd 64, ds 128).  The model hands the
// scan float32 x, B and C, and the products must keep float32 accuracy:
// one TF32 pass keeps ~11 bits.  So every product here is 3xTF32 on
// mma.sync.m16n8k8: each f32 operand splits into hi (TF32) and lo = a − hi
// (TF32), and lo·hi + hi·lo + hi·hi accumulate in f32 (the dropped lo·lo
// is ~2^-20 of the product), at most 495/3 TFLOP/s of f32-accurate work.
// Decay factors and the causal mask stay f32 on the fragments.  On the
// card mma.sync reaches far less than that rate: dropping two of the
// three products cuts 40-50% of the time at 2048 tokens
// (tools/ssd_variants.py).
//
// The design, and what it answers in the scalar kernel it replaces (one
// 256-thread block per (batch, head), 133 KB of shared memory, so 48
// blocks on 132 SMs at batch 1; C·Bᵀ recomputed per head; scalar f32 FMAs
// from shared memory; a one-thread cumsum):
//   * C·Bᵀ once per (batch, chunk): ssd_cb_kernel writes the raw f32 tile
//     to a workspace cb [b, nc, 32, 32] (4 KB a chunk, L2-resident) that
//     every head's scan block reads; each head applies its own decay mask
//     exp(cum_i − cum_j), j <= i, on the A fragments.  The scan is a
//     programmatic dependent launch: its blocks load the state and start
//     the first chunk's copies while the C·Bᵀ launch runs, and wait for
//     it (griddepcontrol.wait) only before the first C·Bᵀ tile.
//   * more, smaller blocks: every column p of x is independent (y and the
//     state row S[p, :] depend on x[:, p] alone), so a scan block owns
//     (batch, head, 32 columns of hd) and carries its [32, ds] state slice
//     in registers (mma accumulators) across the sequential chunk loop, as
//     the TPU grid carried the state across its sequential chunk axis: 96
//     blocks at batch 1 (48 heads), 384 at batch 4, two per SM.  Four
//     warps split the slice as two 16-column tiles by two halves of the
//     state columns; the halves' C·S_prevᵀ partials meet through 4 KB of
//     shared memory.  The width is a build constant (SSD_SCAN_COLS) so
//     that tools/ssd_variants.py times the other plans: 16-column blocks
//     (192 at batch 1, a full wave) are within 3% of 32 at batch 1 and
//     ~20% slower at batch 4; 64-column blocks ~45% slower at batch 1.
//     Every block stages all of B, C and C·Bᵀ, whatever its width.
//   * shared memory for two blocks per SM: the kernel walks 32-row chunks
//     (the SSD algebra is exact for any split; only the summation order
//     changes), so one stage of f32 B, C, x slice, dt and C·Bᵀ is 44 KB
//     and two stages and the partials are 92 KB.  With 64-row chunks B
//     and C alone would be 70 KB a stage.
//   * keep the block busy: 16-byte cp.async copies bring chunk c+1 into
//     the other stage while chunk c computes; cum is a warp shuffle scan
//     (lane = row); three barriers a chunk; the TF32 split is three
//     integer and float operations (cvt.rna.tf32.f32 is about five SASS
//     instructions on sm_90; two per operand took 10-40% longer,
//     tools/ssd_variants.py).
// Products per chunk and warp, all 3xTF32 m16n8k8: C·S_prevᵀ (A = C rows
// by two-element loads, k permuted to match the state accumulators, so
// the state never leaves the registers), att·(x·dt) (causal k steps only)
// and the state update (x·dt·decay)ᵀ·B into the state accumulators.
// No atomics: y and the state are bitwise repeatable run to run.
#include "ssd_tc.cuh"

namespace {

// ------------------------------------------------------------ the scan
constexpr int kScanThreads = 128;
// The columns of hd a scan block owns (16, 32 or 64; ssd_scan.py SLICE).
// 32 is the build; tools/ssd_variants.py builds the other two
// (-DSSD_SCAN_COLS=16 or 64) to time the plans against each other.
#ifndef SSD_SCAN_COLS
#define SSD_SCAN_COLS 32
#endif
constexpr int kP = SSD_SCAN_COLS;
static_assert(kP == 16 || kP == 32 || kP == 64, "16, 32 or 64 columns");
// Shared memory of one block: two stages of (B, C, x slice, C·Bᵀ, dt),
// then the C·S_prevᵀ partials each warp hands the warps that finish a
// y tile it holds a part of.
template <typename T, int DSP>
struct ScanSmem {
  static constexpr int PT = kP / 16;          // 16-column tiles
  static constexpr int NG = 4 / PT;           // state-column groups
  static constexpr int kSlots = NG == 1 ? 0 : NG == 2 ? 2 : 4;
  static constexpr int XP = kP + 8, BP = DSP + 8;
  static constexpr size_t kB = sizeof(T) * kQ * BP;    // B or C
  static constexpr size_t kX = sizeof(T) * kQ * XP;
  static constexpr size_t kCB = sizeof(float) * kQ * kCBP;
  static constexpr size_t kDt = sizeof(float) * kQ;
  static constexpr size_t kStage = 2 * kB + kX + kCB + kDt;
  // [warp][slot][16 rows][8 columns]
  static constexpr size_t kPart = sizeof(float) * 4 * kSlots * 16 * 8;
  static constexpr size_t kBytes = 2 * kStage + kPart;
  static_assert(kB % 16 == 0 && kX % 16 == 0 && kCB % 16 == 0 &&
                    kDt % 16 == 0,
                "16-byte aligned regions");
};

// grid (slices, nh, b), four warps.  Block (slice, h, b) owns columns
// [kP·slice, kP·slice + kP) of head h's hd; DSP (64 or 128) is the state
// width it is built for, ds <= DSP.  The four warps split the block's
// PT = kP/16 column tiles by NG = 4/PT groups of state columns: warp w
// owns column tile pg = w % PT (16 columns) and state columns [ng·DSP/NG,
// (ng+1)·DSP/NG), ng = w / PT; its state tile S[16 p][DSP/NG n] lives in
// mma accumulators for the whole sequence.  Its column tile's y is four
// m16n8 tiles u = 2m + n (row tile m, n8 column tile n); each group holds
// a part of every one (C·S_prevᵀ over its state columns), and the warp of
// group u % NG finishes tile u, adding the other groups' parts.  At 32
// columns (the build): two column tiles by two halves of the state; the
// warp finishes n8 tile ng of both row tiles.
template <typename T, int DSP>
__global__ void __launch_bounds__(kScanThreads, 2)
ssd_scan_tc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ cb,
                   const float* __restrict__ init, T* __restrict__ y,
                   float* __restrict__ final_state, int S, int NH, int HD,
                   int DS, int vec) {
  using L = ScanSmem<T, DSP>;
  constexpr int kThr = kScanThreads, XP = L::XP, BP = L::BP;
  constexpr int PT = L::PT, NG = L::NG;
  constexpr int NT = DSP / (8 * NG);   // the warp's n8 state tiles
  // the y tiles a warp finishes: row tiles by n8 column tiles
  constexpr int MR = NG == 4 ? 1 : 2, NC = NG == 1 ? 2 : 1;
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pg = warp % PT, ng = NG == 1 ? 0 : warp / PT;
  const int p0 = slice * kP;     // the block's first column of hd
  const int pw = 16 * pg;        // the warp's first column in the slice
  const int nw = ng * DSP / NG;  // the warp's first state column
  const int nc = (S + kQ - 1) / kQ;
  const bool vec_ok = vec != 0;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sPart = reinterpret_cast<float*>(smem + 2 * L::kStage);
  auto sB = [&](int st) {
    return reinterpret_cast<T*>(smem + st * L::kStage);
  };
  auto sC = [&](int st) {
    return reinterpret_cast<T*>(smem + st * L::kStage + L::kB);
  };
  auto sX = [&](int st) {
    return reinterpret_cast<T*>(smem + st * L::kStage + 2 * L::kB);
  };
  auto sCB = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + 2 * L::kB +
                                    L::kX);
  };
  auto sDt = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStage + 2 * L::kB +
                                    L::kX + L::kCB);
  };
  // warp w's part of y tile u: an (row, 2q) pair per thread; with two
  // groups a warp hands over one tile per row tile, so slot = m
  auto part = [&](int w, int u, int row) {
    const int slot = NG == 2 ? u >> 1 : u;
    return sPart + ((w * L::kSlots + slot) * 16 + row) * 8 + 2 * q;
  };
  const float a2 = A[h] * 1.4426950408889634f;   // A log2(e): exp -> exp2
  const size_t xrow = (size_t)NH * HD;   // x's row stride

  // chunk c's x slice, B, C and dt into stage st; its C·Bᵀ tile apart,
  // since that is the C·Bᵀ launch's output
  auto stage = [&](int c, int st) {
    const int r0 = c * kQ, nrows = min(kQ, S - r0);
    const size_t row = (size_t)b * S + r0;
    stage_rows<T, kP, XP, kThr>(sX(st), x + (row * NH + h) * HD + p0, xrow,
                                nrows, min(kP, HD - p0), vec_ok, tid);
    stage_rows<T, DSP, BP, kThr>(sB(st), Bm + row * DS, DS, nrows, DS,
                                 vec_ok, tid);
    stage_rows<T, DSP, BP, kThr>(sC(st), Cm + row * DS, DS, nrows, DS,
                                 vec_ok, tid);
    if (tid < kQ)
      cp_async4(sDt(st) + tid, tid < nrows ? dt + (row + tid) * NH + h : dt,
                tid < nrows ? 4 : 0);
  };
  auto stage_cb = [&](int c, int st) {
    stage_rows<float, kQ, kCBP, kThr>(sCB(st),
                                      cb + ((size_t)b * nc + c) * kQ * kQ,
                                      kQ, kQ, kQ, true, tid);
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

  stage(0, 0);
  // everything above overlaps the C·Bᵀ launch (programmatic dependent
  // launch); its tiles are read only after it has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage_cb(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage(c + 1, (c + 1) & 1);
      stage_cb(c + 1, (c + 1) & 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int sg = c & 1;
    const T* cB = sB(sg);
    const T* cC = sC(sg);
    const T* cX = sX(sg);
    const float* cCB = sCB(sg);
    const int r0 = c * kQ;

    // per row (lane = row): cum (inclusive shuffle scan of dt·A, in log2
    // units), the row factor exp(cum_i) of C·S_prev, dt_j exp(cum_last −
    // cum_j); every exp is exp2f (MUFU.EX2, 2 ulp) of log2 units
    const float dtl = sDt(sg)[lane];
    float cum = dtl * a2;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, cum, o);
      if (lane >= o) cum += v;
    }
    const float cum_last = __shfl_sync(0xffffffffu, cum, 31);
    const float e_in = exp2f(cum);
    const float w_out = dtl * exp2f(cum_last - cum);
    const float decay = exp2f(cum_last);

    // ---- C·S_prevᵀ over the warp's state columns, all 32 rows, the
    // warp's 16 columns: yp[2m + n] rows 16m + g (+8), columns pw + 8n +
    // 2q (+1).  k (a state column) is permuted as the accumulators hold
    // it: k q -> 2q, k q+4 -> 2q+1 inside each n8 tile.
    float yp[4][4] = {};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n0 = nw + 8 * t + 2 * q;
      const BFrag s0(st[t][0], st[t][1]), s1(st[t][2], st[t][3]);
      const float2 c00 = load2(cC + g * BP + n0);
      const float2 c01 = load2(cC + (g + 8) * BP + n0);
      const float2 c10 = load2(cC + (16 + g) * BP + n0);
      const float2 c11 = load2(cC + (24 + g) * BP + n0);
      const AFrag a0(c00.x, c01.x, c00.y, c01.y);
      const AFrag a1(c10.x, c11.x, c10.y, c11.y);
      mma3(yp[0], a0, s0);
      mma3(yp[1], a0, s1);
      mma3(yp[2], a1, s0);
      mma3(yp[3], a1, s1);
    }
    // hand each y tile another group finishes its part
    if (NG > 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u % NG != ng) {
          *reinterpret_cast<float2*>(part(warp, u, g)) =
              make_float2(yp[u][0], yp[u][1]);
          *reinterpret_cast<float2*>(part(warp, u, g + 8)) =
              make_float2(yp[u][2], yp[u][3]);
        }
      __syncthreads();
    }

    // ---- the warp's own y tiles: exp(cum_i) Σ_groups (C·S_prevᵀ part),
    // the groups in order, then + Σ_{j<=i} (C·Bᵀ)_ij exp(cum_i − cum_j)
    // dt_j x_j over the causal k steps
    float acc[MR * NC][4];
    float cum_i[MR][2];
#pragma unroll
    for (int mi = 0; mi < MR; ++mi) {
      const int m = NG == 4 ? ng >> 1 : mi;
      const int i0 = 16 * m + g;
      const float e0 = __shfl_sync(0xffffffffu, e_in, i0);
      const float e1 = __shfl_sync(0xffffffffu, e_in, i0 + 8);
      cum_i[mi][0] = __shfl_sync(0xffffffffu, cum, i0);
      cum_i[mi][1] = __shfl_sync(0xffffffffu, cum, i0 + 8);
#pragma unroll
      for (int ni = 0; ni < NC; ++ni) {
        const int u = 2 * m + (NG == 1 ? ni : ng & 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float mine = 0.f;   // yp[u], selected: no runtime register index
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (v == u) mine = yp[v][e];
          float sum = 0.f;
#pragma unroll
          for (int k = 0; k < NG; ++k) {
            const float term =
                k == ng ? mine : part(pg + PT * k, u, g + 8 * (e >> 1))[e & 1];
            sum = k == 0 ? term : sum + term;
          }
          acc[mi * NC + ni][e] = sum * (e < 2 ? e0 : e1);
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const int j0 = 8 * ks + q, j1 = j0 + 4;
      const float cj0 = __shfl_sync(0xffffffffu, cum, j0);
      const float cj1 = __shfl_sync(0xffffffffu, cum, j1);
      const float dt0 = __shfl_sync(0xffffffffu, dtl, j0);
      const float dt1 = __shfl_sync(0xffffffffu, dtl, j1);
      BFrag xb[NC];   // (x·dt) rows j0, j1 of the warp's n8 column tiles
#pragma unroll
      for (int ni = 0; ni < NC; ++ni) {
        const int col = pw + 8 * (NG == 1 ? ni : ng & 1) + g;
        xb[ni] = BFrag(to_float(cX[j0 * XP + col]) * dt0,
                       to_float(cX[j1 * XP + col]) * dt1);
      }
#pragma unroll
      for (int mi = 0; mi < MR; ++mi) {
        const int m = NG == 4 ? ng >> 1 : mi;
        if (ks >= 2 && m == 0) continue;   // above the diagonal
        const int i0 = 16 * m + g, i1 = i0 + 8;
        const AFrag af(
            j0 <= i0 ? cCB[i0 * kCBP + j0] * exp2f(cum_i[mi][0] - cj0) : 0.f,
            j0 <= i1 ? cCB[i1 * kCBP + j0] * exp2f(cum_i[mi][1] - cj0) : 0.f,
            j1 <= i0 ? cCB[i0 * kCBP + j1] * exp2f(cum_i[mi][0] - cj1) : 0.f,
            j1 <= i1 ? cCB[i1 * kCBP + j1] * exp2f(cum_i[mi][1] - cj1) : 0.f);
#pragma unroll
        for (int ni = 0; ni < NC; ++ni) mma3(acc[mi * NC + ni], af, xb[ni]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MR; ++mi)
#pragma unroll
      for (int ni = 0; ni < NC; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = NG == 4 ? ng >> 1 : mi;
          const int n = NG == 1 ? ni : ng & 1;
          const int r = r0 + 16 * m + g + 8 * (e >> 1);
          const int p = p0 + pw + 8 * n + 2 * q + (e & 1);
          if (r < S && p < HD)
            store(y + (((size_t)b * S + r) * NH + h) * HD + p,
                  acc[mi * NC + ni][e]);
        }

    // ---- S = exp(cum_last) S + Σ_j (x_j dt_j exp(cum_last − cum_j)) ⊗ B_j
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] *= decay;
#pragma unroll
    for (int ks = 0; ks < kQ / 8; ++ks) {
      const int j0 = 8 * ks + q, j1 = j0 + 4;
      const float w0 = __shfl_sync(0xffffffffu, w_out, j0);
      const float w1 = __shfl_sync(0xffffffffu, w_out, j1);
      const AFrag af(to_float(cX[j0 * XP + pw + g]) * w0,
                     to_float(cX[j0 * XP + pw + g + 8]) * w0,
                     to_float(cX[j1 * XP + pw + g]) * w1,
                     to_float(cX[j1 * XP + pw + g + 8]) * w1);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = nw + 8 * t + g;
        mma3(st[t], af,
             BFrag(to_float(cB[j0 * BP + n]), to_float(cB[j1 * BP + n])));
      }
    }
    __syncthreads();   // the stage and the partials are refilled next
  }

#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + pw + g + 8 * (e >> 1);
      const int n = nw + 8 * t + 2 * q + (e & 1);
      if (p < HD && n < DS) final_state[(head + p) * DS + n] = st[t][e];
    }
}

template <typename T, int DSP>
cudaError_t launch_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const float* cb,
                        const void* init, void* y, void* final_state,
                        int batch, int S, int NH, int HD, int DS, int slices,
                        int vec, cudaStream_t stream) {
  using L = ScanSmem<T, DSP>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<T, DSP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  // programmatic dependent launch: the scan blocks start (state, first
  // chunk's copies) while the C·Bᵀ launch runs
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, NH, batch);
  cfg.blockDim = dim3(kScanThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, ssd_scan_tc_kernel<T, DSP>, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), cb,
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(final_state), S, NH, HD, DS, vec);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* init, void* y,
                   void* final_state, void* cb, int batch, int S, int NH,
                   int HD, int DS, int slices, cudaStream_t stream) {
  const int nc = (S + kQ - 1) / kQ;
  // 16-byte copies need 16-byte aligned rows of x, B and C
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(B) |
                         reinterpret_cast<uintptr_t>(C);
  const int vec = ptrs % 16 == 0 && HD * sizeof(T) % 16 == 0 &&
                  DS * sizeof(T) % 16 == 0;
  ssd_cb_kernel<T><<<dim3(nc, batch), kThreads, 0, stream>>>(
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(cb), S, DS, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const float* cbf = static_cast<const float*>(cb);
  if (DS <= 64)
    return launch_scan<T, 64>(x, dt, A, B, C, cbf, init, y, final_state,
                              batch, S, NH, HD, DS, slices, vec, stream);
  return launch_scan<T, 128>(x, dt, A, B, C, cbf, init, y, final_state,
                             batch, S, NH, HD, DS, slices, vec, stream);
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, A, init_state
// and final_state are float32; init_state may be null (a zero state).
// cb_workspace: float32 [batch, ceil(seq_len / 32), 32, 32], written and
// read within the call.  slices (ssd_scan.py scan_plan): the 32-column
// slices of head_dim, ceil(head_dim / 32).  Two launches: C·Bᵀ, then the
// scan, which starts as a programmatic dependent launch.  Returns the
// launches' error (cudaErrorInvalidValue for shapes or plans the kernel
// does not take).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init_state,
                        void* y, void* final_state, void* cb_workspace,
                        int batch, int seq_len, int num_heads, int head_dim,
                        int d_state, int dtype, int slices, void* stream) {
  if (batch <= 0 || batch > 65535 || seq_len <= 0 || num_heads <= 0 ||
      num_heads > 65535 || head_dim <= 0 || head_dim > kHD || d_state <= 0 ||
      d_state > kDS || slices != (head_dim + kP - 1) / kP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, B, C, init_state, y, final_state,
                              cb_workspace, batch, seq_len, num_heads,
                              head_dim, d_state, slices, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, init_state, y,
                                      final_state, cb_workspace, batch,
                                      seq_len, num_heads, head_dim, d_state,
                                      slices, s);
  return (int)cudaErrorInvalidValue;
}
