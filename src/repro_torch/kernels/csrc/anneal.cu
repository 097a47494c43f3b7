// The batched simulated anneal (the paper's Algorithm 1) over
// instances x chains, one launch per anneal.
//
// Replaces the JAX package's jitted anneal program,
// src/repro/core/annealing_jax.py:519-536 (_run_chains /
// _run_chains_multi: a lax.while_loop over temperature levels around a
// fori_loop of proposals, vmapped over chains and instances; not a
// Pallas kernel but one compiled program on the device).  The plain
// PyTorch version it is held to is kernels/anneal.py::
// anneal_chains_plain.
//
// What bounds it on this card: neither bytes nor operations.  A chain
// is a serial walk: proposal k+1 reads the schedule proposal k left.
// Each proposal is a short chain of dependent block-wide steps (rebuild
// <= 3 batch rows, an exclusive scan of the batch durations, a
// compare-reduce of the slack rows against the waits, one reduction,
// the Metropolis decision, a sparse commit), each ending at a
// __syncthreads; a few KB move per proposal.  So the time is set by
// that chain of barriers and shared-memory round trips, about ten per
// proposal.  The design answers with:
//   * one thread block per (instance, chain), carrying the schedule,
//     the best schedule and the per-batch statistics on chip (shared
//     memory whenever they fit, else a per-chain global workspace that
//     stays in L1/L2), so a proposal touches no device memory beyond
//     the <= 3 x max_batch request rows it gathers;
//   * the whole temperature loop, the proposal loop and the line-7
//     early exit inside the kernel: one launch and no host round trip
//     per anneal, where the same program as eager PyTorch ops is a few
//     dozen launches per proposal and a readback per level;
//   * a proposal that breaks the max-batch rule costs no barrier at all
//     (every thread computes the move's validity from the same state).
//
// Arithmetic follows the plain version step for step, so the two agree
// bit for bit: a*b+c as one fused multiply-add (the reference's compiled
// program contracts it too), the member sum of a batch row left to right
// in float32, the Metropolis test in float32 in the reference's order of
// operations.  The N-long sums and the wait prefix accumulate in float64
// and round once to float32: for latencies within ~16 binary orders of
// magnitude every partial sum is exact in float64, so the block-wide
// trees and scans here give the value of the plain version's sequential
// sums whatever their order, and a tie between two schedules of equal G
// (a swap inside one batch) breaks the same way in both.
//
// Schedule: perm[N] (request per priority position) and bnd[N] (batch
// boundary before each position, bnd[0] = 1); positions >= n_valid are
// padding pinned as tail singletons.  reqc[N, 11] columns: exec, prefill
// and TPOT coefficients linear in the batch size (A, C pairs), the SLO
// class h, the three SLO budgets, the valid mask.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 11;
enum { kEA, kEC, kPA, kPC, kTA, kTC, kH, kSE, kST, kSP, kValid };

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Per-chain state, carved from shared memory or the workspace.
struct State {
  int* perm;            // [N] current schedule
  int* bp;              // [N] best schedule seen
  int* ti0;             // [N] scratch
  int* ti1;             // [N] scratch
  float* tf0;           // [N] scratch: the wait prefix
  unsigned char* bnd;   // [N]
  unsigned char* bb;    // [N] best boundaries
  float* slacks;        // [N * mb] incremental: sorted member slacks
  int* bsz;             // [N] incremental: batch size at each start
  int* cnt;             // [N] incremental: valid members
  float* sume;          // [N] incremental: sum of member exec times
  float* bdur;          // [N] incremental: batch duration
};

__host__ __device__ inline size_t state_bytes(int n, int mb, bool inc) {
  size_t words = up16(4 * static_cast<size_t>(n));
  size_t total = 5 * words + 2 * up16(static_cast<size_t>(n));
  if (inc) total += up16(4 * static_cast<size_t>(n) * mb) + 4 * words;
  return total;
}

// Shared memory every block takes: per warp, a raw-slack and an exec
// row of mb floats; three candidate rows of mb sorted slacks and their
// scalars.
__host__ __device__ inline size_t row_bytes(int mb, int threads) {
  return up16(4 * static_cast<size_t>(mb) * (2 * (threads / 32) + 3) + 64);
}

// The launch plan, decided here alone: threads a block, and whether the
// per-chain state fits in a shared-memory budget (of the 227 KB a block
// can have) or stays in a global workspace.
constexpr size_t kSmemLimit = 200 * 1024;

inline int block_threads(int n) {
  return n <= 64 ? 64 : n <= 256 ? 128 : 256;
}

inline bool state_in_smem(int n, int mb, bool inc) {
  return state_bytes(n, mb, inc) + row_bytes(mb, block_threads(n)) <=
         kSmemLimit;
}

__device__ State carve(unsigned char* p, int n, int mb, bool inc) {
  State s;
  const size_t w = up16(4 * static_cast<size_t>(n));
  const size_t b = up16(static_cast<size_t>(n));
  s.perm = reinterpret_cast<int*>(p); p += w;
  s.bp = reinterpret_cast<int*>(p); p += w;
  s.ti0 = reinterpret_cast<int*>(p); p += w;
  s.ti1 = reinterpret_cast<int*>(p); p += w;
  s.tf0 = reinterpret_cast<float*>(p); p += w;
  s.bnd = p; p += b;
  s.bb = p; p += b;
  s.slacks = nullptr; s.bsz = s.cnt = nullptr; s.sume = s.bdur = nullptr;
  if (inc) {
    s.slacks = reinterpret_cast<float*>(p); p += up16(4 * static_cast<size_t>(n) * mb);
    s.bsz = reinterpret_cast<int*>(p); p += w;
    s.cnt = reinterpret_cast<int*>(p); p += w;
    s.sume = reinterpret_cast<float*>(p); p += w;
    s.bdur = reinterpret_cast<float*>(p); p += w;
  }
  return s;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__shared__ double g_red_a[32], g_red_b[32];
__shared__ int g_red_c[32];
__shared__ double g_scan_d[32];
__shared__ int g_scan_i[32];

// Block-wide sums of (a, b, c), the same in every thread, in a fixed
// order (warp trees, then the warps in turn).  a and b accumulate in
// float64: see the note on sums at the top.
__device__ void block_sum3(double& a, double& b, int& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_sum(a); b = warp_sum(b); c = warp_sum(c);
  if (lane == 0) { g_red_a[warp] = a; g_red_b[warp] = b; g_red_c[warp] = c; }
  __syncthreads();
  a = g_red_a[0]; b = g_red_b[0]; c = g_red_c[0];
  for (int w = 1; w < nw; ++w) {
    a = __dadd_rn(a, g_red_a[w]); b = __dadd_rn(b, g_red_b[w]);
    c += g_red_c[w];
  }
  __syncthreads();
}

// Exclusive scan over n positions: thread t owns a contiguous range,
// sums it left to right, and the ranges' totals are scanned across the
// block.  src(p) gives the value at p; out[p] gets the sum before p (out
// may be src's own storage: a thread reads its range before writing it).
// Returns the total.  Ends with a barrier.
__device__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ int add_(int a, int b) { return a + b; }
__device__ double* scan_scratch(double) { return g_scan_d; }
__device__ int* scan_scratch(int) { return g_scan_i; }

template <class V, class Src, class Out>
__device__ V block_exclusive_scan(int n, Src src, Out out) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int len = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * len), hi = min(n, lo + len);
  V s = V(0);
  for (int p = lo; p < hi; ++p) s = add_(s, src(p));
  V x = s;                                   // inclusive warp scan
  for (int o = 1; o < 32; o <<= 1) {
    V y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x = add_(x, y);
  }
  V excl = __shfl_up_sync(~0u, x, 1);
  if (lane == 0) excl = V(0);
  V* tot = scan_scratch(V(0));
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  V run = V(0), all = V(0);
  for (int w = 0; w < nw; ++w) {
    if (w < warp) run = add_(run, tot[w]);
    all = add_(all, tot[w]);
  }
  run = add_(run, excl);
  for (int p = lo; p < hi; ++p) {
    V v = src(p);
    out(p, run);
    run = add_(run, v);
  }
  __syncthreads();
  return all;
}

// One batch row, by one warp: the members at positions start ..
// start+size-1 (request perm_at(p)), their exec times, sorted slacks
// (the largest batch wait under which each still meets its SLO; +inf for
// padding and non-members, -inf when the TPOT SLO fails at this size),
// the valid-member count, the member exec sum (left to right) and the
// batch duration.  raw / exs: this warp's scratch rows of mb floats.
template <class PermAt>
__device__ void build_row(const float* __restrict__ rq, PermAt perm_at,
                          int start, int size, int mb, float* raw,
                          float* exs, float* sorted, int& cnt_out,
                          float& sume_out, float& bdur_out) {
  const int lane = threadIdx.x & 31;
  const float b = static_cast<float>(size);
  int live_n = 0;
  float bd = -INFINITY;
  for (int k = lane; k < mb; k += 32) {
    float ex = 0.f, slack = INFINITY;
    if (k < size) {
      const float* r = rq + static_cast<size_t>(perm_at(start + k)) * kCols;
      ex = __fmaf_rn(__ldg(r + kEA), b, __ldg(r + kEC));
      const float pref = __fmaf_rn(__ldg(r + kPA), b, __ldg(r + kPC));
      const bool tpot_ok =
          __fmaf_rn(__ldg(r + kTA), b, __ldg(r + kTC)) <= __ldg(r + kSP);
      const float s = __ldg(r + kH) == 1.f ? __fsub_rn(__ldg(r + kSE), ex)
                      : tpot_ok ? __fsub_rn(__ldg(r + kST), pref)
                                : -INFINITY;
      if (__ldg(r + kValid) > 0.f) { slack = s; ++live_n; }
      bd = fmaxf(bd, ex);
    }
    exs[k] = ex;
    raw[k] = slack;
  }
  __syncwarp();
  for (int k = lane; k < mb; k += 32) {
    const float v = raw[k];
    int rank = 0;
    for (int m = 0; m < mb; ++m) {
      const float x = raw[m];
      rank += (x < v) || (x == v && m < k);
    }
    sorted[rank] = v;
  }
  live_n = warp_sum(live_n);
  bd = warp_max(bd);
  float se = 0.f;
  if (lane == 0) {
    se = exs[0];
    for (int k = 1; k < mb; ++k) se = __fadd_rn(se, exs[k]);
  }
  se = __shfl_sync(~0u, se, 0);
  cnt_out = live_n;
  sume_out = se;
  bdur_out = size > 0 ? bd : 0.f;
  __syncwarp();
}

// Shared-memory row buffers: per warp a raw-slack and an exec row, the
// three candidate rows and their scalars.
struct Rows {
  float* raw;   // [warps][mb]
  float* exs;   // [warps][mb]
  float* sl;    // [3][mb]
  int* start;   // [3]
  int* size;    // [3]
  int* cnt;     // [3]
  float* sume;  // [3]
  float* bdur;  // [3]
};

// Stats rows of a whole schedule (perm_at, bnd): row p is the batch
// starting at p, neutral where no batch starts.  Ends with a barrier.
template <class PermAt>
__device__ void build_stats(const float* __restrict__ rq, PermAt perm_at,
                            const State& s, const Rows& rows, int n,
                            int mb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int p = warp; p < n; p += nw) {
    float* row = s.slacks + static_cast<size_t>(p) * mb;
    if (!s.bnd[p]) {
      for (int k = lane; k < mb; k += 32) row[k] = INFINITY;
      if (lane == 0) {
        s.bsz[p] = 0; s.cnt[p] = 0; s.sume[p] = 0.f; s.bdur[p] = 0.f;
      }
      continue;
    }
    int e = p + 1;
    while (e < n && !s.bnd[e]) ++e;
    int c; float se, bd;
    build_row(rq, perm_at, p, e - p, mb, rows.raw + warp * mb,
              rows.exs + warp * mb, row, c, se, bd);
    if (lane == 0) { s.bsz[p] = e - p; s.cnt[p] = c; s.sume[p] = se; s.bdur[p] = bd; }
  }
  __syncthreads();
}

// Score the committed stats with `nrow` candidate rows overriding theirs
// (0 or 3; duplicate starts carry identical rows): waits are the
// exclusive prefix of the batch durations; a batch's met count is its
// valid members minus the slacks below its wait.  G = met / (sum of
// member exec + sum of valid members x wait).
__device__ void score(const State& s, const Rows& rows, int nrow, int n,
                      int mb, float& g, int& met) {
  auto pick = [&](int p) {
    int r = -1;
    for (int q = 0; q < nrow; ++q) if (rows.start[q] == p) r = q;
    return r;
  };
  float* wait = s.tf0;
  block_exclusive_scan<double>(
      n,
      [&](int p) {
        const int r = pick(p);
        return static_cast<double>(r >= 0 ? rows.bdur[r] : s.bdur[p]);
      },
      [&](int p, double v) { wait[p] = static_cast<float>(v); });
  double a = 0.0, b = 0.0;
  int c = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int r = pick(p);
    const int cc = r >= 0 ? rows.cnt[r] : s.cnt[p];
    const float se = r >= 0 ? rows.sume[r] : s.sume[p];
    const float w = wait[p];
    int below = 0;
    if (cc > 0) {
      const float* row = r >= 0 ? rows.sl + r * mb
                                : s.slacks + static_cast<size_t>(p) * mb;
      while (below < mb && row[below] < w) ++below;
    }
    c += cc - below;
    a = __dadd_rn(a, se);
    b = __dadd_rn(b, __fmul_rn(static_cast<float>(cc), w));
  }
  block_sum3(a, b, c);
  const float total = __fadd_rn(static_cast<float>(a), static_cast<float>(b));
  g = __fdiv_rn(static_cast<float>(c), fmaxf(total, 1e-12f));
  met = c;
}

// The full Eq. 2 objective of (perm, bnd), the oracle path: batch ids by
// a scan of the boundaries, each batch's duration, the waits by a scan
// over batches, then every position's e2e / TTFT / TPOT against its SLO.
__device__ void eval_g(const float* __restrict__ rq, const int* perm,
                       const State& s, int n, float& g, int& met) {
  int* first = s.ti0;     // exclusive boundary count at each position
  int* start = s.ti1;     // start position of each batch
  float* bw = s.tf0;      // per batch: duration, then wait
  const int nb = block_exclusive_scan<int>(
      n, [&](int p) { return static_cast<int>(s.bnd[p]); },
      [&](int p, int v) { first[p] = v; });
  for (int p = threadIdx.x; p < n; p += blockDim.x)
    if (s.bnd[p]) start[first[p]] = p;
  __syncthreads();
  for (int q = threadIdx.x; q < nb; q += blockDim.x) {
    const int st = start[q], en = q + 1 < nb ? start[q + 1] : n;
    const float b = static_cast<float>(en - st);
    float bd = -INFINITY;
    for (int p = st; p < en; ++p) {
      const float* r = rq + static_cast<size_t>(perm[p]) * kCols;
      bd = fmaxf(bd, __fmaf_rn(__ldg(r + kEA), b, __ldg(r + kEC)));
    }
    bw[q] = bd;
  }
  __syncthreads();
  block_exclusive_scan<double>(
      nb, [&](int q) { return static_cast<double>(bw[q]); },
      [&](int q, double v) { bw[q] = static_cast<float>(v); });
  double a = 0.0, unused = 0.0;
  int c = 0;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int q = first[p] + s.bnd[p] - 1;
    const int en = q + 1 < nb ? start[q + 1] : n;
    const float b = static_cast<float>(en - start[q]);
    const float* r = rq + static_cast<size_t>(perm[p]) * kCols;
    const float t_wait = bw[q];
    const float e2e = __fadd_rn(__fmaf_rn(__ldg(r + kEA), b, __ldg(r + kEC)), t_wait);
    const float ttft = __fadd_rn(__fmaf_rn(__ldg(r + kPA), b, __ldg(r + kPC)), t_wait);
    const float tpot = __fmaf_rn(__ldg(r + kTA), b, __ldg(r + kTC));
    const bool ok = __ldg(r + kH) == 1.f
                        ? e2e <= __ldg(r + kSE)
                        : (ttft <= __ldg(r + kST)) && (tpot <= __ldg(r + kSP));
    if (__ldg(r + kValid) > 0.f) {
      c += ok;
      a = __dadd_rn(a, e2e);
    }
  }
  block_sum3(a, unused, c);
  g = __fdiv_rn(static_cast<float>(c),
                fmaxf(static_cast<float>(a), 1e-12f));
  met = c;
}

__device__ __forceinline__ int start_of(const unsigned char* bnd, int i) {
  while (!bnd[i]) --i;     // bnd[0] is always set
  return i;
}

template <bool kInc>
__global__ void anneal_kernel(const float* __restrict__ reqc,
                              const int* __restrict__ n_valid,
                              const float* __restrict__ draws,
                              int* __restrict__ out_perm,
                              unsigned char* __restrict__ out_bnd,
                              float* __restrict__ out_g,
                              unsigned char* __restrict__ work, int chains,
                              int n, int n_prop, int mb, int iters,
                              int in_smem, float T0, float T_thres,
                              float tau) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int chain = blockIdx.x, inst = chain / chains;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const float* rq = reqc + static_cast<size_t>(inst) * n * kCols;
  const float* dr = draws + static_cast<size_t>(chain) * n_prop * 4;
  const int nv = n_valid[inst];

  Rows rows;
  rows.raw = reinterpret_cast<float*>(dsm);
  rows.exs = rows.raw + nw * mb;
  rows.sl = rows.exs + nw * mb;
  rows.start = reinterpret_cast<int*>(rows.sl + 3 * mb);
  rows.size = rows.start + 3;
  rows.cnt = rows.size + 3;
  rows.sume = reinterpret_cast<float*>(rows.cnt + 3);
  rows.bdur = rows.sume + 3;
  const size_t sb = state_bytes(n, mb, kInc);
  unsigned char* base = in_smem ? dsm + row_bytes(mb, blockDim.x)
                                : work + static_cast<size_t>(chain) * sb;
  const State s = carve(base, n, mb, kInc);

  // ---- the two starting solutions: predicted-e2e order (stable) and
  // arrival order, maximal batches over the real prefix
  const float fmb = static_cast<float>(mb);
  for (int p = t; p < n; p += blockDim.x) {
    const float* r = rq + static_cast<size_t>(p) * kCols;
    s.tf0[p] = __ldg(r + kValid) > 0.f
                   ? __fmaf_rn(__ldg(r + kEA), fmb, __ldg(r + kEC))
                   : INFINITY;
    s.bnd[p] = (p % mb == 0) || p >= nv;
    s.perm[p] = p;
  }
  __syncthreads();
  for (int p = t; p < n; p += blockDim.x) {
    const float v = s.tf0[p];
    int rank = 0;
    for (int q = 0; q < n; ++q) {
      const float x = s.tf0[q];
      rank += (x < v) || (x == v && q < p);
    }
    s.bp[rank] = p;                 // bp holds the sorted start for now
  }
  __syncthreads();
  auto ident = [](int p) { return p; };
  auto sorted_at = [&](int p) { return s.bp[p]; };
  float f_a, f_s;
  int met_a, met_s;
  if (kInc) {
    build_stats(rq, ident, s, rows, n, mb);
    score(s, rows, 0, n, mb, f_a, met_a);
    build_stats(rq, sorted_at, s, rows, n, mb);
    score(s, rows, 0, n, mb, f_s, met_s);
  } else {
    eval_g(rq, s.perm, s, n, f_a, met_a);
    eval_g(rq, s.bp, s, n, f_s, met_s);
  }
  const bool pick = f_s >= f_a;
  for (int p = t; p < n; p += blockDim.x) {
    if (pick) s.perm[p] = s.bp[p]; else s.bp[p] = p;
    s.bb[p] = s.bnd[p];
  }
  __syncthreads();
  if (kInc && !pick) build_stats(rq, ident, s, rows, n, mb);
  float f = pick ? f_s : f_a;
  int met = pick ? met_s : met_a;
  const float f_ref = fmaxf(f, 1e-12f);
  float bf = f;
  int bmet = met;

  // ---- temperature levels (the line-7 early exit in the condition)
  float T = T0;
  int k = 0;
  while (T >= T_thres && bmet < nv && k + iters <= n_prop) {
    for (int it = 0; it < iters; ++it, ++k) {
      const float* u = dr + static_cast<size_t>(k) * 4;
      const float u0 = __ldg(u), u1 = __ldg(u + 1), u2 = __ldg(u + 2),
                  u3 = __ldg(u + 3);
      const int op = min(static_cast<int>(__fmul_rn(u0, 3.f)), 2);
      const int hi = max(nv, 2), lo_n = max(nv, 1);
      const int i = min(1 + static_cast<int>(__fmul_rn(u1, static_cast<float>(hi - 1))), hi - 1);
      const int j = min(static_cast<int>(__fmul_rn(u2, static_cast<float>(lo_n))), lo_n - 1);
      // move descriptors, computed alike by every thread
      const bool bnd_i = s.bnd[i];
      const int a_im1 = start_of(s.bnd, i - 1);
      const int i2 = min(i + 1, n - 1);
      const bool ok = i < nv && (op == 0 ? bnd_i && i - a_im1 < mb
                                 : op == 1 ? !bnd_i : j < nv);
      if (!ok) continue;
      const int pi = s.perm[i], pj = s.perm[j];
      float f_new;
      int met_new;
      if (kInc) {
        const int a_i = bnd_i ? i : a_im1;
        const int a_j = start_of(s.bnd, j);
        const int s_prev = s.bsz[a_im1], s_cur = s.bsz[i];
        const int s_old = s.bsz[a_i], s_j = s.bsz[a_j];
        const int left = i - a_i;
        // the three rows to rebuild: (start, new size) each
        int st0, st1, st2, sz0, sz1, sz2;
        if (op == 0) {
          st0 = a_im1; st1 = i; st2 = i2;
          sz0 = s_prev + 1; sz1 = 0;
          sz2 = s_cur > 1 ? s_cur - 1 : (i2 == i ? 0 : s.bsz[i2]);
        } else if (op == 1) {
          st0 = a_i; st1 = i; st2 = i;
          sz0 = left; sz1 = s_old - left; sz2 = s_old - left;
        } else {
          st0 = a_i; st1 = a_j; st2 = a_j;
          sz0 = s_old; sz1 = s_j; sz2 = s_j;
        }
        auto perm_c = [&](int p) {
          if (op == 2) {
            if (p == i) return pj;
            if (p == j) return pi;
          }
          return s.perm[p];
        };
        for (int r = warp; r < 3; r += nw) {
          const int st = r == 0 ? st0 : r == 1 ? st1 : st2;
          const int sz = r == 0 ? sz0 : r == 1 ? sz1 : sz2;
          int c; float se, bd;
          build_row(rq, perm_c, st, sz, mb, rows.raw + warp * mb,
                    rows.exs + warp * mb, rows.sl + r * mb, c, se, bd);
          if (lane == 0) {
            rows.start[r] = st; rows.size[r] = sz; rows.cnt[r] = c;
            rows.sume[r] = se; rows.bdur[r] = bd;
          }
        }
        __syncthreads();
        score(s, rows, 3, n, mb, f_new, met_new);
      } else {
        const bool bnd_i2 = s.bnd[i2];
        __syncthreads();            // every thread has read the old state
        if (t == 0) {
          if (op == 0) { s.bnd[i] = 0; if (i + 1 < n) s.bnd[i2] = 1; }
          else if (op == 1) s.bnd[i] = 1;
          else { s.perm[i] = pj; s.perm[j] = pi; }
        }
        __syncthreads();
        eval_g(rq, s.perm, s, n, f_new, met_new);
        const float p_acc = expf(__fdiv_rn(__fsub_rn(f_new, f),
                                           __fdiv_rn(__fmul_rn(f_ref, T), T0)));
        const bool accept = f_new > f || u3 < p_acc;
        if (!accept && t == 0) {
          if (op == 0) { s.bnd[i2] = bnd_i2; s.bnd[i] = bnd_i; }
          else if (op == 1) s.bnd[i] = bnd_i;
          else { s.perm[j] = pj; s.perm[i] = pi; }
        }
        if (accept) { f = f_new; met = met_new; }
        __syncthreads();
        if (accept && f > bf) {
          for (int p = t; p < n; p += blockDim.x) {
            s.bp[p] = s.perm[p];
            s.bb[p] = s.bnd[p];
          }
          bf = f; bmet = met;
          __syncthreads();
        }
        continue;
      }
      // incremental: Metropolis, then a sparse commit of the <= 3 rows,
      // <= 2 perm entries and <= 2 boundary bits
      const float p_acc = expf(__fdiv_rn(__fsub_rn(f_new, f),
                                         __fdiv_rn(__fmul_rn(f_ref, T), T0)));
      if (!(f_new > f || u3 < p_acc)) continue;
      for (int r = warp; r < 3; r += nw) {
        const int p = rows.start[r];
        bool dup = false;
        for (int q = 0; q < r; ++q) dup |= rows.start[q] == p;
        if (dup) continue;
        float* dst = s.slacks + static_cast<size_t>(p) * mb;
        for (int kk = lane; kk < mb; kk += 32) dst[kk] = rows.sl[r * mb + kk];
        if (lane == 0) {
          s.bsz[p] = rows.size[r]; s.cnt[p] = rows.cnt[r];
          s.sume[p] = rows.sume[r]; s.bdur[p] = rows.bdur[r];
        }
      }
      if (t == 0) {
        if (op == 0) { s.bnd[i] = 0; if (i + 1 < n) s.bnd[i2] = 1; }
        else if (op == 1) s.bnd[i] = 1;
        else { s.perm[i] = pj; s.perm[j] = pi; }
      }
      f = f_new;
      met = met_new;
      __syncthreads();
      if (f > bf) {
        for (int p = t; p < n; p += blockDim.x) {
          s.bp[p] = s.perm[p];
          s.bb[p] = s.bnd[p];
        }
        bf = f; bmet = met;
        __syncthreads();
      }
    }
    T = __fmul_rn(T, tau);
  }
  int* op_ = out_perm + static_cast<size_t>(chain) * n;
  unsigned char* ob = out_bnd + static_cast<size_t>(chain) * n;
  for (int p = t; p < n; p += blockDim.x) {
    op_[p] = s.bp[p];
    ob[p] = s.bb[p];
  }
  if (t == 0) out_g[chain] = bf;
}

}  // namespace

// Bytes of global workspace an anneal needs: 0 when each chain's state
// fits in shared memory, else one state per (instance, chain).
extern "C" long long anneal_workspace_bytes(int n_inst, int chains, int n,
                                            int mb, int incremental) {
  const bool inc = incremental != 0;
  if (state_in_smem(n, mb, inc)) return 0;
  return static_cast<long long>(n_inst) * chains * state_bytes(n, mb, inc);
}

// work holds anneal_workspace_bytes(...) bytes (none when that is 0).
extern "C" int anneal(const float* reqc, const int* n_valid,
                      const float* draws, int* out_perm,
                      unsigned char* out_bnd, float* out_g,
                      unsigned char* work, int n_inst, int chains, int n,
                      int n_prop, int mb, int iters, int incremental,
                      float T0, float T_thres, float tau,
                      cudaStream_t stream) {
  const int threads = block_threads(n);
  const int in_smem = state_in_smem(n, mb, incremental != 0);
  const size_t smem = row_bytes(mb, threads) +
                      (in_smem ? state_bytes(n, mb, incremental != 0) : 0);
  auto kern = incremental ? anneal_kernel<true> : anneal_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_inst * chains, threads, smem, stream>>>(
      reqc, n_valid, draws, out_perm, out_bnd, out_g, work, chains, n,
      n_prop, mb, iters, in_smem, T0, T_thres, tau);
  return static_cast<int>(cudaGetLastError());
}
