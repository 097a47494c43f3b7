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
// is a serial walk: proposal k+1 reads the schedule proposal k left, and
// a proposal is a short chain of dependent steps (decode the move,
// rebuild <= 3 batch rows, a prefix sum of the batch durations, three
// N-long sums, the Metropolis test, a sparse commit) over a few KB.  So
// the time is the latency of that chain, issued by few warps: on this
// card a block barrier among 128 threads costs ~19 cycles, a float64
// shuffle-scan step ~43, a shared-memory load ~29, and one warp that
// owns several positions a proposal pays each of its instructions in
// series (tools/anneal_variants.py measures them and profiles a
// proposal's phases).  The design:
//   * a thread per position up to N 256 (a block of at least 96
//     threads), 256 threads each over ceil(N / 256) positions past that;
//     one warp per chain (a 32-thread block, no block barrier at all) up
//     to N = kWarpMaxN, where it is no slower.  A proposal then takes
//     four barriers (rows built, the scan's and the sums' exchange of
//     warp totals, the commit), and a rejected one three;
//   * nothing from device memory on a proposal's chain: the instance's
//     request rows are staged in shared memory at start (where they fit
//     beside the state), and each warp copies its chain's draws
//     (cp.async, 16 bytes a lane) a tile of 32 proposals ahead into a
//     double buffer;
//   * the three candidate rows built at once, one warp each (groups of
//     10 lanes on the warp plan at max_batch <= 10): a lane a member, the
//     valid count by ballot, the member sum left to right in float32;
//   * slacks unsorted: a batch keeps its members' slacks at its own
//     positions, in member order (N floats, not N x max_batch), and a
//     position counts its own slack against its batch's wait, so no row
//     is ranked or searched: the count does not depend on the order;
//   * O(1) bookkeeping: the start of the batch holding each position
//     (st) is kept beside the boundaries and updated in the sparse
//     commit; the start-up order is a bitonic sort of (key, index) pairs
//     instead of an O(N^2) rank count;
//   * the state in shared memory while it fits (a per-chain global
//     workspace past that), its position arrays padded so that threads
//     reading neighbouring ranges hit distinct banks;
//   * a proposal that breaks the max-batch rule costs no barrier at all
//     (every thread computes the move's validity from the same state).
//
// Arithmetic follows the plain version step for step, so the two agree
// bit for bit: a*b+c as one fused multiply-add (the reference's compiled
// program contracts it too), the member sum of a batch row left to right
// in float32, the Metropolis test in float32 in the reference's order of
// operations.  The N-long sums and the wait prefix accumulate in float64
// and round once to float32.  Each thread sums its range left to right,
// the warp scans (lane l adds lane l-o, o = 1, 2, 4, 8, 16) or sums
// (butterfly, o = 1 .. 16) the threads' totals and the block adds the
// warps' in order; a batch's wait is the prefix at one of its positions
// less the start's duration, exactly.  That order differs from the plain version's left-to-
// right sums, but every partial sum of float32 values is exact in
// float64 while the values' binary orders of magnitude plus log2(N) span
// at most 53 - 24 = 29 bits (16 orders at N <= 8192, the largest N the
// wrapper takes), and exact sums do not depend on their order
// (tests/test_torch_anneal_order.py emulates this order).  So a tie between
// two schedules of equal G (a swap inside one batch) breaks the same way
// in both.
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
constexpr int kWarpMaxN = 32;  // a warp per chain up to here
constexpr int kParBatch = 10;   // three rows at once, 10 lanes a row
constexpr int kTile = 32;       // proposals a draw tile, one a lane
constexpr int kBlockMax = 256;  // threads of the block plan
// of the 227 KB a block can have
constexpr size_t kSmemBudget = 220 * 1024;

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The batch starting at a position (neutral where none starts).
struct __align__(16) Stat {
  float bdur;  // duration: the largest member exec time
  float sume;  // member exec times summed left to right
  int cnt;     // valid members
  int bsz;     // members
};

// Per-chain state, carved from shared memory or the workspace.  The
// arrays a thread reads over its own range of positions (stats, perm,
// slk) skip a slot every 8 (16-byte entries) or 32 (4-byte) positions,
// so that lanes reading ranges of L positions in step hit distinct
// banks (unpadded, a stride of L entries puts them all on a few).
struct State {
  Stat* stats;         // [N] padded; before the first build the sort's
                       //     scratch
  int* perm_;          // [N] padded: current schedule
  int* bp;             // [N] best schedule seen
  int* st;             // [N] start of the batch holding each position
  float* slk_;         // [N] padded, incremental: each batch's member
                       //     slacks, in member order, at its positions
  unsigned char* bnd;  // [N]
  unsigned char* bb;   // [N] best boundaries
  __device__ __forceinline__ Stat& stat(int p) const {
    return stats[p + (p >> 3)];
  }
  __device__ __forceinline__ int& perm(int p) const {
    return perm_[p + (p >> 5)];
  }
  __device__ __forceinline__ float& slk(int p) const {
    return slk_[p + (p >> 5)];
  }
};

__host__ __device__ inline size_t padded(int n, int every) {
  return static_cast<size_t>(n) + n / every + 1;
}

__host__ __device__ inline size_t state_bytes(int n, bool inc) {
  const size_t w = up16(4 * static_cast<size_t>(n));
  const size_t pw = up16(4 * padded(n, 32));
  return up16(16 * padded(n, 8)) + pw + 2 * w + (inc ? pw : 0) +
         2 * up16(static_cast<size_t>(n));
}

__device__ __forceinline__ State carve(unsigned char* p, int n, bool inc) {
  const size_t w = up16(4 * static_cast<size_t>(n));
  const size_t pw = up16(4 * padded(n, 32));
  State s;
  s.stats = reinterpret_cast<Stat*>(p); p += up16(16 * padded(n, 8));
  s.perm_ = reinterpret_cast<int*>(p); p += pw;
  s.bp = reinterpret_cast<int*>(p); p += w;
  s.st = reinterpret_cast<int*>(p); p += w;
  s.slk_ = nullptr;
  if (inc) { s.slk_ = reinterpret_cast<float*>(p); p += pw; }
  s.bnd = p; p += up16(static_cast<size_t>(n));
  s.bb = p;
  return s;
}

// Shared memory of a block: per warp two draw tiles; the exchange
// buffers of the block plan; (incremental) the three candidate rows'
// member exec times, padded a slot so the three rows sit on other
// banks, their slacks and their scalars; the staged request rows (12
// floats a row) and the state where they fit.
struct Layout {
  size_t tiles, xchg, pair, csl, meta, rq, state, total;
};

__host__ __device__ inline Layout layout(int n, int mb, bool inc, int warps,
                                         bool rq_smem, bool st_smem) {
  Layout l;
  size_t o = 0;
  l.tiles = o; o += up16(static_cast<size_t>(warps) * 2 * kTile * 16);
  l.xchg = o; o += up16(3 * 32 * 8 + 32 * 4);
  l.pair = o; o += inc ? up16(3 * 4 * (static_cast<size_t>(mb) + 1)) : 0;
  l.csl = o; o += inc ? up16(3 * 4 * static_cast<size_t>(mb)) : 0;
  l.meta = o; o += 64;
  l.rq = o; o += rq_smem ? up16(48 * static_cast<size_t>(n)) : 0;
  l.state = o; o += st_smem ? state_bytes(n, inc) : 0;
  l.total = o;
  return l;
}

// The launch plan, decided here alone: a warp or a block per chain, and
// whether the state and the request rows sit in shared memory.
struct Plan {
  bool warp, rq_smem, st_smem;
  int threads;
  size_t smem;
};

inline Plan plan_of(int n, int mb, bool inc) {
  Plan p;
  p.warp = n <= kWarpMaxN;
  // a thread a position up to N 256, and at least the three warps that
  // build the candidate rows at once
  p.threads = p.warp ? 32 : n <= kBlockMax ? (n < 96 ? 96 : (n + 31) & ~31)
                                          : kBlockMax;
  const int w = p.threads / 32;
  // the warp plan holds both (under 40 KB at N 256, max_batch 256)
  p.st_smem = p.warp ||
              layout(n, mb, inc, w, false, true).total <= kSmemBudget;
  p.rq_smem = p.warp || (p.st_smem && layout(n, mb, inc, w, true, true)
                                              .total <= kSmemBudget);
  p.smem = layout(n, mb, inc, w, p.rq_smem, p.st_smem).total;
  return p;
}

// Request rows: staged (12 floats a row) or in device memory (11).
struct Req {
  const float* base;
  int stride;
  __device__ __forceinline__ const float* row(int p) const {
    return base + static_cast<size_t>(p) * stride;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a / b rounded to nearest, ties to even, as IEEE division gives it,
// without the out-of-line slow path that __fdiv_rn branches to (a call
// makes ptxas save the registers live across it to the stack).  Both
// operands in [2^-57, 2^58) (or a zero numerator): an approximate
// reciprocal, one Newton step to within one ulp, then the nearer of that
// quotient and its neighbour by their remainders, which fma gives
// exactly there.  Anything else: long division of the significands.
__device__ __forceinline__ float div_slow(float a, float b) {
  const unsigned ua = __float_as_uint(a), ub = __float_as_uint(b);
  const unsigned sign = (ua ^ ub) & 0x80000000u;
  const unsigned nan = 0x7fffffffu, inf = sign | 0x7f800000u;
  int ea = ua >> 23 & 0xff, eb = ub >> 23 & 0xff;
  unsigned ma = ua & 0x7fffffu, mb = ub & 0x7fffffu;
  if ((ea == 255 && ma) || (eb == 255 && mb)) return __uint_as_float(nan);
  if (ea == 255) return __uint_as_float(eb == 255 ? nan : inf);
  if (eb == 255) return __uint_as_float(sign);
  if (!(ea | ma)) return __uint_as_float(eb | mb ? sign : nan);
  if (!(eb | mb)) return __uint_as_float(inf);
  if (ea) ma |= 0x800000u; else for (ea = 1; !(ma & 0x800000u); --ea) ma <<= 1;
  if (eb) mb |= 0x800000u; else for (eb = 1; !(mb & 0x800000u); --eb) mb <<= 1;
  int be = ea - eb + 127;              // biased exponent of the quotient
  if (ma < mb) { ma <<= 1; --be; }     // ma / mb in [1, 2)
  unsigned q = 0, rem = ma;
  for (int k = 0; k < 26; ++k) {       // q = floor(ma / mb * 2^25)
    q <<= 1;
    if (rem >= mb) { rem -= mb; q |= 1; }
    rem <<= 1;
  }
  bool sticky = rem != 0;
  const int s = be >= 1 ? 2 : 3 - be; // bits below the result's last
  if (s > 31) return __uint_as_float(sign);
  unsigned m = q >> s;
  const bool guard = q >> (s - 1) & 1;
  sticky |= (q & ((1u << (s - 1)) - 1)) != 0;
  m += guard && (sticky || (m & 1));
  if (be < 1) return __uint_as_float(sign | m);   // subnormal (or 2^-126)
  if (m == 1u << 24) { m >>= 1; ++be; }
  if (be >= 255) return __uint_as_float(inf);
  return __uint_as_float(sign | static_cast<unsigned>(be) << 23 |
                         (m & 0x7fffffu));
}

__device__ __forceinline__ float div_rn(float a, float b) {
  const unsigned ea = __float_as_uint(a) >> 23 & 0xff;
  const unsigned eb = __float_as_uint(b) >> 23 & 0xff;
  if (eb - 70u > 114u || (ea - 70u > 114u && a != 0.f)) return div_slow(a, b);
  if (a == 0.f) return __uint_as_float((__float_as_uint(a) ^
                                        __float_as_uint(b)) & 0x80000000u);
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(b));
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  const float r = __fmaf_rn(-b, q, a);
  if (r == 0.f) return q;
  // the neighbour of q on the side of a / b
  const bool above = (r > 0.f) == (b > 0.f);
  const float qn = __uint_as_float(__float_as_uint(q) +
                                   (above == (q > 0.f) ? 1u : ~0u));
  const float d = fabsf(r), dn = fabsf(__fmaf_rn(-b, qn, a));
  if (d != dn) return d < dn ? q : qn;
  return __float_as_uint(q) & 1 ? qn : q;
}

template <bool kWarp>
__device__ __forceinline__ void gsync() {
  if (kWarp) __syncwarp(); else __syncthreads();
}

// Butterfly sum: partners add the same two values (addition commutes),
// so every lane ends with the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    v = __dadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// The block plan's exchange buffers: one pair for the scan, one for
// the sums, so two exchanges in a row need no barrier between them.
struct Xchg {
  double* scan;
  double* a;
  double* b;
  int* c;
};

// Exclusive prefix, in position order, of the threads' range totals s
// (lane l adds lane l-o for o = 1, 2, 4, 8, 16, then the warps' totals
// in order), beside the group total of a when kSum.
template <bool kWarp, bool kSum>
__device__ __forceinline__ double scan_sum(double s, double& a,
                                           const Xchg& x) {
  const int lane = threadIdx.x & 31;
  double incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(~0u, incl, o);
    if (kSum) a = __dadd_rn(a, __shfl_xor_sync(~0u, a, o));
    if (lane >= o) incl = __dadd_rn(incl, y);
  }
  double e = __shfl_up_sync(~0u, incl, 1);
  if (lane == 0) e = 0.0;
  if (kWarp) return e;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (lane == 31) x.scan[warp] = incl;
  if (kSum && lane == 0) x.a[warp] = a;
  __syncthreads();
  double pre = 0.0;
  for (int w = 0; w < warp; ++w) pre = __dadd_rn(pre, x.scan[w]);
  if (kSum) {
    a = x.a[0];
    for (int w = 1; w < nw; ++w) a = __dadd_rn(a, x.a[w]);
  }
  return __dadd_rn(pre, e);
}

// Group totals of b (float64) and c.
template <bool kWarp>
__device__ __forceinline__ void sum2(double& b, int& c, const Xchg& x) {
  b = warp_sum(b);
  c = __reduce_add_sync(~0u, c);
  if (kWarp) return;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) { x.b[warp] = b; x.c[warp] = c; }
  __syncthreads();
  b = x.b[0];
  c = x.c[0];
  for (int w = 1; w < nw; ++w) { b = __dadd_rn(b, x.b[w]); c += x.c[w]; }
}

// A request's exec time e and slack x in a batch of b members: the
// largest batch wait under which it still meets its SLO (-inf when the
// TPOT SLO fails at this size, +inf when it is padding).
__device__ __forceinline__ void member(const float* r, float b, float& x,
                                       float& e, bool& live) {
  e = __fmaf_rn(r[kEA], b, r[kEC]);
  const float pref = __fmaf_rn(r[kPA], b, r[kPC]);
  const bool tpot_ok = __fmaf_rn(r[kTA], b, r[kTC]) <= r[kSP];
  const float s = r[kH] == 1.f ? __fsub_rn(r[kSE], e)
                  : tpot_ok    ? __fsub_rn(r[kST], pref)
                               : -INFINITY;
  live = r[kValid] > 0.f;
  x = live ? s : INFINITY;
}

// One batch row by a group of g lanes (q: this lane's index in it, gmask
// the group's lanes; every lane of the warp calls this): each member at
// start .. start+size-1 (request perm_at(p)) puts its slack in slot k,
// put(k, x), in member order (a row's slacks need no order: only how
// many lie below a wait counts), its exec time in ex[k]; then the valid
// count by ballots, and the member sum left to right in float32 and the
// duration, the same in every lane of the group.
template <class PermAt, class Put>
__device__ __forceinline__ void row_group(const Req& rq, PermAt perm_at,
                                          int start, int size, int mb, int g,
                                          int q, unsigned gmask, float* ex,
                                          Put put, int& cnt, float& se,
                                          float& bd) {
  const float b = static_cast<float>(size);
  cnt = 0;
  for (int k0 = 0; k0 < mb; k0 += g) {     // the same trip count in a warp
    const int k = k0 + q;
    bool live = false;
    if (k < size) {
      float x, e;
      member(rq.row(perm_at(start + k)), b, x, e, live);
      put(k, x);
      ex[k] = e;
    }
    cnt += __popc(__ballot_sync(~0u, live) & gmask);
  }
  __syncwarp();
  se = 0.f;
  bd = 0.f;
#pragma unroll 8
  for (int m = 0; m < size; ++m) {
    const float v = ex[m];
    se = m ? __fadd_rn(se, v) : v;
    bd = m ? fmaxf(bd, v) : v;
  }
  __syncwarp();
}

// The three rows a proposal rebuilds: (start, new size) each; then
// their valid counts, member sums and durations.
struct Cand {
  int st[3], sz[3], cnt[3];
  float se[3], bd[3];
};

template <class T>
__device__ __forceinline__ T sel3(const T (&a)[3], int r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : a[2];
}

// The rows of c by one warp, their counts, sums and durations through
// meta (ints at meta_i, floats at meta_f) to every thread of the block
// after the next barrier: at max_batch <= 10 three groups of 10 lanes
// build one row each at once, else the warp builds them in turn.
template <class PermAt>
__device__ __forceinline__ void rows_warp(const Req& rq, PermAt perm_at,
                                          const Cand& c, int mb, float* ex,
                                          float* csl, int* meta_i,
                                          float* meta_f) {
  const int lane = threadIdx.x & 31;
  const bool par = mb <= kParBatch;
  for (int pass = 0; pass < (par ? 1 : 3); ++pass) {
    const int r = par ? lane / kParBatch : pass;   // 3: lanes 30, 31 idle
    const int g = par ? kParBatch : 32;
    const int q = par ? lane - r * kParBatch : lane;
    const unsigned gmask = !par ? ~0u : r > 2 ? 0u
                                      : ((1u << kParBatch) - 1) << (r * g);
    const int rr = r > 2 ? 0 : r;
    float* out = csl + rr * mb;
    int cnt;
    float se, bd;
    row_group(rq, perm_at, sel3(c.st, rr), r > 2 ? 0 : sel3(c.sz, r), mb, g,
              q, gmask, ex + rr * (mb + 1), [&](int k, float x) { out[k] = x; },
              cnt, se, bd);
    if (q == 0 && r < 3) {
      meta_i[r] = cnt;
      meta_f[r] = se;
      meta_f[3 + r] = bd;
    }
  }
}

// The row overriding position p's committed stats, or -1.
__device__ __forceinline__ int pick(const Cand& c, int p) {
  return p == c.st[0] ? 0 : p == c.st[1] ? 1 : p == c.st[2] ? 2 : -1;
}

// The rebuilt row holding position p (st <= p < st + size), or -1.
__device__ __forceinline__ int cover(const Cand& c, int p) {
  auto in = [&](int r) {
    return static_cast<unsigned>(p - c.st[r]) < static_cast<unsigned>(c.sz[r]);
  };
  return in(0) ? 0 : in(1) ? 1 : in(2) ? 2 : -1;
}

// Score the committed stats with c's rows overriding theirs (starts -1:
// none; duplicate starts carry identical rows): waits are the exclusive
// prefix of the batch durations; a batch's met count is its valid
// members minus the slacks below its wait.  G = met / (sum of member
// exec + sum of valid members x wait).  [lo, hi): this thread's range.
// The slacks below a wait are counted where they lie, a position each:
// position p holds the slack of the k-th member of the batch starting at
// start(p) = p - k, which waits the prefix at that start, the prefix at
// p less the start's duration (exact: see the note on sums).
template <bool kWarp>
__device__ __forceinline__ void score_inc(const State& s, const Cand& c,
                                          const float* csl, int mb, int lo,
                                          int hi, const Xchg& x, float& g,
                                          int& met) {
  double sb = 0.0, a = 0.0;
  for (int p = lo; p < hi; ++p) {
    const int r = pick(c, p);
    const Stat v = s.stat(p);
    sb = __dadd_rn(sb, static_cast<double>(r >= 0 ? sel3(c.bd, r) : v.bdur));
    a = __dadd_rn(a, static_cast<double>(r >= 0 ? sel3(c.se, r) : v.sume));
  }
  double run = scan_sum<kWarp, true>(sb, a, x);
  double b = 0.0;
  int cc = 0;
  for (int p = lo; p < hi; ++p) {
    const int r = pick(c, p);
    const Stat v = s.stat(p);
    const int cnt = r >= 0 ? sel3(c.cnt, r) : v.cnt;
    const float w = __double2float_rn(run);
    cc += cnt;
    b = __dadd_rn(b, static_cast<double>(
                         __fmul_rn(static_cast<float>(cnt), w)));
    const int rr = cover(c, p);
    const int start = rr >= 0 ? sel3(c.st, rr) : s.st[p];
    const int k = p - start;
    const float x = rr >= 0 ? csl[rr * mb + k] : s.slk(p);   // +inf: padding
    const double bd_s = rr >= 0 ? sel3(c.bd, rr) : s.stat(start).bdur;
    cc -= x < (k ? __double2float_rn(__dsub_rn(run, bd_s)) : w);
    run = __dadd_rn(run, static_cast<double>(r >= 0 ? sel3(c.bd, r)
                                                    : v.bdur));
  }
  sum2<kWarp>(b, cc, x);
  const float total = __fadd_rn(__double2float_rn(a), __double2float_rn(b));
  g = div_rn(static_cast<float>(cc), fmaxf(total, 1e-12f));
  met = cc;
}

// The full Eq. 2 objective of (perm_at, with the batches of the
// committed boundaries and c's rows overriding theirs), the oracle path,
// a position each: its exec time at its batch's size; each batch's
// duration, the largest of its members'; the waits by a scan over the
// batch starts; then every member's e2e / TTFT / TPOT against its SLO.
// The full path keeps only the sizes in stats[]: the other fields hold
// each position's exec time (bdur), a start's duration (cnt, as bits)
// and wait (sume) while it scores.
template <bool kWarp, class PermAt>
__device__ __forceinline__ void score_full(const State& s, const Req& rq,
                                           PermAt perm_at, const Cand& c,
                                           int lo, int hi, const Xchg& x,
                                           float& g, int& met) {
  auto find = [&](int p, int& start, int& size) {
    const int rr = cover(c, p);
    start = rr >= 0 ? sel3(c.st, rr) : s.st[p];
    size = rr >= 0 ? sel3(c.sz, rr) : s.stat(start).bsz;
  };
  int start0 = 0, size0 = 0;     // the first position's, kept across passes
  if (lo < hi) find(lo, start0, size0);
  auto batch = [&](int p, int& start, int& size) {
    if (p == lo) { start = start0; size = size0; } else find(p, start, size);
  };
  for (int p = lo; p < hi; ++p) {
    int start, size;
    batch(p, start, size);
    const float* r = rq.row(perm_at(p));
    s.stat(p).bdur = __fmaf_rn(r[kEA], static_cast<float>(size), r[kEC]);
  }
  gsync<kWarp>();
  double sb = 0.0, unused = 0.0;
  for (int p = lo; p < hi; ++p) {
    int start, size;
    batch(p, start, size);
    if (start != p) continue;
    float bd = s.stat(p).bdur;
#pragma unroll 4
    for (int k = 1; k < size; ++k) bd = fmaxf(bd, s.stat(p + k).bdur);
    s.stat(p).cnt = __float_as_int(bd);
    sb = __dadd_rn(sb, static_cast<double>(bd));
  }
  double run = scan_sum<kWarp, false>(sb, unused, x);
  for (int p = lo; p < hi; ++p) {
    int start, size;
    batch(p, start, size);
    if (start != p) continue;
    s.stat(p).sume = __double2float_rn(run);
    run = __dadd_rn(run, static_cast<double>(__int_as_float(s.stat(p).cnt)));
  }
  gsync<kWarp>();
  double a = 0.0;
  int cm = 0;
  for (int p = lo; p < hi; ++p) {
    int start, size;
    batch(p, start, size);
    const float* r = rq.row(perm_at(p));
    const float b = static_cast<float>(size);
    const float t_wait = s.stat(start).sume;
    const float e2e = __fadd_rn(s.stat(p).bdur, t_wait);
    const float ttft = __fadd_rn(__fmaf_rn(r[kPA], b, r[kPC]), t_wait);
    const float tpot = __fmaf_rn(r[kTA], b, r[kTC]);
    const bool ok = r[kH] == 1.f ? e2e <= r[kSE]
                                 : (ttft <= r[kST]) && (tpot <= r[kSP]);
    if (r[kValid] > 0.f) {
      cm += ok;
      a = __dadd_rn(a, static_cast<double>(e2e));
    }
  }
  sum2<kWarp>(a, cm, x);
  g = div_rn(static_cast<float>(cm), fmaxf(__double2float_rn(a), 1e-12f));
  met = cm;
}

// Stats rows of a whole schedule (perm_at, with the sizes in
// stats[].bsz), each thread the rows starting in its range.  Starts and
// ends with a barrier.
template <bool kWarp, class PermAt>
__device__ __forceinline__ void build_stats(const Req& rq, PermAt perm_at,
                                            const State& s, int lo, int hi) {
  gsync<kWarp>();               // the last reads of the old rows are done
  for (int p = lo; p < hi; ++p) {
    const int size = s.stat(p).bsz;
    if (size == 0) continue;
    const float b = static_cast<float>(size);
    float se = 0.f, bd = 0.f;
    int cnt = 0;
    for (int k = 0; k < size; ++k) {
      float x, e;
      bool live;
      member(rq.row(perm_at(p + k)), b, x, e, live);
      s.slk(p + k) = x;
      se = k ? __fadd_rn(se, e) : e;
      bd = k ? fmaxf(bd, e) : e;
      cnt += live;
    }
    s.stat(p) = Stat{bd, se, cnt, size};
  }
  gsync<kWarp>();
}

// Ascending (key, index) order of P = 2^m pairs: a bitonic network, the
// same order as a stable argsort of the keys.  Ends with a barrier.
template <bool kWarp>
__device__ __forceinline__ void sort_pairs(float* key, int* idx, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int q = threadIdx.x; q < P / 2; q += blockDim.x) {
        const int a = 2 * q - (q & (jj - 1)), b = a + jj;
        const float ka = key[a], kb = key[b];
        const int ia = idx[a], ib = idx[b];
        const bool after = ka > kb || (ka == kb && ia > ib);
        if (after == ((a & k) == 0)) {
          key[a] = kb; key[b] = ka;
          idx[a] = ib; idx[b] = ia;
        }
      }
      gsync<kWarp>();
    }
  }
}

// Commit an accepted move: the <= 3 rows (stats, slacks, batch starts),
// <= 2 perm entries and <= 2 boundary bits.  Rows that share a start are
// identical, and the others cover disjoint positions.
template <bool kWarp, bool kInc>
__device__ __forceinline__ void commit(const State& s, const Cand& c,
                                       const float* csl, int mb, int op,
                                       int i, int j, int i2, int pi, int pj,
                                       int n) {
  // every thread has read the old state: the block plan's last barrier
  // (the sums') came after its reads
  if (kWarp) __syncwarp();
  const int t = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int st = c.st[r], sz = c.sz[r];
    for (int k = t; k < sz; k += nt) {
      s.st[st + k] = st;
      if (kInc) s.slk(st + k) = csl[r * mb + k];
    }
    if (t == 0)
      s.stat(st) = kInc ? Stat{c.bd[r], c.se[r], c.cnt[r], sz}
                         : Stat{0.f, 0.f, 0, sz};
  }
  if (t == 0) {
    if (op == 0) { s.bnd[i] = 0; if (i + 1 < n) s.bnd[i2] = 1; }
    else if (op == 1) s.bnd[i] = 1;
    else { s.perm(i) = pj; s.perm(j) = pi; }
  }
  gsync<kWarp>();
}

// One block an SM is all the plan needs (a chain is latency-bound), and
// saying so lets ptxas keep the loop's state in registers: without the
// minimum it trims registers towards more blocks and spills.
// kSmem: the state and the request rows both in shared memory, known to
// the compiler (shared loads; the other block instance takes generic
// ones, which may reach the workspace or reqc in device memory).
template <bool kInc, bool kWarp, bool kSmem>
__global__ void __launch_bounds__(kWarp ? 32 : kBlockMax, 1)
anneal_kernel(const float* __restrict__ reqc, const int* __restrict__ n_valid,
              const float* __restrict__ draws, int* __restrict__ out_perm,
              unsigned char* __restrict__ out_bnd, float* __restrict__ out_g,
              unsigned char* __restrict__ work, int chains, int n,
              int n_prop, int mb, int iters, int rq_in_smem, int st_in_smem,
              float T0, float T_thres, float tau) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int chain = blockIdx.x, inst = chain / chains;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nt = blockDim.x;
  const bool rq_smem = kSmem || rq_in_smem, st_smem = kSmem || st_in_smem;
  const Layout L = layout(n, mb, kInc, nt / 32, rq_smem, st_smem);
  const float* rq_g = reqc + static_cast<size_t>(inst) * n * kCols;
  const float* dr = draws + static_cast<size_t>(chain) * n_prop * 4;
  const int nv = n_valid[inst];
  float4* tile = reinterpret_cast<float4*>(dsm + L.tiles) + warp * 2 * kTile;
  double* xd = reinterpret_cast<double*>(dsm + L.xchg);
  const Xchg x{xd, xd + 32, xd + 64, reinterpret_cast<int*>(xd + 96)};
  float* pair = reinterpret_cast<float*>(dsm + L.pair);
  float* csl = reinterpret_cast<float*>(dsm + L.csl);
  int* meta_i = reinterpret_cast<int*>(dsm + L.meta);
  float* meta_f = reinterpret_cast<float*>(dsm + L.meta + 32);
  float* rq_s = reinterpret_cast<float*>(dsm + L.rq);
  const State s = carve(st_smem ? dsm + L.state
                                : work + static_cast<size_t>(chain) *
                                             state_bytes(n, kInc),
                        n, kInc);
  const int len = (n + nt - 1) / nt;
  const int lo = min(n, t * len), hi = min(n, lo + len);

  // the chain's first draw tile, in flight while the start is built
  auto fetch = [&](int tl) {
    const int kk = tl * kTile + lane;
    if (kk < n_prop)
      cp_async16(tile + (tl & 1) * kTile + lane, dr + static_cast<size_t>(kk) * 4);
    cp_async_commit();
  };
  fetch(0);

  // ---- the instance's request rows, staged where they fit
  if (rq_smem)
    for (int q = t; q < n * kCols; q += nt)
      rq_s[(q / kCols) * 12 + q % kCols] = __ldg(rq_g + q);
  const Req rq = rq_smem ? Req{rq_s, 12} : Req{rq_g, kCols};
  gsync<kWarp>();

  // ---- the two starting solutions: predicted-e2e order (stable) and
  // arrival order, maximal batches over the real prefix
  {
    int P = 1;
    while (P < n) P <<= 1;
    float* key = reinterpret_cast<float*>(s.stats);
    int* idx = reinterpret_cast<int*>(key + P);
    const float fmb = static_cast<float>(mb);
    for (int p = t; p < P; p += nt) {
      float k = INFINITY;
      if (p < n) {
        const float* r = rq.row(p);
        if (r[kValid] > 0.f) k = __fmaf_rn(r[kEA], fmb, r[kEC]);
      }
      key[p] = k;
      idx[p] = p;
    }
    gsync<kWarp>();
    sort_pairs<kWarp>(key, idx, P);
    for (int p = t; p < n; p += nt) s.bp[p] = idx[p];
    gsync<kWarp>();
  }
  for (int p = t; p < n; p += nt) {
    const bool start = p % mb == 0 || p >= nv;
    s.perm(p) = p;
    s.bnd[p] = start;
    s.st[p] = p < nv ? p - p % mb : p;
    s.stat(p) = Stat{0.f, 0.f, 0,
                      !start ? 0 : p < nv ? min(p + mb, nv) - p : 1};
  }
  gsync<kWarp>();
  auto ident = [](int p) { return p; };
  auto sorted_at = [&](int p) { return s.bp[p]; };
  Cand none;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    none.st[r] = -1; none.sz[r] = 0; none.cnt[r] = 0;
    none.se[r] = 0.f; none.bd[r] = 0.f;
  }
  float f_a, f_s;
  int met_a, met_s;
  if (kInc) {
    build_stats<kWarp>(rq, ident, s, lo, hi);
    score_inc<kWarp>(s, none, csl, mb, lo, hi, x, f_a, met_a);
    build_stats<kWarp>(rq, sorted_at, s, lo, hi);
    score_inc<kWarp>(s, none, csl, mb, lo, hi, x, f_s, met_s);
  } else {
    score_full<kWarp>(s, rq, ident, none, lo, hi, x, f_a, met_a);
    score_full<kWarp>(s, rq, sorted_at, none, lo, hi, x, f_s, met_s);
  }
  const bool pick_s = f_s >= f_a;
  for (int p = t; p < n; p += nt) {
    if (pick_s) s.perm(p) = s.bp[p]; else s.bp[p] = p;
    s.bb[p] = s.bnd[p];
  }
  gsync<kWarp>();
  if (kInc && !pick_s) build_stats<kWarp>(rq, ident, s, lo, hi);
  float f = pick_s ? f_s : f_a;
  int met = pick_s ? met_s : met_a;
  const float f_ref = fmaxf(f, 1e-12f);
  float bf = f;
  int bmet = met;

  // ---- temperature levels (the line-7 early exit in the condition)
  float T = T0;
  int k = 0;
  while (T >= T_thres && bmet < nv && k + iters <= n_prop) {
    const float scale = div_rn(__fmul_rn(f_ref, T), T0);   // as the plain
    for (int it = 0; it < iters; ++it, ++k) {
      if ((k & (kTile - 1)) == 0) {       // next tile in, the one after out
        cp_async_wait_all();
        __syncwarp();
        fetch(k / kTile + 1);
      }
      const float4 u = tile[((k / kTile) & 1) * kTile + (k & (kTile - 1))];
      const int op = min(static_cast<int>(__fmul_rn(u.x, 3.f)), 2);
      const int hi_i = max(nv, 2), lo_n = max(nv, 1);
      const int i = min(1 + static_cast<int>(__fmul_rn(
                                u.y, static_cast<float>(hi_i - 1))),
                        hi_i - 1);
      const int j = min(static_cast<int>(__fmul_rn(
                            u.z, static_cast<float>(lo_n))),
                        lo_n - 1);
      // move descriptors, computed alike by every thread
      const bool bnd_i = s.bnd[i];
      const int a_im1 = s.st[i - 1];
      const int i2 = min(i + 1, n - 1);
      const bool ok = i < nv && (op == 0 ? bnd_i && i - a_im1 < mb
                                 : op == 1 ? !bnd_i : j < nv);
      if (!ok) continue;
      const int pi = s.perm(i), pj = s.perm(j);
      const int a_i = bnd_i ? i : a_im1, a_j = s.st[j];
      const int s_prev = s.stat(a_im1).bsz, s_cur = s.stat(i).bsz;
      const int s_old = s.stat(a_i).bsz, s_j = s.stat(a_j).bsz;
      const int left = i - a_i;
      Cand c;
      if (op == 0) {
        c.st[0] = a_im1; c.st[1] = i; c.st[2] = i2;
        c.sz[0] = s_prev + 1; c.sz[1] = 0;
        c.sz[2] = s_cur > 1 ? s_cur - 1 : (i2 == i ? 0 : s.stat(i2).bsz);
      } else if (op == 1) {
        c.st[0] = a_i; c.st[1] = i; c.st[2] = i;
        c.sz[0] = left; c.sz[1] = s_old - left; c.sz[2] = s_old - left;
      } else {
        c.st[0] = a_i; c.st[1] = a_j; c.st[2] = a_j;
        c.sz[0] = s_old; c.sz[1] = s_j; c.sz[2] = s_j;
      }
      auto perm_c = [&](int p) {
        if (op == 2) {
          if (p == i) return pj;
          if (p == j) return pi;
        }
        return s.perm(p);
      };
      float f_new;
      int met_new;
      if (kInc) {
        if (kWarp) {
          rows_warp(rq, perm_c, c, mb, pair, csl, meta_i, meta_f);
        } else if (t < 96) {             // warp r builds row r
          const int r = warp;
          int cnt;
          float se, bd;
          float* out = csl + r * mb;
          row_group(rq, perm_c, sel3(c.st, r), sel3(c.sz, r), mb, 32, lane,
                    ~0u, pair + r * (mb + 1),
                    [&](int q, float v) { out[q] = v; }, cnt, se, bd);
          if (lane == 0) { meta_i[r] = cnt; meta_f[r] = se; meta_f[3 + r] = bd; }
        }
        gsync<kWarp>();
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          c.cnt[r] = meta_i[r]; c.se[r] = meta_f[r]; c.bd[r] = meta_f[3 + r];
        }
        score_inc<kWarp>(s, c, csl, mb, lo, hi, x, f_new, met_new);
      } else {
        score_full<kWarp>(s, rq, perm_c, c, lo, hi, x, f_new, met_new);
      }
      bool accept = f_new > f;
      if (!accept) {
        const float p_acc = expf(div_rn(__fsub_rn(f_new, f), scale));
        accept = u.w < p_acc;
      }
      if (!accept) continue;
      commit<kWarp, kInc>(s, c, csl, mb, op, i, j, i2, pi, pj, n);
      f = f_new;
      met = met_new;
      if (f > bf) {
        for (int p = t; p < n; p += nt) {
          s.bp[p] = s.perm(p);
          s.bb[p] = s.bnd[p];
        }
        bf = f;
        bmet = met;
      }
    }
    T = __fmul_rn(T, tau);
  }
  cp_async_wait_all();
  gsync<kWarp>();
  int* op_ = out_perm + static_cast<size_t>(chain) * n;
  unsigned char* ob = out_bnd + static_cast<size_t>(chain) * n;
  for (int p = t; p < n; p += nt) {
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
  if (plan_of(n, mb, inc).st_smem) return 0;
  return static_cast<long long>(n_inst) * chains * state_bytes(n, inc);
}

// The launch plan at these shapes: threads a block (bits 0-15; 32 is a
// warp per chain), the request rows in shared memory (bit 16), the
// state in shared memory (bit 17).
extern "C" int anneal_plan(int n, int mb, int incremental) {
  const Plan p = plan_of(n, mb, incremental != 0);
  return p.threads | (p.rq_smem ? 1 << 16 : 0) | (p.st_smem ? 1 << 17 : 0);
}

// work holds anneal_workspace_bytes(...) bytes (none when that is 0).
extern "C" int anneal(const float* reqc, const int* n_valid,
                      const float* draws, int* out_perm,
                      unsigned char* out_bnd, float* out_g,
                      unsigned char* work, int n_inst, int chains, int n,
                      int n_prop, int mb, int iters, int incremental,
                      float T0, float T_thres, float tau,
                      cudaStream_t stream) {
  const bool inc = incremental != 0;
  const Plan p = plan_of(n, mb, inc);
  const bool smem = p.rq_smem && p.st_smem;   // always on the warp plan
  auto kern = inc ? (p.warp  ? anneal_kernel<true, true, true>
                     : smem ? anneal_kernel<true, false, true>
                            : anneal_kernel<true, false, false>)
                  : (p.warp  ? anneal_kernel<false, true, true>
                     : smem ? anneal_kernel<false, false, true>
                            : anneal_kernel<false, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_inst * chains, p.threads, p.smem, stream>>>(
      reqc, n_valid, draws, out_perm, out_bnd, out_g, work, chains, n,
      n_prop, mb, iters, p.rq_smem, p.st_smem, T0, T_thres, tau);
  return static_cast<int>(cudaGetLastError());
}
