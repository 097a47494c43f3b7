// Backward of the Mamba2 SSD chunk scan (state-space duality,
// arXiv:2405.21060) for Hopper (sm_90a), in f32 on the CUDA cores.
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
//   -> dx [b,s,nh,hd], ddt [b,s,nh], dA partials [b,nh], dB and dC
//      partials [b,s,nh,ds] (one per head; the wrapper sums them over
//      heads and batch rows in a fixed order), dinit [b,nh,hd,ds].
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
// What bounds it on the card: operations.  Per chunk of 32 rows and head
// it does ~2·(5·32·hd·ds + 32²·(ds + hd)) flops (the five hd x ds
// products above and the recomputed state, the 32 x 32 C·Bᵀ and dy·uᵀ
// tiles): 10.7 MFLOP at hd 64 / ds 128 on ~100 KB of input, far above the
// card's f32 ridge.  The design (simple first: f32 FMAs on the CUDA cores;
// 3xTF32 mma.sync as in the forward is later work):
//   * one 256-thread block per (batch, head) owns all of hd, so the
//     per-head partials of dB, dC and dA need no sum across blocks, and
//     nothing is added with atomics: every output is bitwise repeatable.
//   * the states before each chunk are needed in reverse order: a first
//     pass walks the chunks forward and writes each into a float32
//     workspace [b, nc, nh, hd, ds] (the state in registers, 32 elements
//     a thread); the reverse pass reads the chunk's back into shared
//     memory.
//   * the chunk's B, C, x, u, dy, the state, the carried gradient and the
//     three 32 x 32 tiles live in shared memory (~138 KB, one block an
//     SM); row pitches are odd (width + 1), so a warp reading down a
//     column or along a row hits 32 banks.  Each output row is owned by
//     one warp, its columns by the lanes, and its row sums (u·dS'B, x·du,
//     C·Sᵀdy) are warp shuffles.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 32;                 // rows per chunk (one per lane)
constexpr int kHD = 64;                // widest head (ssd_scan.py)
constexpr int kDS = 128;               // widest state (ssd_scan.py)
constexpr int kPD = kDS + 1;           // pitch of a ds-wide row
constexpr int kPH = kHD + 1;           // pitch of an hd-wide row
constexpr int kPQ = kQ + 1;            // pitch of a 32 x 32 tile's row
constexpr int kRows = kQ / kWarps;     // rows a warp owns
constexpr int kStateRegs = kHD * kDS / kThreads;  // state elements a thread
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  float B[kQ * kPD];
  float C[kQ * kPD];
  float x[kQ * kPH];
  float u[kQ * kPH];      // dt_j x_j
  float dy[kQ * kPH];
  float S[kHD * kPD];     // the state before the chunk
  float dS[kHD * kPD];    // dS' on entry to a chunk, dS on leaving it
  float M[kQ * kPQ];      // (C_i·B_j) e^{c_i−c_j}, j <= i, else 0
  float P[kQ * kPQ];      // (dy_i·u_j) e^{c_i−c_j}, j <= i, else 0
  float W[kQ * kPQ];      // M_ij (dy_i·u_j)
  float dt[kQ], c[kQ], eC[kQ], eL[kQ];
  float q[kQ];            // u_j·(dS' B_j)
  float r[kQ];            // C_i·(Sᵀ dy_i)
  float ddt[kQ];          // x_j·du_j
  float red[kWarps];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Rows [chunk0, chunk0 + 32) of x, dt (and u = dt·x), B, and, with
// `full`, C and dy, zero past s.  Then warp 0: a = dt·A, its running sum
// c, e^{c} and e^{c_L − c}.
__device__ void load_chunk(Smem& sm, const float* x, const float* dt,
                           const float* B, const float* C, const float* dy,
                           float Ah, int bi, int h, int chunk0, int S,
                           int NH, int HD, int DS, bool full) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kQ; i += kThreads) {
    const int t = chunk0 + i;
    sm.dt[i] = t < S ? dt[((size_t)bi * S + t) * NH + h] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < kQ * HD; e += kThreads) {
    const int i = e / HD, p = e - i * HD, t = chunk0 + i;
    float xv = 0.f, gv = 0.f;
    if (t < S) {
      const size_t off = (((size_t)bi * S + t) * NH + h) * HD + p;
      xv = x[off];
      if (full) gv = dy[off];
    }
    sm.x[i * kPH + p] = xv;
    sm.u[i * kPH + p] = sm.dt[i] * xv;
    if (full) sm.dy[i * kPH + p] = gv;
  }
  for (int e = tid; e < kQ * DS; e += kThreads) {
    const int i = e / DS, d = e - i * DS, t = chunk0 + i;
    const size_t off = ((size_t)bi * S + t) * DS + d;
    sm.B[i * kPD + d] = t < S ? B[off] : 0.f;
    if (full) sm.C[i * kPD + d] = t < S ? C[off] : 0.f;
  }
  if (tid < 32) {
    float v = sm.dt[tid] * Ah;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFull, v, o);
      if (tid >= o) v += n;
    }
    const float last = __shfl_sync(kFull, v, kQ - 1);
    sm.c[tid] = v;
    sm.eC[tid] = expf(v);
    sm.eL[tid] = expf(last - v);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ C,
                    const float* __restrict__ init_state,
                    const float* __restrict__ dy,
                    const float* __restrict__ dfinal,
                    float* __restrict__ states, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ dA_part,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dinit, int S, int NH, int HD,
                    int DS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + kQ - 1) / kQ;
  const int HDS = HD * DS;
  const float Ah = A[h];
  const size_t head = ((size_t)bi * NH + h) * HDS;

  // ---- pass 1: the state before every chunk, into the workspace
  float st[kStateRegs];
#pragma unroll
  for (int k = 0; k < kStateRegs; ++k) {
    const int e = tid + k * kThreads;
    st[k] = init_state != nullptr && e < HDS ? init_state[head + e] : 0.f;
  }
  for (int n = 0; n < nc; ++n) {
    float* out = states + (((size_t)bi * nc + n) * NH + h) * HDS;
#pragma unroll
    for (int k = 0; k < kStateRegs; ++k) {
      const int e = tid + k * kThreads;
      if (e < HDS) out[e] = st[k];
    }
    if (n == nc - 1) break;           // the last chunk's update is unused
    load_chunk(sm, x, dt, B, C, dy, Ah, bi, h, n * kQ, S, NH, HD, DS,
               false);
    const float decay = sm.eC[kQ - 1];
#pragma unroll
    for (int k = 0; k < kStateRegs; ++k) {
      const int e = tid + k * kThreads;
      if (e < HDS) {
        const int p = e / DS, d = e - p * DS;
        float acc = decay * st[k];
#pragma unroll 8
        for (int i = 0; i < kQ; ++i)
          acc = fmaf(sm.eL[i] * sm.u[i * kPH + p], sm.B[i * kPD + d], acc);
        st[k] = acc;
      }
    }
    __syncthreads();                  // the chunk's rows are refilled next
  }

  // ---- pass 2: the chunks in reverse, dS' from dfinal
  for (int e = tid; e < HDS; e += kThreads) {
    const int p = e / DS, d = e - p * DS;
    sm.dS[p * kPD + d] = dfinal != nullptr ? dfinal[head + e] : 0.f;
  }
  float dA_acc = 0.f;                 // warp 0: lane = row
  for (int n = nc - 1; n >= 0; --n) {
    const int chunk0 = n * kQ;
    const float* sprev = states + (((size_t)bi * nc + n) * NH + h) * HDS;
    for (int e = tid; e < HDS; e += kThreads) {
      const int p = e / DS, d = e - p * DS;
      sm.S[p * kPD + d] = sprev[e];
    }
    load_chunk(sm, x, dt, B, C, dy, Ah, bi, h, chunk0, S, NH, HD, DS, true);

    // -- the 32 x 32 tiles, causal side only
    for (int e = tid; e < kQ * kQ; e += kThreads) {
      const int i = e >> 5, j = e & 31;
      float m = 0.f, pv = 0.f, w = 0.f;
      if (j <= i) {
        float g = 0.f, du = 0.f;
        for (int d = 0; d < DS; ++d)
          g = fmaf(sm.C[i * kPD + d], sm.B[j * kPD + d], g);
        for (int p = 0; p < HD; ++p)
          du = fmaf(sm.dy[i * kPH + p], sm.u[j * kPH + p], du);
        const float E = expf(sm.c[i] - sm.c[j]);
        m = g * E;
        pv = du * E;
        w = m * du;
      }
      sm.M[i * kPQ + j] = m;
      sm.P[i * kPQ + j] = pv;
      sm.W[i * kPQ + j] = w;
    }
    __syncthreads();

    // -- hd-wide rows: du, dx; q_j = u_j·(dS' B_j), x_j·du_j
#pragma unroll 1
    for (int m = 0; m < kRows; ++m) {
      const int j = warp + kWarps * m, t = chunk0 + j;
      float qp = 0.f, xp = 0.f;
#pragma unroll
      for (int k = 0; k < kHD / 32; ++k) {
        const int p = lane + 32 * k;
        if (p < HD) {
          float dsb = 0.f;
          for (int d = 0; d < DS; ++d)
            dsb = fmaf(sm.dS[p * kPD + d], sm.B[j * kPD + d], dsb);
          float du = sm.eL[j] * dsb;
          for (int i = j; i < kQ; ++i)
            du = fmaf(sm.M[i * kPQ + j], sm.dy[i * kPH + p], du);
          if (t < S)
            dx[(((size_t)bi * S + t) * NH + h) * HD + p] = sm.dt[j] * du;
          qp = fmaf(sm.u[j * kPH + p], dsb, qp);
          xp = fmaf(sm.x[j * kPH + p], du, xp);
        }
      }
      qp = warp_sum(qp);
      xp = warp_sum(xp);
      if (lane == 0) {
        sm.q[j] = qp;
        sm.ddt[j] = xp;
      }
    }

    // -- ds-wide rows: dC_i, dB_i; r_i = C_i·(Sᵀ dy_i)
#pragma unroll 1
    for (int m = 0; m < kRows; ++m) {
      const int i = warp + kWarps * m, t = chunk0 + i;
      float rp = 0.f;
#pragma unroll
      for (int k = 0; k < kDS / 32; ++k) {
        const int d = lane + 32 * k;
        if (d < DS) {
          float sdy = 0.f, dsu = 0.f;
          for (int p = 0; p < HD; ++p) {
            sdy = fmaf(sm.S[p * kPD + d], sm.dy[i * kPH + p], sdy);
            dsu = fmaf(sm.dS[p * kPD + d], sm.u[i * kPH + p], dsu);
          }
          float dc = sm.eC[i] * sdy;
          for (int j = 0; j <= i; ++j)
            dc = fmaf(sm.P[i * kPQ + j], sm.B[j * kPD + d], dc);
          float db = sm.eL[i] * dsu;
          for (int j = i; j < kQ; ++j)
            db = fmaf(sm.P[j * kPQ + i], sm.C[j * kPD + d], db);
          rp = fmaf(sm.C[i * kPD + d], sdy, rp);
          if (t < S) {
            const size_t off = (((size_t)bi * S + t) * NH + h) * DS + d;
            dC_part[off] = dc;
            dB_part[off] = db;
          }
        }
      }
      rp = warp_sum(rp);
      if (lane == 0) sm.r[i] = rp;
    }
    __syncthreads();                  // every read of dS' is done

    // -- dS = e^{c_L} dS' + Σ_i e^{c_i} dy_i ⊗ C_i, and <dS', S>
    const float decay = sm.eC[kQ - 1];
    float dot = 0.f;
#pragma unroll 1
    for (int e = tid; e < HDS; e += kThreads) {
      const int p = e / DS, d = e - p * DS;
      const float old = sm.dS[p * kPD + d];
      dot = fmaf(old, sm.S[p * kPD + d], dot);
      float acc = decay * old;
#pragma unroll 8
      for (int i = 0; i < kQ; ++i)
        acc = fmaf(sm.eC[i] * sm.dy[i * kPH + p], sm.C[i * kPD + d], acc);
      sm.dS[p * kPD + d] = acc;
    }
    dot = warp_sum(dot);
    if (lane == 0) sm.red[warp] = dot;
    __syncthreads();

    // -- dc, its suffix sums da, ddt and dA (warp 0, lane = row)
    if (warp == 0) {
      const int i = lane, t = chunk0 + i;
      float sdot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sdot += sm.red[w];
      float wr = 0.f, wc = 0.f;
      for (int j = 0; j < i; ++j) wr += sm.W[i * kPQ + j];
      for (int k = i + 1; k < kQ; ++k) wc += sm.W[k * kPQ + i];
      const float lq = sm.eL[i] * sm.q[i];
      float dc = wr - wc + sm.eC[i] * sm.r[i] - lq;
      const float tot = warp_sum(lq);
      if (i == kQ - 1) dc += sm.eC[kQ - 1] * sdot + tot;
      float da = dc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nb = __shfl_down_sync(kFull, da, o);
        if (lane + o < 32) da += nb;
      }
      if (t < S) ddt[((size_t)bi * S + t) * NH + h] = fmaf(Ah, da, sm.ddt[i]);
      dA_acc = fmaf(sm.dt[i], da, dA_acc);
    }
    __syncthreads();                  // the chunk's rows are refilled next
  }

  if (dinit != nullptr)
    for (int e = tid; e < HDS; e += kThreads) {
      const int p = e / DS, d = e - p * DS;
      dinit[head + e] = sm.dS[p * kPD + d];
    }
  if (warp == 0) {
    const float v = warp_sum(dA_acc);
    if (lane == 0) dA_part[(size_t)bi * NH + h] = v;
  }
}

}  // namespace

// All pointers float32.  init_state and dfinal may be null (zeros), and
// dinit null when no gradient of the initial state is wanted.
// states: workspace [batch, ceil(seq_len / 32), num_heads, head_dim,
// d_state], written and read within the call.  dA_part [batch, num_heads];
// dB_part, dC_part [batch, seq_len, num_heads, d_state]: one partial per
// head, summed by the caller.  One launch.  Returns the launch's error
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* B, const void* C,
                            const void* init_state, const void* dy,
                            const void* dfinal, void* states, void* dx,
                            void* ddt, void* dA_part, void* dB_part,
                            void* dC_part, void* dinit, int batch,
                            int seq_len, int num_heads, int head_dim,
                            int d_state, void* stream) {
  if (batch <= 0 || batch > 65535 || seq_len <= 0 || num_heads <= 0 ||
      head_dim <= 0 || head_dim > kHD || d_state <= 0 || d_state > kDS)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  ssd_scan_bwd_kernel<<<dim3(num_heads, batch), kThreads, sizeof(Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(init_state),
      static_cast<const float*>(dy), static_cast<const float*>(dfinal),
      static_cast<float*>(states), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dinit), seq_len, num_heads, head_dim, d_state);
  return (int)cudaGetLastError();
}
