// Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060) for
// Hopper (sm_90a).
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
// masked here), hd <= 64, ds <= 128.
//
// What bounds it on the card: operations.  Per 64-row chunk the function
// needs 2q²·ds flops for C·Bᵀ once (B and C are shared by every head)
// and, per head, 2q²·hd + 4q·hd·ds (the product with x·dt, the
// inter-chunk term and the state update) against q·(hd + 2ds/nh) input
// elements: ~150 flops per byte in f32 at the Mamba2-780M widths, and
// the inputs are read once.  This kernel recomputes C·Bᵀ per head.
// Nothing crosses blocks: the chunk axis is sequential only within a
// (batch, head).
//
// The design, and what it does about that.  The TPU grid (b, nh, chunks)
// carried the [hd, ds] state in VMEM scratch across a sequential chunk
// axis; here one block of 256 threads owns one (batch, head) and loops
// over the chunks itself, the state (32 KB at hd 64, ds 128) resident in
// shared memory for the whole sequence, so it never goes to device
// memory between chunks.  The caller's chunk (256 for Mamba2) would need
// a 256 KB f32 score tile, over the 227 KB a block can have; the kernel
// walks its own 64-row chunks instead (the SSD algebra is exact for any
// split, only the summation order changes).  Per chunk: x·dt, B and C are
// staged once as f32 rows of odd stride (no bank conflicts); one thread
// takes the 64-step cumsum; the 64x64 C·Bᵀ ⊙ decay tile, y, and the state
// update are each a register-tiled product (4x4 or 4x8 outputs per
// thread) of scalar f32 FMAs from shared memory.  A first version, right
// and simple: no tensor cores, one block per SM (133 KB of shared
// memory), so a batch-1 prefill fills nh = 48 of 132 SMs.  Later work:
// C·Bᵀ once per (batch, chunk) for all heads, mma.sync / wgmma tiles.
// No atomics: the result is bitwise repeatable run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;        // rows per chunk
constexpr int kHD = 64;       // widest head (ssd_scan.py MAX_HEAD_DIM)
constexpr int kDS = 128;      // widest state (ssd_scan.py MAX_D_STATE)
constexpr int kXS = kHD + 1;  // odd row strides: no bank conflicts
constexpr int kBS = kDS + 1;
constexpr int kAS = kQ + 1;
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kQ * kXS          // x·dt
                     + 2 * (size_t)kQ * kBS    // B, C
                     + (size_t)kQ * kAS        // C·Bᵀ ⊙ decay
                     + (size_t)kHD * kBS       // state
                     + 3 * (size_t)kQ);        // dt, cum, decay to end

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state, int S,
                int NH, int HD, int DS) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // 16 x 16 thread grid; a thread's rows/columns are t, t+16, t+32, ...
  const int tr = tid >> 4, tc = tid & 15;
  extern __shared__ float smem[];
  float* sXdt = smem;                  // [kQ][kXS]  x_j · dt_j
  float* sB = sXdt + kQ * kXS;         // [kQ][kBS]
  float* sC = sB + kQ * kBS;           // [kQ][kBS]
  float* sAtt = sC + kQ * kBS;         // [kQ][kAS]
  float* sS = sAtt + kQ * kAS;         // [kHD][kBS] the carried state
  float* sDt = sS + kHD * kBS;         // [kQ]
  float* sCum = sDt + kQ;              // [kQ]
  float* sD2e = sCum + kQ;             // [kQ] exp(cum_last − cum_j)
  const float a = A[h];
  const size_t head_state = ((size_t)b * NH + h) * HD;

  // the state; rows past hd and columns past ds stay 0 throughout
  for (int e = tid; e < kHD * kDS; e += kThreads) {
    const int p = e / kDS, n = e % kDS;
    sS[p * kBS + n] = (init != nullptr && p < HD && n < DS)
                          ? init[(head_state + p) * DS + n]
                          : 0.f;
  }

  for (int r0 = 0; r0 < S; r0 += kQ) {
    const int nrows = min(kQ, S - r0);
    // ---- stage the chunk; rows past the end are zero (dt 0: no decay,
    // no update, no contribution)
    for (int e = tid; e < kQ * kHD; e += kThreads) {
      const int r = e / kHD, p = e % kHD;
      sXdt[r * kXS + p] =
          (r < nrows && p < HD)
              ? to_float(x[(((size_t)b * S + r0 + r) * NH + h) * HD + p])
              : 0.f;
    }
    for (int e = tid; e < kQ * kDS; e += kThreads) {
      const int r = e / kDS, n = e % kDS;
      float vb = 0.f, vc = 0.f;
      if (r < nrows && n < DS) {
        const size_t off = ((size_t)b * S + r0 + r) * DS + n;
        vb = to_float(Bm[off]);
        vc = to_float(Cm[off]);
      }
      sB[r * kBS + n] = vb;
      sC[r * kBS + n] = vc;
    }
    if (tid < kQ)
      sDt[tid] = tid < nrows ? dt[((size_t)b * S + r0 + tid) * NH + h] : 0.f;
    __syncthreads();

    // ---- cum = cumsum(dt·A) (one thread, the scan's own order); x·dt
    if (tid == 0) {
      float c = 0.f;
      for (int r = 0; r < kQ; ++r) {
        c += sDt[r] * a;
        sCum[r] = c;
      }
    }
    for (int e = tid; e < kQ * kHD; e += kThreads) {
      const int r = e / kHD, p = e % kHD;
      sXdt[r * kXS + p] *= sDt[r];
    }
    __syncthreads();
    const float cum_last = sCum[kQ - 1];
    if (tid < kQ) sD2e[tid] = expf(cum_last - sCum[tid]);

    // ---- att[i][j] = (C_i · B_j) exp(cum_i − cum_j) for j <= i, else 0
    {
      float acc[4][4] = {};
      for (int n = 0; n < DS; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = sC[(tr + 16 * u) * kBS + n];
          bv[u] = sB[(tc + 16 * u) * kBS + n];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += cv[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tr + 16 * u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = tc + 16 * v;
          sAtt[i * kAS + j] =
              j <= i ? acc[u][v] * expf(sCum[i] - sCum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y_i = Σ_j att[i][j] x_j dt_j + exp(cum_i) C_i · S_prev
    {
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < nrows; ++j) {
        float av[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          av[u] = sAtt[(tr + 16 * u) * kAS + j];
          xv[u] = sXdt[j * kXS + tc + 16 * u];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) intra[u][v] += av[u] * xv[v];
      }
      for (int n = 0; n < DS; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = sC[(tr + 16 * u) * kBS + n];
          sv[u] = sS[(tc + 16 * u) * kBS + n];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) inter[u][v] += cv[u] * sv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tr + 16 * u;
        if (i >= nrows) continue;
        const float in_decay = expf(sCum[i]);
        T* row = y + (((size_t)b * S + r0 + i) * NH + h) * HD;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tc + 16 * v;
          if (p < HD) store(row + p, intra[u][v] + in_decay * inter[u][v]);
        }
      }
    }
    __syncthreads();

    // ---- S = exp(cum_last) S + Σ_j exp(cum_last − cum_j) x_j dt_j ⊗ B_j
    // (thread: state rows tc + 16u, columns tr + 16v)
    {
      float acc[4][8] = {};
      for (int j = 0; j < nrows; ++j) {
        const float w = sD2e[j];
        float xv[4], bv[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = sXdt[j * kXS + tc + 16 * u] * w;
#pragma unroll
        for (int v = 0; v < 8; ++v) bv[v] = sB[j * kBS + tr + 16 * v];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] += xv[u] * bv[v];
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          float* s = sS + (tc + 16 * u) * kBS + tr + 16 * v;
          *s = *s * decay + acc[u][v];
        }
    }
    __syncthreads();
  }

  for (int e = tid; e < HD * DS; e += kThreads) {
    const int p = e / DS, n = e % DS;
    final_state[(head_state + p) * DS + n] = sS[p * kBS + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* init, void* y,
                   void* final_state, int batch, int S, int NH, int HD,
                   int DS, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(NH, batch);
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(final_state), S, NH, HD, DS);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, A, init_state
// and final_state are float32; init_state may be null (a zero state).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes the kernel does not take).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init_state,
                        void* y, void* final_state, int batch, int seq_len,
                        int num_heads, int head_dim, int d_state, int dtype,
                        void* stream) {
  if (batch <= 0 || batch > 65535 || seq_len <= 0 || num_heads <= 0 ||
      head_dim <= 0 || head_dim > kHD || d_state <= 0 || d_state > kDS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, B, C, init_state, y, final_state,
                              batch, seq_len, num_heads, head_dim, d_state, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, init_state, y,
                                      final_state, batch, seq_len, num_heads,
                                      head_dim, d_state, s);
  return (int)cudaErrorInvalidValue;
}
