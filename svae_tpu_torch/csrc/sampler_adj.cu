// Hopper kernels of the adjoint of the backward conditional sampler
// (estep.cu's sampler_fwd_kernel), in three passes.
//
// They replace svae_tpu/ops/pallas_estep.py:_sampler_adj_kernel.
//
// What bounds it on an H100. The cotangent of x_{t+1} flows from step t,
// so each of the S*B sample chains is serial in t. At the main-path shape
// (S*B = 128 chains, T = 100, d = 10) the bound is the function's bytes
// (chip_smoke.bound: ~1.6 us), far below what the serial chains allow, so
// what the design can cut is the latency of one chain's step. The earlier
// kernel walked each chain on one thread (4 blocks of 32 threads),
// refactoring Jc = Jf_t - 2 P3 for each of the S samples and running four
// triangular solves and two d x d triangular matrix solves a step, at
// 5.8 us a step and with 1,396 bytes of spills at d=10.
//
// What the design does about it. The carry is only the d-vector x-bar:
// x-bar = x-bar' + dx_t, b-bar = Jc^-1 x-bar, x-bar' <- P2 b-bar. The
// rest of the Pallas kernel's algebra reads b-bar but feeds no later step:
// with mu = Jc^-1 b, u = L^-1 x-bar = L^T b-bar and the forward's noise
// eps_t = L^T (x_t - mu),
//   Jc_bar = sym(-b-bar mu^T + L^-T P L^-1),  P = -phi(eps_t u^T)
// (phi keeps the lower triangle and halves the diagonal). So:
//
// 1. sampler_adj_factor_kernel runs one thread per (step, sequence),
//    6,336 at config 2, and writes W_t = Jc_t^-1 per sequence in Jf's
//    lane-minor layout (coalesced stores): once for the S samples, not S
//    times.
// 2. sampler_adj_chain_kernel runs one chain per block of d threads (a
//    partial warp), lane i owning row i: a step is two matrix-vector
//    products, b-bar = W x-bar and x-bar' = P2 b-bar, with the vectors
//    broadcast through shared memory; it writes dhf_t = b-bar_t and sums
//    the lane's row of the dP2 partial sum_t x_{t+1} b-bar_t^T in
//    registers (off the carried chain). The next four steps' rows of W,
//    dx and x are loaded into a ring of registers while a step computes;
//    the loads are unconditional, their step clamped, because a load
//    under a condition compiles to a move that waits for it at once.
// 3. sampler_adj_dJc_kernel runs one thread per (step, chain), 12,672 at
//    config 2: it refactors Jc, solves for mu, forms u = L^T b-bar, inverts
//    L in place and accumulates sym(Linv^T P Linv) row by row of P (P is
//    a lower triangle of rank-one rows), then writes dJc_t.
//
// The wrapper sums the S samples of dJc and dhf and the lanes of dP2; no
// atomics, so every sum is deterministic.

#include "adj_passes.cuh"

namespace {

// One thread per (step t, sequence b), b fastest. Inputs: P3 (d, d), Jf
// (T-1, d*d, B). Output W (T-1, d*d, B), the inverse of Jf_t - 2 P3
// (whose lower triangle is factored), in Jf's layout.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
sampler_adj_factor_kernel(int B, int T1, const float* __restrict__ P3,
                          const float* __restrict__ Jf,
                          float* __restrict__ W) {
  constexpr int DD = D * D;
  __shared__ float s2P3[DD];
  for (int k = threadIdx.x; k < DD; k += blockDim.x) s2P3[k] = 2.f * P3[k];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * B) return;
  const int t = idx / B;
  const int b = idx - t * B;
  float L[D][D], rd[D];
  factor_jc<D>(Jf + (size_t)t * DD * B + b, s2P3, B, L, rd);
  store_inverse<D>(L, rd, W + (size_t)t * DD * B + b, B);
}

// How many steps ahead the chain pass loads.
constexpr int kSamplerRing = 4;

// One block of D threads per chain (sample s, sequence b), lane s*B + b,
// thread i owning row i, walking t = 0 ... T-2. Inputs: W from
// sampler_adj_factor_kernel, P2 (d, d), xT (d, S*B), the forward's output
// x (T-1, d, S*B) and its cotangent dx (same shape). Outputs: dhf (T-1, d,
// S*B) per lane (b-bar), dxT (d, S*B) and dP2 (d*d, S*B) per-lane
// partials.
template <int D>
__global__ void __launch_bounds__(32)
sampler_adj_chain_kernel(int B, int SB, int T1, const float* __restrict__ W,
                         const float* __restrict__ P2,
                         const float* __restrict__ xT,
                         const float* __restrict__ x,
                         const float* __restrict__ dx,
                         float* __restrict__ dhf, float* __restrict__ dxT,
                         float* __restrict__ dP2) {
  constexpr int Q = kSamplerRing;
  __shared__ __align__(16) float sx[D];
  __shared__ __align__(16) float sb[D];
  const unsigned mask = chain_mask<D>();
  const int lane = blockIdx.x;
  const int i = threadIdx.x;
  const int b = lane % B;
  float p2[D], acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    p2[j] = P2[i * D + j];
    acc[j] = 0.f;
  }
  // steps t+1 ... t+Q in flight while step t computes: a ring of Q
  // register slots (row i of W_t, dx_t[i] and x_{t+1}[i]), the loop
  // unrolled by Q so that every slot index is a constant
  float nW[Q][D], ndx[Q], nxn[Q];
  // (The loads are unconditional, the step clamped to T-2: a load under
  // a condition leaves its slot's register to merge two values, and the
  // move that merges them waits for the load at once.)
  auto load = [&](int t, int u) {
    t = t < T1 ? t : T1 - 1;
#pragma unroll
    for (int j = 0; j < D; ++j)
      nW[u][j] = W[((size_t)t * D * D + i * D + j) * B + b];
    ndx[u] = dx[((size_t)t * D + i) * SB + lane];
    nxn[u] = *(t + 1 < T1 ? x + ((size_t)(t + 1) * D + i) * SB + lane
                          : xT + i * SB + lane);
  };
#pragma unroll
  for (int u = 0; u < Q; ++u) load(u, u);
  float xc = 0.f;
  for (int t0 = 0; t0 < T1; t0 += Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int t = t0 + u;
      if (t >= T1) break;
      float Wr[D];
#pragma unroll
      for (int j = 0; j < D; ++j) Wr[j] = nW[u][j];
      const float xn = nxn[u];
      sx[i] = xc + ndx[u];  // x-bar_t
      load(t + Q, u);
      __syncwarp(mask);
      // b-bar = W x-bar, in two partial sums to halve the dependent adds
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 2) {
        s0 += Wr[j] * sx[j];
        if (j + 1 < D) s1 += Wr[j + 1] * sx[j + 1];
      }
      const float bb = s0 + s1;
      dhf[((size_t)t * D + i) * SB + lane] = bb;
      sb[i] = bb;
      __syncwarp(mask);
      // x-bar' = P2 b-bar, and row i of the dP2 partial x_{t+1} b-bar^T
      s0 = s1 = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 2) {
        s0 += p2[j] * sb[j];
        acc[j] += xn * sb[j];
        if (j + 1 < D) {
          s1 += p2[j + 1] * sb[j + 1];
          acc[j + 1] += xn * sb[j + 1];
        }
      }
      xc = s0 + s1;
      // (the next step's x-bar write waits for no barrier: every lane is
      // past this step's b-bar barrier, so done reading x-bar; and b-bar
      // is rewritten only after the next x-bar barrier)
    }
  }
  dxT[i * SB + lane] = xc;
#pragma unroll
  for (int j = 0; j < D; ++j) dP2[(i * D + j) * SB + lane] = acc[j];
}

// One thread per (step t, chain), chain s*B + b fastest. Inputs: P2, P3
// (d, d); Jf (T-1, d*d, B), hf (T-1, d, B); eps (T-1, d, S*B); xT (d,
// S*B); the forward's output x (T-1, d, S*B); b-bar from the chain pass
// (dhf, (T-1, d, S*B)). Output dJc (T-1, d*d, S*B) per lane.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
sampler_adj_dJc_kernel(int B, int SB, int T1, const float* __restrict__ P2,
                       const float* __restrict__ P3,
                       const float* __restrict__ Jf,
                       const float* __restrict__ hf,
                       const float* __restrict__ eps,
                       const float* __restrict__ xT,
                       const float* __restrict__ x,
                       const float* __restrict__ bbar,
                       float* __restrict__ dJc) {
  constexpr int DD = D * D;
  __shared__ float sP2[DD], s2P3[DD];
  for (int k = threadIdx.x; k < DD; k += blockDim.x) {
    sP2[k] = P2[k];
    s2P3[k] = 2.f * P3[k];
  }
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * SB) return;
  const int t = idx / SB;
  const int lane = idx - t * SB;
  const int b = lane % B;
  const float* Jt = Jf + (size_t)t * DD * B;
  float L[D][D], rd[D];
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
SVAE_PASS_UNROLL
    for (int j = 0; j <= i; ++j)
      L[i][j] = Jt[(i * D + j) * B + b] - s2P3[i * D + j];
  }
  chol_inplace<D>(L, rd);

  // mu = Jc^-1 (hf + P2^T x_{t+1}), u = L^T b-bar
  float bv[D], y[D], mu[D], bb[D], u[D];
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
    float s = hf[((size_t)t * D + i) * B + b];
SVAE_PASS_UNROLL
    for (int k = 0; k < D; ++k)
      s += sP2[k * D + i] * (t + 1 < T1
                                 ? x[((size_t)(t + 1) * D + k) * SB + lane]
                                 : xT[k * SB + lane]);
    bv[i] = s;
    bb[i] = bbar[((size_t)t * D + i) * SB + lane];
  }
  solve_lower<D>(L, rd, bv, y);
  solve_upper<D>(L, rd, y, mu);
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
    float s = 0.f;
SVAE_PASS_UNROLL
    for (int k = i; k < D; ++k) s += L[k][i] * bb[k];
    u[i] = s;
  }

  // L^-1 in place, then the lower triangle of sym(S), S = Linv^T P Linv,
  // summed over the rows i of P: row i of P Linv is y_i = -c_i (q_i + u_i
  // Linv[i][:] / 2) with the prefix q_i = sum_{j<i} u_j Linv[j][:], and
  // S += Linv[i][:]^T y_i.
  invert_lower<D>(L, rd);
  float Sl[D][D], q[D];
SVAE_PASS_UNROLL
  for (int m = 0; m < D; ++m) {
    q[m] = 0.f;
SVAE_PASS_UNROLL
    for (int k = 0; k <= m; ++k) Sl[m][k] = 0.f;
  }
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
    const float c = eps[((size_t)t * D + i) * SB + lane];
    float yr[D];
SVAE_PASS_UNROLL
    for (int k = 0; k < D; ++k)
      yr[k] = -c * (q[k] + (k <= i ? 0.5f * u[i] * L[i][k] : 0.f));
SVAE_PASS_UNROLL
    for (int m = 0; m <= i; ++m) {
SVAE_PASS_UNROLL
      for (int k = 0; k <= m; ++k)
        Sl[m][k] += 0.5f * (L[i][m] * yr[k] + L[i][k] * yr[m]);
    }
SVAE_PASS_UNROLL
    for (int k = 0; k <= i; ++k) q[k] += u[i] * L[i][k];
  }

  float* dJt = dJc + (size_t)t * DD * SB;
SVAE_PASS_UNROLL
  for (int m = 0; m < D; ++m) {
SVAE_PASS_UNROLL
    for (int k = 0; k <= m; ++k) {
      const float v = Sl[m][k] - 0.5f * (bb[m] * mu[k] + mu[m] * bb[k]);
      dJt[(m * D + k) * SB + lane] = v;
      if (k < m) dJt[(k * D + m) * SB + lane] = v;
    }
  }
}

template <int D>
int launch_factor(int B, int T1, const float* P3, const float* Jf, float* W,
                  cudaStream_t stream) {
  const int n = T1 * B;
  sampler_adj_factor_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          B, T1, P3, Jf, W);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chain(int B, int SB, int T1, const float* W, const float* P2,
                 const float* xT, const float* x, const float* dx, float* dhf,
                 float* dxT, float* dP2, cudaStream_t stream) {
  sampler_adj_chain_kernel<D><<<SB, D, 0, stream>>>(B, SB, T1, W, P2, xT, x,
                                                    dx, dhf, dxT, dP2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dJc(int B, int SB, int T1, const float* P2, const float* P3,
               const float* Jf, const float* hf, const float* eps,
               const float* xT, const float* x, const float* dhf, float* dJc,
               cudaStream_t stream) {
  const int n = T1 * SB;
  sampler_adj_dJc_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          B, SB, T1, P2, P3, Jf, hf, eps, xT, x, dhf, dJc);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_adj(int B, int SB, int T1, const float* P2,
                       const float* P3, const float* Jf, const float* hf,
                       const float* eps, const float* xT, const float* x,
                       const float* dx, float* W, float* dJc, float* dhf,
                       float* dxT, float* dP2, cudaStream_t stream) {
  int err = launch_factor<D>(B, T1, P3, Jf, W, stream);
  if (err != 0) return err;
  err = launch_chain<D>(B, SB, T1, W, P2, xT, x, dx, dhf, dxT, dP2, stream);
  if (err != 0) return err;
  return launch_dJc<D>(B, SB, T1, P2, P3, Jf, hf, eps, xT, x, dhf, dJc,
                       stream);
}

}  // namespace

// Plain C entries for ctypes; each returns cudaGetLastError() after its
// launches (0 on success), cudaErrorInvalidValue for an unsupported d.
// T is the sampler's T (T-1 steps). svae_sampler_adj_f32 runs the three
// passes (W is its scratch, (T-1, d*d, B)); the other three run one each.
extern "C" int SVAE_ENTRY(svae_sampler_adj_f32)(int d, int B, int S, int T,
                                    const float* P2, const float* P3,
                                    const float* Jf, const float* hf,
                                    const float* eps, const float* xT,
                                    const float* x, const float* dx,
                                    float* W, float* dJc, float* dhf,
                                    float* dxT, float* dP2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                      \
  case DIM:                                                                 \
    return launch_sampler_adj<DIM>(B, S * B, T - 1, P2, P3, Jf, hf, eps, xT, \
                                   x, dx, W, dJc, dhf, dxT, dP2, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_sampler_adj_factor_f32)(int d, int B, int T,
                                           const float* P3, const float* Jf,
                                           float* W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_factor<DIM>(B, T - 1, P3, Jf, W, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_sampler_adj_chain_f32)(int d, int B, int S, int T,
                                          const float* W, const float* P2,
                                          const float* xT, const float* x,
                                          const float* dx, float* dhf,
                                          float* dxT, float* dP2,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                     \
  case DIM:                                                                \
    return launch_chain<DIM>(B, S * B, T - 1, W, P2, xT, x, dx, dhf, dxT, \
                             dP2, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_sampler_adj_dJc_f32)(int d, int B, int S, int T,
                                        const float* P2, const float* P3,
                                        const float* Jf, const float* hf,
                                        const float* eps, const float* xT,
                                        const float* x, const float* dhf,
                                        float* dJc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                    \
  case DIM:                                                               \
    return launch_dJc<DIM>(B, S * B, T - 1, P2, P3, Jf, hf, eps, xT, x,  \
                           dhf, dJc, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
