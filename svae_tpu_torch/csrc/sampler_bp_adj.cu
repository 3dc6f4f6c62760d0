// Hopper kernels of the adjoint of the backward conditional sampler on
// per-sequence pairs (bpairs.cu's sampler_bp_fwd_kernel), in three passes.
//
// They replace svae_tpu/ops/pallas_vjp.py:_sampler_adj_kernel.
//
// What bounds it on an H100. The cotangent of x_{t+1} flows from step t,
// so each of the S*B sample chains is serial in t. At the ragged slice's
// shape (S*B = 64 chains, T up to 512, d=10) the card holds far more
// threads than there are chains, and the function's bytes (a step reads
// 2.1 d^2 + 4d floats a sequence and writes 3 d^2 + d; chip_smoke.bound:
// ~0.02 ms at T=512) take far less time than one chain's serial steps. So
// what the design can cut is the latency of a chain's step. The earlier
// kernel walked each chain on one thread, refactoring Jc = Jf_t - 2 P3_t
// for each of the S samples and running four triangular solves and two
// d x d triangular matrix solves a step, about 9 us a step at d=10 with
// 252 bytes of spills.
//
// What the design does about it: sampler_adj.cu's three passes on
// per-sequence streams. The carry is only the d-vector x-bar: x-bar =
// x-bar' + dx_t, b-bar = Jc^-1 x-bar, x-bar' <- P2_t b-bar. Jc_t depends on
// neither the carry nor the sample, and the rest of the Pallas kernel's
// algebra reads b-bar but feeds no later step: with b = hf_t + P2_t^T
// x_{t+1}, mu = Jc^-1 b, u = L^T b-bar and the forward's noise eps_t,
//   dJc_t = sym(-b-bar mu^T + L^-T P L^-1),  P = -phi(eps_t u^T)
// (phi keeps the lower triangle and halves the diagonal),
//   dhf_t = b-bar,  dP2_t = x_{t+1} b-bar^T,  summed over the S samples.
//
// 1. sampler_bp_adj_factor_kernel runs one thread per (step, sequence),
//    32,704 at T=512, B=64: it factors Jc_t from the two streams' lower
//    triangles (adj_passes.cuh's factor_jc_bp) and writes W_t = Jc_t^-1
//    lane-minor in Jf's layout, once for the S samples.
// 2. sampler_bp_adj_chain_kernel runs one chain per block of d threads
//    (sample s, sequence b), thread i owning row i, t ascending: a step is
//    two matrix-vector products, b-bar = W_t x-bar and x-bar' = P2_t b-bar,
//    the vectors passed through shared memory, and the coming steps' rows
//    of W_t and P2_t in a ring of registers, loaded unconditionally. It
//    writes b-bar_t and dxT only.
// 3. sampler_bp_adj_dJc_kernel runs one thread per (step, sequence) and
//    loops over the S samples. It refactors Jc once. Since b-bar mu^T =
//    L^-T u w^T L^-1 with w = L^-1 b, dJc_t = L^-T Z L^-1 with Z = sum_s
//    sym(P_s - u_s w_s^T): each sample adds to the symmetric Z a forward
//    solve and a triangular product, and L^-1 and the two products with it
//    run once (the factor in registers, Z in shared memory). It then sums
//    dP2 and dhf over the samples and writes dJf = dJc, dP3 = -2 dJc, dP2
//    and dhf per sequence, (T-1, d*d, B): the S sum is in the kernel,
//    deterministic, with no atomics and no per-lane output.
// svae_sampler_bp_adj_f32 launches the three, one after the other, with W
// and b-bar as the caller's scratch.

#include "adj_passes.cuh"

namespace {

// One thread per (step t, sequence b), b fastest. Inputs: P3, Jf (T-1,
// d*d, B) (lower triangles read). Output W (T-1, d*d, B), the inverse of
// Jf_t - 2 P3_t, in Jf's layout.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
sampler_bp_adj_factor_kernel(int B, int T1, const float* __restrict__ P3,
                             const float* __restrict__ Jf,
                             float* __restrict__ W) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * B) return;
  const int t = idx / B;
  const size_t at = (size_t)t * D * D * B + (idx - t * B);
  float L[D][D], rd[D];
  factor_jc_bp<D>(Jf, P3, at, B, L, rd);
  store_inverse<D>(L, rd, W + at, B);
}

// How many steps ahead the chain pass loads (2 and 4 ran slower, and 4
// spilled at d=10: PERF.md §6).
constexpr int kBpRing = 3;

// One block of D threads per chain (sample s, sequence b), lane s*B + b,
// thread i owning row i, walking t = 0 ... T-2. Inputs: W from the factor
// pass and P2 (T-1, d*d, B), dx (T-1, d, S*B), the cotangent of the
// forward's output. Outputs: bbar (T-1, d, S*B) and dxT (d, S*B).
template <int D>
__global__ void __launch_bounds__(32)
sampler_bp_adj_chain_kernel(int B, int SB, int T1, const float* __restrict__ W,
                            const float* __restrict__ P2,
                            const float* __restrict__ dx,
                            float* __restrict__ bbar,
                            float* __restrict__ dxT) {
  constexpr int Q = kBpRing;
  __shared__ __align__(16) float sx[D];
  __shared__ __align__(16) float sb[D];
  const unsigned mask = chain_mask<D>();
  const int lane = blockIdx.x;
  const int i = threadIdx.x;
  const int b = lane % B;
  // steps t+1 ... t+Q in flight while step t computes: a ring of Q
  // register slots (row i of W_t and of P2_t, dx_t[i]), the loop unrolled
  // by Q so that every slot index is a constant; the loads unconditional,
  // the step clamped to T-2
  float nW[Q][D], nP[Q][D], ndx[Q];
  auto load = [&](int t, int u) {
    t = t < T1 ? t : T1 - 1;
    const size_t row = ((size_t)t * D * D + i * D) * B + b;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      nW[u][j] = W[row + (size_t)j * B];
      nP[u][j] = P2[row + (size_t)j * B];
    }
    ndx[u] = dx[((size_t)t * D + i) * SB + lane];
  };
#pragma unroll
  for (int u = 0; u < Q; ++u) load(u, u);
  float xc = 0.f;
  for (int t0 = 0; t0 < T1; t0 += Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int t = t0 + u;
      if (t >= T1) break;
      float Wr[D], Pr[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        Wr[j] = nW[u][j];
        Pr[j] = nP[u][j];
      }
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
      bbar[((size_t)t * D + i) * SB + lane] = bb;
      sb[i] = bb;
      __syncwarp(mask);
      // x-bar' = P2_t b-bar
      s0 = s1 = 0.f;
#pragma unroll
      for (int j = 0; j < D; j += 2) {
        s0 += Pr[j] * sb[j];
        if (j + 1 < D) s1 += Pr[j + 1] * sb[j + 1];
      }
      xc = s0 + s1;
      // (the next step's x-bar write waits for no barrier: every thread is
      // past this step's b-bar barrier, so done reading x-bar; and b-bar
      // is rewritten only after the next x-bar barrier)
    }
  }
  dxT[i * SB + lane] = xc;
}

// Threads per block of the dJc pass: its Z accumulator lives in shared
// memory, d(d+1)/2 floats a thread (34.8 KB a block at d=16), which
// leaves a sample's loads the registers.
constexpr int kDJcThreads = 64;

// One thread per (step t, sequence b), b fastest, looping over the S
// samples (lanes s*B + b). Inputs: P2, P3, Jf (T-1, d*d, B), hf (T-1, d,
// B); eps (T-1, d, S*B); xT (d, S*B); the forward's output x (T-1, d, S*B);
// bbar from the chain pass. Outputs, summed over the samples: dP2, dP3, dJf
// (T-1, d*d, B) and dhf (T-1, d, B).
template <int D>
__global__ void __launch_bounds__(kDJcThreads)
sampler_bp_adj_dJc_kernel(int B, int S, int T1, const float* __restrict__ P2,
                          const float* __restrict__ P3,
                          const float* __restrict__ Jf,
                          const float* __restrict__ hf,
                          const float* __restrict__ eps,
                          const float* __restrict__ xT,
                          const float* __restrict__ x,
                          const float* __restrict__ bbar,
                          float* __restrict__ dP2, float* __restrict__ dP3,
                          float* __restrict__ dJf, float* __restrict__ dhf) {
  constexpr int TRI = D * (D + 1) / 2;
  // Z = sum_s sym(P_s - u_s w_s^T), the lower triangle of this thread's
  // at sZ[tri(m, k) * kDJcThreads + threadIdx.x] (the factor and a
  // sample's vectors take the registers)
  __shared__ float sZ[TRI * kDJcThreads];
  float* Z = sZ + threadIdx.x;
  auto zat = [](int m, int k) { return (m * (m + 1) / 2 + k) * kDJcThreads; };
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * B) return;
  const int t = idx / B;
  const int b = idx - t * B;
  const int SB = S * B;
  const size_t at = (size_t)t * D * D * B + b;
  const size_t vt = (size_t)t * D;  // the step's row of the vector streams
  float L[D][D], rd[D];
  factor_jc_bp<D>(Jf, P3, at, B, L, rd);
  // x_{t+1} of lane s*B + b at xn + s*B (the terminal sample at the last
  // step), stride SB between entries
  const float* xn = t + 1 < T1 ? x + (vt + D) * SB + b : xT + b;

#pragma unroll
  for (int m = 0; m < D; ++m) {
#pragma unroll
    for (int k = 0; k <= m; ++k) Z[zat(m, k)] = 0.f;
  }
  for (int s = 0; s < S; ++s) {
    const int lane = s * B + b;
    float xv[D], bv[D], w[D], bb[D], u[D], c[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = xn[(size_t)k * SB + s * B];
    // b = hf_t + P2_t^T x_{t+1}, w = L^-1 b
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float v = hf[(vt + k) * B + b];
#pragma unroll
      for (int m = 0; m < D; ++m) v += P2[at + (size_t)(m * D + k) * B] * xv[m];
      bv[k] = v;
      bb[k] = bbar[(vt + k) * SB + lane];
      c[k] = eps[(vt + k) * SB + lane];
    }
    solve_lower<D>(L, rd, bv, w);
    // u = L^T b-bar
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float v = 0.f;
#pragma unroll
      for (int m = k; m < D; ++m) v += L[m][k] * bb[m];
      u[k] = v;
    }
#pragma unroll
    for (int m = 0; m < D; ++m) {
#pragma unroll
      for (int k = 0; k < m; ++k)
        Z[zat(m, k)] -= 0.5f * (c[m] * u[k] + u[m] * w[k] + u[k] * w[m]);
      Z[zat(m, m)] -= (0.5f * c[m] + w[m]) * u[m];
    }
  }

  // dJc = Linv^T Z Linv, column k at a time: y = Z Linv[:, k] (Linv[:, k]
  // is zero above row k), then dJc[m][k] = Linv[:, m] . y for m >= k
  invert_lower<D>(L, rd);
  auto Zs = [&](int m, int k) {
    return Z[k <= m ? zat(m, k) : zat(k, m)];
  };
#pragma unroll
  for (int k = 0; k < D; ++k) {
    float y[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float v = 0.f;
#pragma unroll
      for (int r = k; r < D; ++r) v += Zs(a, r) * L[r][k];
      y[a] = v;
    }
#pragma unroll
    for (int m = k; m < D; ++m) {
      float v = 0.f;
#pragma unroll
      for (int a = m; a < D; ++a) v += L[a][m] * y[a];
      const size_t mk = at + (size_t)(m * D + k) * B;
      const size_t km = at + (size_t)(k * D + m) * B;
      dJf[mk] = v;
      dP3[mk] = -2.f * v;
      if (m > k) {
        dJf[km] = v;
        dP3[km] = -2.f * v;
      }
    }
  }

  // dP2 = sum_s x_{t+1} b-bar^T, dhf = sum_s b-bar
  float G[D][D], h[D];
#pragma unroll
  for (int m = 0; m < D; ++m) {
    h[m] = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) G[m][k] = 0.f;
  }
  for (int s = 0; s < S; ++s) {
    float xv[D], bb[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xv[k] = xn[(size_t)k * SB + s * B];
      bb[k] = bbar[(vt + k) * SB + s * B + b];
      h[k] += bb[k];
    }
#pragma unroll
    for (int m = 0; m < D; ++m) {
#pragma unroll
      for (int k = 0; k < D; ++k) G[m][k] += xv[m] * bb[k];
    }
  }
#pragma unroll
  for (int m = 0; m < D; ++m) {
#pragma unroll
    for (int k = 0; k < D; ++k) dP2[at + (size_t)(m * D + k) * B] = G[m][k];
    dhf[(vt + m) * B + b] = h[m];
  }
}

template <int D>
int launch_factor(int B, int T1, const float* P3, const float* Jf, float* W,
                  cudaStream_t stream) {
  const int n = T1 * B;
  sampler_bp_adj_factor_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          B, T1, P3, Jf, W);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chain(int B, int SB, int T1, const float* W, const float* P2,
                 const float* dx, float* bbar, float* dxT,
                 cudaStream_t stream) {
  sampler_bp_adj_chain_kernel<D><<<SB, D, 0, stream>>>(B, SB, T1, W, P2, dx,
                                                       bbar, dxT);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dJc(int B, int S, int T1, const float* P2, const float* P3,
               const float* Jf, const float* hf, const float* eps,
               const float* xT, const float* x, const float* bbar,
               float* dP2, float* dP3, float* dJf, float* dhf,
               cudaStream_t stream) {
  const int n = T1 * B;
  sampler_bp_adj_dJc_kernel<D>
      <<<(n + kDJcThreads - 1) / kDJcThreads, kDJcThreads, 0, stream>>>(
          B, S, T1, P2, P3, Jf, hf, eps, xT, x, bbar, dP2, dP3, dJf, dhf);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_bp_adj(int B, int S, int T1, const float* P2,
                          const float* P3, const float* Jf, const float* hf,
                          const float* eps, const float* xT, const float* x,
                          const float* dx, float* W, float* bbar, float* dP2,
                          float* dP3, float* dJf, float* dhf, float* dxT,
                          cudaStream_t stream) {
  int err = launch_factor<D>(B, T1, P3, Jf, W, stream);
  if (err != 0) return err;
  err = launch_chain<D>(B, S * B, T1, W, P2, dx, bbar, dxT, stream);
  if (err != 0) return err;
  return launch_dJc<D>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, bbar, dP2, dP3,
                       dJf, dhf, stream);
}

}  // namespace

#define SVAE_DIMS(CASE) CASE(2) CASE(3) CASE(4) CASE(8) CASE(10) CASE(16)

// Plain C entries for ctypes; each returns cudaGetLastError() after its
// launches (0 on success), cudaErrorInvalidValue for an unsupported d. T1
// is the number of steps (T-1). svae_sampler_bp_adj_f32 runs the three
// passes (W (T-1, d*d, B) and bbar (T-1, d, S*B) are its scratch); the
// other three run one each.
extern "C" int svae_sampler_bp_adj_f32(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       const float* x, const float* dx,
                                       float* W, float* bbar, float* dP2,
                                       float* dP3, float* dJf, float* dhf,
                                       float* dxT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                      \
  case DIM:                                                                 \
    return launch_sampler_bp_adj<DIM>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, \
                                      dx, W, bbar, dP2, dP3, dJf, dhf, dxT, \
                                      s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_sampler_bp_adj_factor_f32(int d, int B, int T1,
                                              const float* P3,
                                              const float* Jf, float* W,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_factor<DIM>(B, T1, P3, Jf, W, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_sampler_bp_adj_chain_f32(int d, int B, int S, int T1,
                                             const float* W, const float* P2,
                                             const float* dx, float* bbar,
                                             float* dxT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_chain<DIM>(B, S * B, T1, W, P2, dx, bbar, dxT, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_sampler_bp_adj_dJc_f32(int d, int B, int S, int T1,
                                           const float* P2, const float* P3,
                                           const float* Jf, const float* hf,
                                           const float* eps, const float* xT,
                                           const float* x, const float* bbar,
                                           float* dP2, float* dP3, float* dJf,
                                           float* dhf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                      \
  case DIM:                                                                 \
    return launch_dJc<DIM>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, bbar, dP2, \
                           dP3, dJf, dhf, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
#undef SVAE_DIMS
