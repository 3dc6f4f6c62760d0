// Hopper kernel of the adjoint of the backward conditional sampler
// (estep.cu's sampler_fwd_kernel).
//
// sampler_adj<D> replaces svae_tpu/ops/pallas_estep.py:_sampler_adj_kernel.
//
// What bounds it on an H100. The cotangent of x_{t+1} flows from step t,
// so each of the S*B sample chains is serial in t. At the main-path shape
// (S*B = 128 chains, T = 100, d = 10) the card holds far more threads than
// there are chains, and the kernel is bound by the latency of one chain's
// arithmetic (a d x d Cholesky factor and two triangular matrix solves a
// step), not by bytes (a step reads the filter message, d*d + d floats,
// and 3d more, and writes d*d + d) nor by peak FLOP/s.
//
// What the design does about it. One thread walks one chain, t
// ascending, in one launch, carrying the cotangent of x_{t+1} and its dP2
// sum in registers. It recomputes the step's factor L of
// Jc = Jf_t - 2 P3 from the filter message, read at sequence lane % B as the
// forward kernel reads it, so the messages are never tiled S times. The
// algebra is the Pallas kernel's: with mu = Jc^-1 b, u = L^-1 xbar,
// bbar = L^-T u,
//   Jc_bar = sym(-bbar mu^T + chol_vjp(L, -tril((x_t - mu) u^T))).
// The forward's noise gives L^T (x_t - mu) = eps_t, so the Cholesky adjoint
// reduces to S = L^-T P L^-1 with the rank-one lower P = -phi(eps_t u^T)
// (phi halves the diagonal), two triangular matrix solves. P2 and 2 P3 sit
// in shared memory. Each thread writes its own dJc, dhf per step and its
// dP2 partial; the wrapper sums the S samples and the lanes (no atomics).

#include "estep_common.cuh"

namespace {

// One thread per (sample s, sequence b), lane s*B + b, walking
// t = 0 ... T-2. Inputs: P2, P3 (d, d); Jf (T-1, d*d, B), hf (T-1, d, B);
// eps (T-1, d, S*B); xT (d, S*B); the forward's output x (T-1, d, S*B) and
// its cotangent dx (same shape). Outputs: dJc (T-1, d*d, S*B) and dhf
// (T-1, d, S*B) per lane, dxT (d, S*B), dP2 (d*d, S*B) per-lane partials.
template <int D>
__global__ void __launch_bounds__(kThreads)
sampler_adj_kernel(int B, int SB, int T, const float* __restrict__ P2,
                   const float* __restrict__ P3, const float* __restrict__ Jf,
                   const float* __restrict__ hf,
                   const float* __restrict__ eps,
                   const float* __restrict__ xT, const float* __restrict__ x,
                   const float* __restrict__ dx, float* __restrict__ dJc,
                   float* __restrict__ dhf, float* __restrict__ dxT,
                   float* __restrict__ dP2) {
  constexpr int DD = D * D;
  __shared__ float sP2[DD], s2P3[DD];
  for (int k = threadIdx.x; k < DD; k += blockDim.x) {
    sP2[k] = P2[k];
    s2P3[k] = 2.f * P3[k];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= SB) return;
  const int b = lane % B;

  float xc[D];  // cotangent of x_t carried from step t-1
  float accP2[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    xc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) accP2[i][j] = 0.f;
  }

  for (int t = 0; t < T - 1; ++t) {
    const float* Jt = Jf + (size_t)t * DD * B;
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = Jt[(i * D + j) * B + b] - s2P3[i * D + j];
    }
    chol_inplace<D>(L, rd);

    float xn[D], bv[D], c[D], xbar[D];
#pragma unroll
    for (int i = 0; i < D; ++i)
      xn[i] = t + 1 < T - 1 ? x[((size_t)(t + 1) * D + i) * SB + lane]
                            : xT[i * SB + lane];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = hf[((size_t)t * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k) s += sP2[k * D + i] * xn[k];
      bv[i] = s;
      c[i] = eps[((size_t)t * D + i) * SB + lane];
      xbar[i] = xc[i] + dx[((size_t)t * D + i) * SB + lane];
    }
    float y[D], mu[D], u[D], bbar[D];
    solve_lower<D>(L, rd, bv, y);
    solve_upper<D>(L, rd, y, mu);
    solve_lower<D>(L, rd, xbar, u);
    solve_upper<D>(L, rd, u, bbar);

    // R = L^-T P, P lower with P[i][j] = -c_i u_j (j < i) and -c_i u_i / 2
    // on the diagonal, c = eps_t; L^-T fills the upper part, so R is full.
    float R[D][D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int i = D - 1; i >= 0; --i) {
        float s = i > j ? -c[i] * u[j] : (i == j ? -0.5f * c[i] * u[i] : 0.f);
#pragma unroll
        for (int k = i + 1; k < D; ++k) s -= L[k][i] * R[k][j];
        R[i][j] = s * rd[i];
      }
    }
    // S = R L^-1, row i: (L^-T R[i][:]^T)^T
    float S[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) solve_upper<D>(L, rd, R[i], S[i]);

    float* dJt = dJc + (size_t)t * DD * SB;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        dJt[(i * D + j) * SB + lane] =
            0.5f * (S[i][j] + S[j][i] - bbar[i] * mu[j] - mu[i] * bbar[j]);
      dhf[((size_t)t * D + i) * SB + lane] = bbar[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        accP2[i][j] += xn[i] * bbar[j];
        s += sP2[i * D + j] * bbar[j];
      }
      xc[i] = s;
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    dxT[i * SB + lane] = xc[i];
#pragma unroll
    for (int j = 0; j < D; ++j) dP2[(i * D + j) * SB + lane] = accP2[i][j];
  }
}

template <int D>
int launch_sampler_adj(int B, int S, int T, const float* P2, const float* P3,
                       const float* Jf, const float* hf, const float* eps,
                       const float* xT, const float* x, const float* dx,
                       float* dJc, float* dhf, float* dxT, float* dP2,
                       cudaStream_t stream) {
  const int SB = S * B;
  dim3 grid((SB + kThreads - 1) / kThreads);
  sampler_adj_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, SB, T, P2, P3, Jf, hf, eps, xT, x, dx, dJc, dhf, dxT, dP2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes; returns cudaGetLastError() after the launch
// (0 on success), cudaErrorInvalidValue for an unsupported d.
extern "C" int svae_sampler_adj_f32(int d, int B, int S, int T,
                                    const float* P2, const float* P3,
                                    const float* Jf, const float* hf,
                                    const float* eps, const float* xT,
                                    const float* x, const float* dx,
                                    float* dJc, float* dhf, float* dxT,
                                    float* dP2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_SAMPLER_ADJ(DIM)                                              \
  case DIM:                                                                \
    return launch_sampler_adj<DIM>(B, S, T, P2, P3, Jf, hf, eps, xT, x, dx, \
                                   dJc, dhf, dxT, dP2, s);
  switch (d) {
    SVAE_SAMPLER_ADJ(2)
    SVAE_SAMPLER_ADJ(3)
    SVAE_SAMPLER_ADJ(4)
    SVAE_SAMPLER_ADJ(8)
    SVAE_SAMPLER_ADJ(10)
    SVAE_SAMPLER_ADJ(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_SAMPLER_ADJ
}
