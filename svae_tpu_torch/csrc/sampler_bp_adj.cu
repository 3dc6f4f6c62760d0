// Hopper kernel of the adjoint of the backward conditional sampler on
// per-sequence pairs (bpairs.cu's sampler_bp_fwd_kernel).
//
// sampler_bp_adj_kernel<D> replaces
// svae_tpu/ops/pallas_vjp.py:_sampler_adj_kernel.
//
// What bounds it on an H100. The cotangent of x_{t+1} flows from step t,
// so each of the S*B sample chains is serial in t. At the ragged slice's
// shape (S*B = 64 chains, T up to 512, d=10) the card holds far more
// threads than there are chains, and the latency of one chain's arithmetic
// (a d x d Cholesky factor and two triangular matrix solves a step) bounds
// the kernel, not bytes (a step reads 2.1 d^2 + 4d floats and writes
// 2 d^2 + d) nor peak FLOP/s.
//
// What the design does about it. sampler_adj.cu's design on streamed
// pairs: one thread walks one chain, t ascending, in one launch, carrying
// the cotangent of x_{t+1} in registers, and recomputes the factor L of
// Jc = Jf_t - 2 P3_t from the message and the pair block, read at sequence
// lane % B, so nothing is tiled S times. With mu = Jc^-1 b, u = L^-1 xbar,
// bbar = L^-T u and L^T (x_t - mu) = eps_t (the forward's noise),
//   dJc_t = sym(-bbar mu^T + S),  S = L^-T P L^-1,  P = -phi(eps_t u^T),
//   dhf_t = bbar,  dP2_t = x_{t+1} bbar^T,  xbar_{t+1} = P2_t bbar.
// Each output is per step and lane, written once by its own thread; the
// wrapper sums the S samples of a sequence (no atomics).

#include "estep_common.cuh"

namespace {

// One thread per (sample s, sequence b), lane s*B + b, walking
// t = 0 ... T1-1. Inputs: P2, P3, Jf (T1, d*d, B), hf (T1, d, B);
// eps (T1, d, S*B); xT (d, S*B); the forward's output x (T1, d, S*B) and its
// cotangent dx (same shape). Outputs: dJc, dP2 (T1, d*d, S*B), dhf
// (T1, d, S*B) per lane, dxT (d, S*B).
template <int D>
__global__ void __launch_bounds__(kThreads)
sampler_bp_adj_kernel(int B, int SB, int T1, const float* __restrict__ P2,
                      const float* __restrict__ P3,
                      const float* __restrict__ Jf,
                      const float* __restrict__ hf,
                      const float* __restrict__ eps,
                      const float* __restrict__ xT,
                      const float* __restrict__ x,
                      const float* __restrict__ dx, float* __restrict__ dJc,
                      float* __restrict__ dhf, float* __restrict__ dP2,
                      float* __restrict__ dxT) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= SB) return;
  const int b = lane % B;

  float xc[D];  // cotangent of x_t carried from step t-1
#pragma unroll
  for (int i = 0; i < D; ++i) xc[i] = 0.f;

  for (int t = 0; t < T1; ++t) {
    const size_t mat = (size_t)t * DD * B + b;     // per-sequence blocks
    const size_t lmat = (size_t)t * DD * SB + lane;  // per-lane outputs
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const size_t k = mat + (size_t)(i * D + j) * B;
        L[i][j] = Jf[k] - 2.f * P3[k];
      }
    }
    chol_inplace<D>(L, rd);

    float xn[D], bv[D], c[D], xbar[D];
#pragma unroll
    for (int i = 0; i < D; ++i)
      xn[i] = t + 1 < T1 ? x[((size_t)(t + 1) * D + i) * SB + lane]
                         : xT[i * SB + lane];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = hf[((size_t)t * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k)
        s += P2[mat + (size_t)(k * D + i) * B] * xn[k];
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
    // on the diagonal; L^-T fills the upper part, so R is full.
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

#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const size_t ij = lmat + (size_t)(i * D + j) * SB;
        dJc[ij] =
            0.5f * (S[i][j] + S[j][i] - bbar[i] * mu[j] - mu[i] * bbar[j]);
        dP2[ij] = xn[i] * bbar[j];
      }
      dhf[((size_t)t * D + i) * SB + lane] = bbar[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j)
        s += P2[mat + (size_t)(i * D + j) * B] * bbar[j];
      xc[i] = s;
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) dxT[i * SB + lane] = xc[i];
}

template <int D>
int launch_sampler_bp_adj(int B, int S, int T1, const float* P2,
                          const float* P3, const float* Jf, const float* hf,
                          const float* eps, const float* xT, const float* x,
                          const float* dx, float* dJc, float* dhf, float* dP2,
                          float* dxT, cudaStream_t stream) {
  const int SB = S * B;
  dim3 grid((SB + kThreads - 1) / kThreads);
  sampler_bp_adj_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, SB, T1, P2, P3, Jf, hf, eps, xT, x, dx, dJc, dhf, dP2, dxT);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes; returns cudaGetLastError() after the launch
// (0 on success), cudaErrorInvalidValue for an unsupported d.
extern "C" int svae_sampler_bp_adj_f32(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       const float* x, const float* dx,
                                       float* dJc, float* dhf, float* dP2,
                                       float* dxT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_SAMPLER_BP_ADJ(DIM)                                            \
  case DIM:                                                                 \
    return launch_sampler_bp_adj<DIM>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, \
                                      dx, dJc, dhf, dP2, dxT, s);
  switch (d) {
    SVAE_SAMPLER_BP_ADJ(2)
    SVAE_SAMPLER_BP_ADJ(3)
    SVAE_SAMPLER_BP_ADJ(4)
    SVAE_SAMPLER_BP_ADJ(8)
    SVAE_SAMPLER_BP_ADJ(10)
    SVAE_SAMPLER_BP_ADJ(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_SAMPLER_BP_ADJ
}
