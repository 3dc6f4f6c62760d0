// Hopper kernels of the LDS E-step on per-sequence ("bpairs") pair
// potentials: the generic bidirectional information filter and the
// backward conditional sampler, both reading their pair blocks as streams.
//
// bidir_fwd_kernel<D> replaces svae_tpu/ops/pallas_bidir.py:_bidir_fwd_kernel.
// sampler_bp_fwd_kernel<D> replaces
// svae_tpu/ops/pallas_vjp.py:_sampler_fwd_kernel.
//
// What bounds them on an H100. As in estep.cu, every lane is a serial
// chain of T-1 small dense steps, and at the ragged slice's shape (B=64,
// 2B = 128 filter chains, S*B = 64 sampler chains, T up to 512, d=10) there
// are far fewer chains than the card holds threads: the latency of one
// chain's arithmetic bounds them. Unlike estep.cu's, these kernels stream
// the pair blocks: a filter step reads A (lower triangle), C, D, e, f and
// pc, 2.55 d^2 + 2d + 1 floats a lane (about 1.1 KB at d=10) where the
// stationary filter reads 2d, and writes d^2 + d as it does. That is still
// far below what the card moves in the time the chain's arithmetic takes.
//
// What the design does about it. One thread runs one chain in one launch,
// its carried message in registers. The streams keep the lane innermost
// ((T-1, d*d, lanes)), so at every step the threads of a warp read
// neighbouring addresses. T and the lane counts are runtime arguments (the
// length buckets and a tail batch vary them); only d is a template
// parameter, so the step's loops unroll. There is no lane or time padding:
// a lane is a thread, and every stream row is a real step.

#include "estep_common.cuh"

namespace {

// One thread per lane. Per stream row t:
//   M = J + A_t (lower triangle), L = chol(M), v = L^-1 (h + f_t),
//   ln += d/2 log 2pi - logdet(L) + |v|^2 / 2 + pc_t,
//   Y = L^-1 D_t^T, J' = C_t - Y^T Y, h' = Y^T v + e_t.
// Layouts: J0 (d*d, NL), h0 (d, NL); A, C, D (T1, d*d, NL); E, F (T1, d, NL);
// Pc (T1, NL); out J (T1, d*d, NL), h (T1, d, NL), ln (NL).
template <int D>
__global__ void __launch_bounds__(kThreads)
bidir_fwd_kernel(int NL, int T1, const float* __restrict__ J0,
                 const float* __restrict__ h0, const float* __restrict__ A,
                 const float* __restrict__ C, const float* __restrict__ Dm,
                 const float* __restrict__ E, const float* __restrict__ F,
                 const float* __restrict__ Pc, float* __restrict__ Jout,
                 float* __restrict__ hout, float* __restrict__ ln) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= NL) return;

  float J[D][D];  // carried message, lower triangle
  float h[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) J[i][j] = J0[(i * D + j) * NL + lane];
    h[i] = h0[i * NL + lane];
  }
  float acc = 0.f;

  for (int t = 0; t < T1; ++t) {
    const size_t mat = (size_t)t * DD * NL + lane;
    const size_t vec = (size_t)t * D * NL + lane;
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = J[i][j] + A[mat + (size_t)(i * D + j) * NL];
    }
    const float half_logdet = chol_inplace<D>(L, rd);

    float v[D];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = h[i] + F[vec + (size_t)i * NL];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i][k] * v[k];
      v[i] = s * rd[i];
      q += v[i] * v[i];
    }
    acc += 0.5f * D * kLog2Pi - half_logdet + 0.5f * q +
           Pc[(size_t)t * NL + lane];

    float Y[D][D];  // L^-1 D^T: column j of D^T is row j of D
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = Dm[mat + (size_t)(j * D + i) * NL];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][j];
        Y[i][j] = s * rd[i];
      }
    }

    // J' = C - Y^T Y, written in full (C is read in full, as the Pallas
    // kernel does); the carry keeps the lower triangle
    float* Jt = Jout + mat;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) s += Y[k][i] * Y[k][j];
        J[i][j] = C[mat + (size_t)(i * D + j) * NL] - s;
        Jt[(size_t)(i * D + j) * NL] = J[i][j];
        if (j < i)
          Jt[(size_t)(j * D + i) * NL] = C[mat + (size_t)(j * D + i) * NL] - s;
      }
      float s = E[vec + (size_t)i * NL];
#pragma unroll
      for (int k = 0; k < D; ++k) s += Y[k][i] * v[k];
      h[i] = s;
      hout[vec + (size_t)i * NL] = s;
    }
  }
  ln[lane] = acc;
}

// One thread per (sample s, sequence b), lane s*B + b, walking
// t = T1-1 ... 0 from the terminal sample xT. Per step:
//   Jc = Jf_t - 2 P3_t, L = chol(Jc),
//   x_t = L^-T (L^-1 (hf_t + P2_t^T x_{t+1}) + eps_t).
// Pairs and messages are read at sequence b = lane % B, not tiled S times.
// Layouts: P2, P3, Jf (T1, d*d, B), hf (T1, d, B); eps (T1, d, S*B),
// xT (d, S*B); out x (T1, d, S*B).
template <int D>
__global__ void __launch_bounds__(kThreads)
sampler_bp_fwd_kernel(int B, int SB, int T1, const float* __restrict__ P2,
                      const float* __restrict__ P3,
                      const float* __restrict__ Jf,
                      const float* __restrict__ hf,
                      const float* __restrict__ eps,
                      const float* __restrict__ xT,
                      float* __restrict__ xout) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= SB) return;
  const int b = lane % B;

  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = xT[i * SB + lane];

  for (int t = T1 - 1; t >= 0; --t) {
    const size_t mat = (size_t)t * DD * B + b;
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

    float y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = hf[((size_t)t * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k) s += P2[mat + (size_t)(k * D + i) * B] * x[k];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
      y[i] = s * rd[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] += eps[((size_t)t * D + i) * SB + lane];
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < D; ++k) s -= L[k][i] * x[k];
      x[i] = s * rd[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) xout[((size_t)t * D + i) * SB + lane] = x[i];
  }
}

template <int D>
int launch_bidir_fwd(int NL, int T1, const float* J0, const float* h0,
                     const float* A, const float* C, const float* Dm,
                     const float* E, const float* F, const float* Pc,
                     float* J, float* h, float* ln, cudaStream_t stream) {
  dim3 grid((NL + kThreads - 1) / kThreads);
  bidir_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      NL, T1, J0, h0, A, C, Dm, E, F, Pc, J, h, ln);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_bp_fwd(int B, int S, int T1, const float* P2,
                          const float* P3, const float* Jf, const float* hf,
                          const float* eps, const float* xT, float* x,
                          cudaStream_t stream) {
  const int SB = S * B;
  dim3 grid((SB + kThreads - 1) / kThreads);
  sampler_bp_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, SB, T1, P2, P3, Jf, hf, eps, xT, x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int svae_bidir_fwd_f32(int d, int NL, int T1, const float* J0,
                                  const float* h0, const float* A,
                                  const float* C, const float* Dm,
                                  const float* E, const float* F,
                                  const float* Pc, float* J, float* h,
                                  float* ln, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_BIDIR_FWD(DIM)                                                 \
  case DIM:                                                                 \
    return launch_bidir_fwd<DIM>(NL, T1, J0, h0, A, C, Dm, E, F, Pc, J, h, \
                                 ln, s);
  switch (d) {
    SVAE_BIDIR_FWD(2)
    SVAE_BIDIR_FWD(3)
    SVAE_BIDIR_FWD(4)
    SVAE_BIDIR_FWD(8)
    SVAE_BIDIR_FWD(10)
    SVAE_BIDIR_FWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_BIDIR_FWD
}

extern "C" int svae_sampler_bp_fwd_f32(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       float* x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_SAMPLER_BP_FWD(DIM)                                            \
  case DIM:                                                                 \
    return launch_sampler_bp_fwd<DIM>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, \
                                      s);
  switch (d) {
    SVAE_SAMPLER_BP_FWD(2)
    SVAE_SAMPLER_BP_FWD(3)
    SVAE_SAMPLER_BP_FWD(4)
    SVAE_SAMPLER_BP_FWD(8)
    SVAE_SAMPLER_BP_FWD(10)
    SVAE_SAMPLER_BP_FWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_SAMPLER_BP_FWD
}
