// Hopper kernels of the forward-only LDS E-step on pair potentials shared
// over the batch but varying in time: the forward information filter, the
// backward information filter and the backward conditional sampler.
//
// filter_shared_kernel<D> replaces
// svae_tpu/ops/pallas_kalman.py:_filter_kernel.
// backward_shared_kernel<D> replaces
// svae_tpu/ops/pallas_kalman.py:_backward_kernel.
// sampler_shared_kernel<D> replaces
// svae_tpu/ops/pallas_kalman.py:_sampler_kernel.
//
// What bounds them on an H100. As in estep.cu and bpairs.cu, every lane is
// a serial chain of T-1 small dense steps (a d x d Cholesky factor, the
// triangular solves, a rank-d update), far fewer chains than the card holds
// threads (B = 64 filter chains, S*B = 128 sampler chains at config 2): the
// latency of one chain's arithmetic bounds them, not bytes nor peak FLOP/s.
// What they read differs from bpairs.cu's: the pair blocks P1, P2, P3 and
// pc of step t are one (d*d) row shared by every lane, and only the node
// evidence (N1, N2) and the outputs are per lane, so a filter step moves
// 2 d^2 + 2d floats a lane (its node and its messages), not bpairs.cu's
// 3.5 d^2 + 3d.
//
// What the design does about it. One thread runs one chain in one launch,
// its carried message (J lower triangle, h) in registers. The shared rows
// are read straight from device memory: every thread of a warp reads the
// same address at the same step, which is one broadcast load, so nothing is
// staged and the pairs are read once per warp, not once per lane (the
// per-lane streams of bpairs.cu would read them B times). Node streams and
// outputs keep the lane innermost ((T-1, m, lanes)), so the threads of a
// warp read and write neighbouring addresses. T and the lane counts are
// runtime arguments; d is a template parameter, so every loop unrolls.
// There is no lane padding: a lane is a thread (the Pallas kernels pad to
// the 128-lane block, and the sampler there needs identity precisions on
// its pad lanes; here there are none). A failed Cholesky pivot gives NaN,
// which reaches every later output of the lane; the wrappers' callers
// check finiteness once.

#include "estep_common.cuh"

namespace {

// One thread per sequence b. Per step t (the pair row t, the node t+1):
//   M = J - 2 P3_t (lower triangle), L = chol(M), v = L^-1 h,
//   ln += d/2 log 2pi - logdet(L) + |v|^2 / 2 + pc_t,
//   Y = L^-1 P2_t^T, J' = -2 P1_t - 2 N1_{t+1} - Y^T Y, h' = Y^T v + N2_{t+1},
// where P2 M^-1 P2^T = Y^T Y and P2 M^-1 h = Y^T v.
// Layouts: J0 (d*d, B), h0 (d, B); P1, P2, P3 (T1, d*d), Pc (T1);
// N1 (T1, d*d, B), N2 (T1, d, B) (row t holds node t+1);
// out J (T1, d*d, B), h (T1, d, B) (row t is frame t+1), ln (B).
template <int D>
__global__ void __launch_bounds__(kThreads)
filter_shared_kernel(int B, int T1, const float* __restrict__ J0,
                     const float* __restrict__ h0,
                     const float* __restrict__ P1,
                     const float* __restrict__ P2,
                     const float* __restrict__ P3,
                     const float* __restrict__ Pc,
                     const float* __restrict__ N1,
                     const float* __restrict__ N2, float* __restrict__ Jout,
                     float* __restrict__ hout, float* __restrict__ ln) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  float J[D][D];  // carried message, lower triangle
  float h[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) J[i][j] = J0[(i * D + j) * B + lane];
    h[i] = h0[i * B + lane];
  }
  float acc = 0.f;

  for (int t = 0; t < T1; ++t) {
    const float* p1 = P1 + (size_t)t * DD;
    const float* p2 = P2 + (size_t)t * DD;
    const float* p3 = P3 + (size_t)t * DD;
    const size_t mat = (size_t)t * DD * B + lane;
    const size_t vec = (size_t)t * D * B + lane;
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = J[i][j] - 2.f * p3[i * D + j];
    }
    const float half_logdet = chol_inplace<D>(L, rd);

    float v[D];
    solve_lower<D>(L, rd, h, v);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) q += v[i] * v[i];
    acc += 0.5f * D * kLog2Pi - half_logdet + 0.5f * q + Pc[t];

    float Y[D][D];  // L^-1 P2^T: column j of P2^T is row j of P2
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = p2[j * D + i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][j];
        Y[i][j] = s * rd[i];
      }
    }

    // J' written in full (P1 and N1 are read in full, as the Pallas kernel
    // does); the carry keeps the lower triangle
    float* Jt = Jout + mat;
    const float* n1 = N1 + mat;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) s += Y[k][i] * Y[k][j];
        J[i][j] = -2.f * (p1[i * D + j] + n1[(size_t)(i * D + j) * B]) - s;
        Jt[(size_t)(i * D + j) * B] = J[i][j];
        if (j < i)
          Jt[(size_t)(j * D + i) * B] =
              -2.f * (p1[j * D + i] + n1[(size_t)(j * D + i) * B]) - s;
      }
      float s = N2[vec + (size_t)i * B];
#pragma unroll
      for (int k = 0; k < D; ++k) s += Y[k][i] * v[k];
      h[i] = s;
      hout[vec + (size_t)i * B] = s;
    }
  }
  ln[lane] = acc;
}

// One thread per sequence b, walking t = T1-1 ... 0 from the zero message
// (the beta message of frame T-1). Per step (the pair row t, the node t+1):
//   M = Jb_{t+1} - 2 P1_t - 2 N1_{t+1} (lower triangle), L = chol(M),
//   v = L^-1 (hb_{t+1} + N2_{t+1}), Y = L^-1 P2_t,
//   Jb_t = -2 P3_t - Y^T Y, hb_t = Y^T v,
// where P2^T M^-1 P2 = Y^T Y and P2^T M^-1 b = Y^T v.
// Layouts: P1, P2, P3 (T1, d*d); N1 (T1, d*d, B), N2 (T1, d, B) (row t
// holds node t+1); out J (T1, d*d, B), h (T1, d, B) (row t is frame t).
template <int D>
__global__ void __launch_bounds__(kThreads)
backward_shared_kernel(int B, int T1, const float* __restrict__ P1,
                       const float* __restrict__ P2,
                       const float* __restrict__ P3,
                       const float* __restrict__ N1,
                       const float* __restrict__ N2,
                       float* __restrict__ Jout, float* __restrict__ hout) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  float J[D][D];  // carried message, lower triangle
  float h[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) J[i][j] = 0.f;
    h[i] = 0.f;
  }

  for (int t = T1 - 1; t >= 0; --t) {
    const float* p1 = P1 + (size_t)t * DD;
    const float* p2 = P2 + (size_t)t * DD;
    const float* p3 = P3 + (size_t)t * DD;
    const size_t mat = (size_t)t * DD * B + lane;
    const size_t vec = (size_t)t * D * B + lane;
    float L[D][D], rd[D], b[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = J[i][j] -
                  2.f * (p1[i * D + j] + N1[mat + (size_t)(i * D + j) * B]);
      b[i] = h[i] + N2[vec + (size_t)i * B];
    }
    chol_inplace<D>(L, rd);

    float v[D];
    solve_lower<D>(L, rd, b, v);

    float Y[D][D];  // L^-1 P2
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = p2[i * D + j];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][j];
        Y[i][j] = s * rd[i];
      }
    }

    // Jb_t written in full (P3 read in full, as the Pallas kernel does);
    // the carry keeps the lower triangle
    float* Jt = Jout + mat;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) s += Y[k][i] * Y[k][j];
        J[i][j] = -2.f * p3[i * D + j] - s;
        Jt[(size_t)(i * D + j) * B] = J[i][j];
        if (j < i) Jt[(size_t)(j * D + i) * B] = -2.f * p3[j * D + i] - s;
      }
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) s += Y[k][i] * v[k];
      h[i] = s;
      hout[vec + (size_t)i * B] = s;
    }
  }
}

// One thread per (sample s, sequence b), lane s*B + b, walking
// t = T1-1 ... 0 from the terminal sample xT. Per step:
//   Jc = Jf_t - 2 P3_t, L = chol(Jc),
//   x_t = L^-T (L^-1 (hf_t + P2_t^T x_{t+1}) + eps_t).
// The messages are read at sequence b = lane % B, not tiled S times; the
// pair rows are shared by every lane.
// Layouts: P2, P3 (T1, d*d); Jf (T1, d*d, B), hf (T1, d, B) (frames
// 0..T-2); eps (T1, d, S*B), xT (d, S*B); out x (T1, d, S*B).
template <int D>
__global__ void __launch_bounds__(kThreads)
sampler_shared_kernel(int B, int SB, int T1, const float* __restrict__ P2,
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
    const float* p2 = P2 + (size_t)t * DD;
    const float* p3 = P3 + (size_t)t * DD;
    const size_t mat = (size_t)t * DD * B + b;
    float L[D][D], rd[D], c[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = Jf[mat + (size_t)(i * D + j) * B] - 2.f * p3[i * D + j];
      float s = hf[((size_t)t * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k) s += p2[k * D + i] * x[k];
      c[i] = s;
    }
    chol_inplace<D>(L, rd);

    float y[D];
    solve_lower<D>(L, rd, c, y);
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] += eps[((size_t)t * D + i) * SB + lane];
    solve_upper<D>(L, rd, y, x);
#pragma unroll
    for (int i = 0; i < D; ++i) xout[((size_t)t * D + i) * SB + lane] = x[i];
  }
}

template <int D>
int launch_filter_shared(int B, int T1, const float* J0, const float* h0,
                         const float* P1, const float* P2, const float* P3,
                         const float* Pc, const float* N1, const float* N2,
                         float* J, float* h, float* ln, cudaStream_t stream) {
  dim3 grid((B + kThreads - 1) / kThreads);
  filter_shared_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, T1, J0, h0, P1, P2, P3, Pc, N1, N2, J, h, ln);
  return (int)cudaGetLastError();
}

template <int D>
int launch_backward_shared(int B, int T1, const float* P1, const float* P2,
                           const float* P3, const float* N1, const float* N2,
                           float* J, float* h, cudaStream_t stream) {
  dim3 grid((B + kThreads - 1) / kThreads);
  backward_shared_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, T1, P1, P2, P3, N1, N2, J, h);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_shared(int B, int S, int T1, const float* P2,
                          const float* P3, const float* Jf, const float* hf,
                          const float* eps, const float* xT, float* x,
                          cudaStream_t stream) {
  const int SB = S * B;
  dim3 grid((SB + kThreads - 1) / kThreads);
  sampler_shared_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, SB, T1, P2, P3, Jf, hf, eps, xT, x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int svae_filter_shared_f32(int d, int B, int T1, const float* J0,
                                      const float* h0, const float* P1,
                                      const float* P2, const float* P3,
                                      const float* Pc, const float* N1,
                                      const float* N2, float* J, float* h,
                                      float* ln, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_FILTER_SHARED(DIM)                                          \
  case DIM:                                                              \
    return launch_filter_shared<DIM>(B, T1, J0, h0, P1, P2, P3, Pc, N1, \
                                     N2, J, h, ln, s);
  switch (d) {
    SVAE_FILTER_SHARED(2)
    SVAE_FILTER_SHARED(3)
    SVAE_FILTER_SHARED(4)
    SVAE_FILTER_SHARED(8)
    SVAE_FILTER_SHARED(10)
    SVAE_FILTER_SHARED(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_FILTER_SHARED
}

extern "C" int svae_backward_shared_f32(int d, int B, int T1,
                                        const float* P1, const float* P2,
                                        const float* P3, const float* N1,
                                        const float* N2, float* J, float* h,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_BACKWARD_SHARED(DIM)                                            \
  case DIM:                                                                  \
    return launch_backward_shared<DIM>(B, T1, P1, P2, P3, N1, N2, J, h, s);
  switch (d) {
    SVAE_BACKWARD_SHARED(2)
    SVAE_BACKWARD_SHARED(3)
    SVAE_BACKWARD_SHARED(4)
    SVAE_BACKWARD_SHARED(8)
    SVAE_BACKWARD_SHARED(10)
    SVAE_BACKWARD_SHARED(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_BACKWARD_SHARED
}

extern "C" int svae_sampler_shared_f32(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       float* x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_SAMPLER_SHARED(DIM)                                            \
  case DIM:                                                                 \
    return launch_sampler_shared<DIM>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, \
                                      s);
  switch (d) {
    SVAE_SAMPLER_SHARED(2)
    SVAE_SAMPLER_SHARED(3)
    SVAE_SAMPLER_SHARED(4)
    SVAE_SAMPLER_SHARED(8)
    SVAE_SAMPLER_SHARED(10)
    SVAE_SAMPLER_SHARED(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_SAMPLER_SHARED
}
