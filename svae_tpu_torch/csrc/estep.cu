// Hopper kernels of the packed stationary LDS E-step: the bidirectional
// information filter and the backward conditional sampler.
//
// filter_fwd<D> replaces svae_tpu/ops/pallas_estep.py:_filter_fwd_kernel.
// sampler_fwd<D> replaces svae_tpu/ops/pallas_estep.py:_sampler_fwd_kernel.
//
// What bounds them on an H100. Each sequence is a serial chain of T-1
// small dense steps (a d x d Cholesky factor, two triangular solves and a
// rank-d update), so a step cannot start before the previous one ends. At
// the main-path shape (B=64, T=100, d=10) the filter has 2B = 128 chains
// and the sampler S*B = 128, far fewer threads than the card's 132 SMs can
// hold: the kernels are bound by the latency of one chain's arithmetic,
// not by bytes (each step reads 2d and writes d*d + d floats per chain)
// nor by peak FLOP/s.
//
// What the design does about it. One thread runs one chain, and the whole
// chain runs in one launch, so no step pays a launch or a trip through
// device memory for its carried state: the carried J (lower triangle) and
// h stay in the thread's registers. The stationary pair blocks (A, C, D
// per direction; P2, P3 for the sampler) are the same for every chain, so
// they are read once into shared memory instead of being broadcast per
// lane as on the TPU. Streams keep the batch innermost, so the threads of
// a warp read and write neighbouring addresses at every step. Blocks are
// 32 threads wide to spread the few chains over as many SMs as possible;
// the direction is blockIdx.y, so a warp never diverges on it. D is a
// template parameter so every loop is unrolled and every array index is a
// constant. At d=10 the live state (L 55, Y 100, vectors) exceeds what
// the registers hold and spills to local memory; this first version
// accepts that (a warp per chain, splitting the d x d work across lanes,
// is the known next step).

#include "estep_common.cuh"

namespace {

// One thread per (sequence b, direction r). Per step t:
//   M = J + A_r (+ diag jd on the backward direction), L = chol(M),
//   v = L^-1 (h + f), ln += d/2 log 2pi - logdet(L) + |v|^2 / 2,
//   Y = L^-1 D_r^T, J' = C_r (+ diag jd forward) - Y^T Y,
//   h' = Y^T v (+ n2 forward),
// where D M^-1 D^T = Y^T Y and D M^-1 (h + f) = Y^T v. Forward chains read
// frame t+1, backward chains frame T-1-t (the time-reversed filter).
// Layouts: J0 (d*d, 2B), h0 (d, 2B); A, C, D (2, d, d);
// jd, n2 (T, d, B); out J (T-1, d*d, 2B), h (T-1, d, 2B), ln (2B).
// Lane r*B + b of the outputs is sequence b in direction r.
template <int D>
__global__ void __launch_bounds__(kThreads)
filter_fwd_kernel(int B, int T, const float* __restrict__ J0,
                  const float* __restrict__ h0, const float* __restrict__ A,
                  const float* __restrict__ C, const float* __restrict__ Dm,
                  const float* __restrict__ jd, const float* __restrict__ n2,
                  float* __restrict__ Jout, float* __restrict__ hout,
                  float* __restrict__ ln) {
  constexpr int DD = D * D;
  const int r = blockIdx.y;
  __shared__ float sA[DD], sC[DD], sD[DD];
  for (int k = threadIdx.x; k < DD; k += blockDim.x) {
    sA[k] = A[r * DD + k];
    sC[k] = C[r * DD + k];
    sD[k] = Dm[r * DD + k];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int NL = 2 * B;
  const int lane = r * B + b;

  float J[D][D];
  float h[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) J[i][j] = J0[(i * D + j) * NL + lane];
    h[i] = h0[i * NL + lane];
  }
  float acc = 0.f;

  for (int t = 0; t < T - 1; ++t) {
    const int frame = r == 0 ? t + 1 : T - 1 - t;
    float jv[D], nv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      jv[i] = jd[(frame * D + i) * B + b];
      nv[i] = n2[(frame * D + i) * B + b];
    }
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = J[i][j] + sA[i * D + j];
      if (r == 1) L[i][i] += jv[i];
    }
    const float half_logdet = chol_inplace<D>(L, rd);

    float v[D];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = r == 1 ? h[i] + nv[i] : h[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i][k] * v[k];
      v[i] = s * rd[i];
      q += v[i] * v[i];
    }
    acc += 0.5f * D * kLog2Pi - half_logdet + 0.5f * q;

    float Y[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = sD[j * D + i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][j];
        Y[i][j] = s * rd[i];
      }
    }

#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float s = sC[i * D + j];
#pragma unroll
        for (int k = 0; k < D; ++k) s -= Y[k][i] * Y[k][j];
        J[i][j] = s;
      }
      if (r == 0) J[i][i] += jv[i];
      float s = r == 0 ? nv[i] : 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) s += Y[k][i] * v[k];
      h[i] = s;
    }

    float* Jt = Jout + (size_t)t * DD * NL;
    float* ht = hout + (size_t)t * D * NL;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        Jt[(i * D + j) * NL + lane] = j <= i ? J[i][j] : J[j][i];
      ht[i * NL + lane] = h[i];
    }
  }
  ln[lane] = acc;
}

// One thread per (sample s, sequence b), lane s*B + b, walking
// t = T-2 ... 0 from the terminal sample xT. Per step:
//   Jc = Jf_t - 2 P3, L = chol(Jc),
//   x_t = Jc^-1 (hf_t + P2^T x_{t+1}) + L^-T eps_t
//       = L^-T (L^-1 (hf_t + P2^T x_{t+1}) + eps_t).
// The filter messages are read at sequence b = lane % B, not tiled S times.
// Layouts: P2, P3 (d, d); Jf (T-1, d*d, B), hf (T-1, d, B);
// eps (T-1, d, S*B), xT (d, S*B); out x (T-1, d, S*B).
template <int D>
__global__ void __launch_bounds__(kThreads)
sampler_fwd_kernel(int B, int SB, int T, const float* __restrict__ P2,
                   const float* __restrict__ P3, const float* __restrict__ Jf,
                   const float* __restrict__ hf,
                   const float* __restrict__ eps,
                   const float* __restrict__ xT, float* __restrict__ xout) {
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

  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = xT[i * SB + lane];

  for (int t = T - 2; t >= 0; --t) {
    const float* Jt = Jf + (size_t)t * DD * B;
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = Jt[(i * D + j) * B + b] - s2P3[i * D + j];
    }
    chol_inplace<D>(L, rd);

    float y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = hf[((size_t)t * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k) s += sP2[k * D + i] * x[k];
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
int launch_filter(int B, int T, const float* J0, const float* h0,
                  const float* A, const float* C, const float* Dm,
                  const float* jd, const float* n2, float* J, float* h,
                  float* ln, cudaStream_t stream) {
  dim3 grid((B + kThreads - 1) / kThreads, 2);
  filter_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler(int B, int S, int T, const float* P2, const float* P3,
                   const float* Jf, const float* hf, const float* eps,
                   const float* xT, float* x, cudaStream_t stream) {
  const int SB = S * B;
  dim3 grid((SB + kThreads - 1) / kThreads);
  sampler_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, SB, T, P2, P3, Jf, hf, eps, xT, x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int svae_filter_fwd_f32(int d, int B, int T, const float* J0,
                                   const float* h0, const float* A,
                                   const float* C, const float* Dm,
                                   const float* jd, const float* n2,
                                   float* J, float* h, float* ln,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_filter<2>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
    case 3: return launch_filter<3>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
    case 4: return launch_filter<4>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
    case 8: return launch_filter<8>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
    case 10: return launch_filter<10>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
    case 16: return launch_filter<16>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int svae_sampler_fwd_f32(int d, int B, int S, int T,
                                    const float* P2, const float* P3,
                                    const float* Jf, const float* hf,
                                    const float* eps, const float* xT,
                                    float* x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_sampler<2>(B, S, T, P2, P3, Jf, hf, eps, xT, x, s);
    case 3: return launch_sampler<3>(B, S, T, P2, P3, Jf, hf, eps, xT, x, s);
    case 4: return launch_sampler<4>(B, S, T, P2, P3, Jf, hf, eps, xT, x, s);
    case 8: return launch_sampler<8>(B, S, T, P2, P3, Jf, hf, eps, xT, x, s);
    case 10: return launch_sampler<10>(B, S, T, P2, P3, Jf, hf, eps, xT, x, s);
    case 16: return launch_sampler<16>(B, S, T, P2, P3, Jf, hf, eps, xT, x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
