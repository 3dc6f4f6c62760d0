// Hopper kernels of the adjoint of the HMM forward-backward pass (the
// backward of ops/hmm_fb.py's HmmFb and HmmFbStat).
//
// hmm_fb_adj_kernel<K> replaces svae_tpu/ops/pallas_hmm.py:_hmm_fb_adj_kernel.
// hmm_fb_stat_adj_kernel<K> replaces
// svae_tpu/ops/pallas_hmm.py:_hmm_fb_stat_adj_kernel.
//
// The adjoint keeps the bounded softmax-weight form. With g the alpha
// cotangent carried down from step t+1 plus its direct cotangent,
//   w_ij = exp(alpha_t(i) + M_t(i,j) - alpha_{t+1}(j)),
//   dM_t(i,j) = g_j w_ij,  dalpha_t(i) = sum_j g_j w_ij   (descending t);
// with h the beta cotangent carried up from step t-1 plus its direct one,
//   v_ij = exp(M_t(i,j) + beta_{t+1}(j) - beta_t(i)),
//   dM_t(i,j) = h_i v_ij,  dbeta_{t+1}(j) = sum_i h_i v_ij  (ascending t).
// Every weight lies in [0, 1], so no intermediate can overflow; the
// derivative of log-of-sums taken as automatic differentiation gives it
// forms 1/sum that overflow once the messages sharpen.
//
// What bounds them on an H100: as the forward kernels (csrc/hmm_fb.cu),
// the latency of each lane's serial chain of K^2 expf a step, with far
// fewer chains than the card has threads; the bytes (about 0.3 MB at B=16,
// T=80, K=4) are far below what the card moves in that time.
//
// What the design does about it. One thread per (sequence, direction):
// lanes [0, B) run the alpha adjoint descending in t, lanes [B, 2B) the
// beta adjoint ascending. Each reads the forward's messages at its own
// step and the step beside it (alpha_t is a0 at t = 0, beta_{t+1} is 0 at
// the last step), so the wrapper builds no shifted copies, and carries its
// K-vector cotangent in registers. The streamed adjoint writes each
// direction's dM to its own stream (dMf, dMb); the stationary adjoint
// writes each direction's observation cotangent to its own stream (the
// alpha half's is g itself, since sum_i w_ij = 1; the beta half's is the
// new carry) and keeps its own (K, K) transition partial in registers,
// written once per lane at the end. The wrappers sum these: no two threads
// write one address and there are no atomics. T and B are runtime
// arguments, K a template parameter; streams keep the lane innermost.

#include "estep_common.cuh"

namespace {

// Layouts: a0 (K, B); M (T1, K*K, B); alpha, beta, dalpha, dbeta
// (T1, K, B) as hmm_fb_fwd_kernel returns them and their cotangents; out
// dMf, dMb (T1, K*K, B), da0 (K, B).
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_adj_kernel(int B, int T1, const float* __restrict__ a0,
                  const float* __restrict__ M,
                  const float* __restrict__ alpha,
                  const float* __restrict__ beta,
                  const float* __restrict__ dalpha,
                  const float* __restrict__ dbeta, float* __restrict__ dMf,
                  float* __restrict__ dMb, float* __restrict__ da0) {
  constexpr int KK = K * K;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= 2 * B) return;
  const bool fwd = lane < B;
  const int b = fwd ? lane : lane - B;
  const size_t vstep = (size_t)K * B;

  float c[K];  // the carried cotangent
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = 0.f;

  for (int s = 0; s < T1; ++s) {
    const int t = fwd ? T1 - 1 - s : s;
    const size_t mat = (size_t)t * KK * B + b;
    const size_t vec = (size_t)t * vstep + b;
    float m[KK];
#pragma unroll
    for (int k = 0; k < KK; ++k) m[k] = M[mat + (size_t)k * B];
    float g[K], p[K], q[K], n[K];
    if (fwd) {
      // g: cotangent of alpha_{t+1}; p = alpha_t; q = alpha_{t+1}
#pragma unroll
      for (int i = 0; i < K; ++i) {
        g[i] = c[i] + dalpha[vec + (size_t)i * B];
        p[i] = t > 0 ? alpha[vec - vstep + (size_t)i * B] : a0[i * B + b];
        q[i] = alpha[vec + (size_t)i * B];
        n[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float w = expf(p[i] + m[i * K + j] - q[j]);
          const float r = g[j] * w;
          dMf[mat + (size_t)(i * K + j) * B] = r;
          n[i] += r;
        }
      }
    } else {
      // g: cotangent of beta_t; p = beta_t; q = beta_{t+1}
#pragma unroll
      for (int i = 0; i < K; ++i) {
        g[i] = c[i] + dbeta[vec + (size_t)i * B];
        p[i] = beta[vec + (size_t)i * B];
        q[i] = t < T1 - 1 ? beta[vec + vstep + (size_t)i * B] : 0.f;
        n[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float v = expf(m[i * K + j] + q[j] - p[i]);
          const float r = g[i] * v;
          dMb[mat + (size_t)(i * K + j) * B] = r;
          n[j] += r;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = n[i];
  }
  if (fwd) {
#pragma unroll
    for (int i = 0; i < K; ++i) da0[i * B + b] = c[i];
  }
}

// The stationary adjoint, M_t(i, j) = LT(i, j) + lo_t(j). Layouts: a0
// (K, B); LT (K, K); lo, alpha, beta, dalpha, dbeta (T1, K, B); out dloa,
// dlod (T1, K, B) (the alpha and beta halves of dlo), da0 (K, B) and dLTp
// (K*K, 2B), each lane's transition partial.
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_stat_adj_kernel(int B, int T1, const float* __restrict__ a0,
                       const float* __restrict__ LT,
                       const float* __restrict__ lo,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       const float* __restrict__ dalpha,
                       const float* __restrict__ dbeta,
                       float* __restrict__ dloa, float* __restrict__ dlod,
                       float* __restrict__ da0, float* __restrict__ dLTp) {
  constexpr int KK = K * K;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= 2 * B) return;
  const bool fwd = lane < B;
  const int b = fwd ? lane : lane - B;
  const size_t vstep = (size_t)K * B;

  float lt[KK], dlt[KK];
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    lt[k] = LT[k];
    dlt[k] = 0.f;
  }
  float c[K];
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = 0.f;

  for (int s = 0; s < T1; ++s) {
    const int t = fwd ? T1 - 1 - s : s;
    const size_t vec = (size_t)t * vstep + b;
    float ob[K], g[K], p[K], q[K], n[K];
#pragma unroll
    for (int i = 0; i < K; ++i) ob[i] = lo[vec + (size_t)i * B];
    if (fwd) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        g[i] = c[i] + dalpha[vec + (size_t)i * B];
        p[i] = t > 0 ? alpha[vec - vstep + (size_t)i * B] : a0[i * B + b];
        q[i] = alpha[vec + (size_t)i * B];
        n[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float w = expf(p[i] + (lt[i * K + j] + ob[j]) - q[j]);
          const float r = g[j] * w;
          n[i] += r;
          dlt[i * K + j] += r;
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) dloa[vec + (size_t)j * B] = g[j];
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        g[i] = c[i] + dbeta[vec + (size_t)i * B];
        p[i] = beta[vec + (size_t)i * B];
        q[i] = t < T1 - 1 ? beta[vec + vstep + (size_t)i * B] : 0.f;
        n[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float v = expf((lt[i * K + j] + ob[j]) + q[j] - p[i]);
          const float r = g[i] * v;
          n[j] += r;
          dlt[i * K + j] += r;
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) dlod[vec + (size_t)j * B] = n[j];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = n[i];
  }
  if (fwd) {
#pragma unroll
    for (int i = 0; i < K; ++i) da0[i * B + b] = c[i];
  }
#pragma unroll
  for (int k = 0; k < KK; ++k) dLTp[(size_t)k * 2 * B + lane] = dlt[k];
}

inline dim3 grid_of(int B) { return dim3((2 * B + kThreads - 1) / kThreads); }

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported K returns cudaErrorInvalidValue.
#define SVAE_HMM_SWITCH(CASE)            \
  switch (K) {                           \
    CASE(1)                              \
    CASE(2)                              \
    CASE(3)                              \
    CASE(4)                              \
    CASE(8)                              \
    default:                             \
      return (int)cudaErrorInvalidValue; \
  }

extern "C" int svae_hmm_fb_adj_f32(int K, int B, int T1, const float* a0,
                                   const float* M, const float* alpha,
                                   const float* beta, const float* dalpha,
                                   const float* dbeta, float* dMf,
                                   float* dMb, float* da0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS)                                                     \
  case KS:                                                                \
    hmm_fb_adj_kernel<KS><<<grid_of(B), kThreads, 0, st>>>(               \
        B, T1, a0, M, alpha, beta, dalpha, dbeta, dMf, dMb, da0);         \
    return (int)cudaGetLastError();
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_stat_adj_f32(int K, int B, int T1,
                                        const float* a0, const float* LT,
                                        const float* lo, const float* alpha,
                                        const float* beta,
                                        const float* dalpha,
                                        const float* dbeta, float* dloa,
                                        float* dlod, float* da0, float* dLTp,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS)                                                     \
  case KS:                                                                \
    hmm_fb_stat_adj_kernel<KS><<<grid_of(B), kThreads, 0, st>>>(          \
        B, T1, a0, LT, lo, alpha, beta, dalpha, dbeta, dloa, dlod, da0,   \
        dLTp);                                                            \
    return (int)cudaGetLastError();
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}
