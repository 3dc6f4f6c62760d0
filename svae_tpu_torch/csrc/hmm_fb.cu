// Hopper kernels of the HMM forward-backward pass in log space: the two
// message recursions of the SLDS z-step.
//
// hmm_fb_fwd_kernel<K> replaces svae_tpu/ops/pallas_hmm.py:_hmm_fb_kernel
// (chain elements streamed). hmm_fb_stat_fwd_kernel<K> replaces
// svae_tpu/ops/pallas_hmm.py:_hmm_fb_stat_kernel (one stationary (K, K)
// transition matrix, only the observations streamed).
//
//   alpha_{t+1}(j) = logsumexp_i  alpha_t(i) + M_t(i, j)      (ascending)
//   beta_t(i)      = logsumexp_j  M_t(i, j) + beta_{t+1}(j)   (descending)
//
// What bounds them on an H100. Each lane is a serial chain of T-1 steps of
// K max-shifted logsumexps of K terms: K^2 expf and K logf a step, each
// step waiting on the one before. At the SLDS shapes (B = 16 sequences,
// 32 chains, T = 80, K = 4) the streamed kernel moves about 0.12 MB, under
// 0.1 us of HBM time, and does about 2x10^5 operations: far fewer chains
// than the card has threads, so the latency of one chain's dependent
// exp/log steps bounds them, not bytes or the arithmetic rate.
//
// What the design does about it. One thread runs one (sequence,
// direction) chain in one launch: lanes [0, B) the alpha recursion,
// lanes [B, 2B) the beta recursion of the same sequences (independent
// chains; the Pallas kernel interleaves them only to fill a grid step).
// The K-vector carry stays in registers with K a template parameter, so
// the loops unroll; each step loads its K^2 chain elements (K
// observations for the stationary kernel) at once before the dependent
// arithmetic. Streams keep the lane innermost ((T-1, K*K, B) and
// (T-1, K, B)), so the threads of a warp read neighbouring addresses. T
// and B are runtime arguments: no time padding and no masked tail rows, a
// stream row is a step. The stationary kernel holds the whole (K, K)
// matrix in registers (it is the same for every lane) and forms
// (lt + lo) before adding the carry, the op order of the streamed kernel,
// whose elements are precomputed as lt + lo.

#include "estep_common.cuh"

namespace {

// max-shifted logsumexp of K terms, summed in index order
template <int K>
__device__ __forceinline__ float lse(const float (&v)[K]) {
  float mx = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = fmaxf(mx, v[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += expf(v[k] - mx);
  return logf(s) + mx;
}

// Layouts: a0 (K, B); M (T1, K*K, B), entry i*K + j; out alpha, beta
// (T1, K, B): alpha_1..alpha_T1 and beta_0..beta_{T1-1}.
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_fwd_kernel(int B, int T1, const float* __restrict__ a0,
                  const float* __restrict__ M, float* __restrict__ alpha,
                  float* __restrict__ beta) {
  constexpr int KK = K * K;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= 2 * B) return;
  const bool fwd = lane < B;
  const int b = fwd ? lane : lane - B;

  float c[K];  // the carry: alpha_t ascending, beta_{t+1} descending
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = fwd ? a0[i * B + b] : 0.f;

  for (int s = 0; s < T1; ++s) {
    const int t = fwd ? s : T1 - 1 - s;
    const float* Mt = M + (size_t)t * KK * B + b;
    float m[KK];
#pragma unroll
    for (int k = 0; k < KK; ++k) m[k] = Mt[(size_t)k * B];
    float n[K];
#pragma unroll
    for (int o = 0; o < K; ++o) {
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = fwd ? c[k] + m[k * K + o] : m[o * K + k] + c[k];
      n[o] = lse<K>(v);
    }
    float* out = (fwd ? alpha : beta) + (size_t)t * K * B + b;
#pragma unroll
    for (int o = 0; o < K; ++o) {
      c[o] = n[o];
      out[(size_t)o * B] = n[o];
    }
  }
}

// As hmm_fb_fwd_kernel with M_t(i, j) = LT(i, j) + lo_t(j). Layouts: a0
// (K, B); LT (K, K); lo (T1, K, B); out alpha, beta (T1, K, B).
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_stat_fwd_kernel(int B, int T1, const float* __restrict__ a0,
                       const float* __restrict__ LT,
                       const float* __restrict__ lo,
                       float* __restrict__ alpha, float* __restrict__ beta) {
  constexpr int KK = K * K;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= 2 * B) return;
  const bool fwd = lane < B;
  const int b = fwd ? lane : lane - B;

  float lt[KK];
#pragma unroll
  for (int k = 0; k < KK; ++k) lt[k] = LT[k];
  float c[K];
#pragma unroll
  for (int i = 0; i < K; ++i) c[i] = fwd ? a0[i * B + b] : 0.f;

  for (int s = 0; s < T1; ++s) {
    const int t = fwd ? s : T1 - 1 - s;
    const float* lot = lo + (size_t)t * K * B + b;
    float ob[K];
#pragma unroll
    for (int k = 0; k < K; ++k) ob[k] = lot[(size_t)k * B];
    float n[K];
#pragma unroll
    for (int o = 0; o < K; ++o) {
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = fwd ? c[k] + (lt[k * K + o] + ob[o])
                   : (lt[o * K + k] + ob[k]) + c[k];
      n[o] = lse<K>(v);
    }
    float* out = (fwd ? alpha : beta) + (size_t)t * K * B + b;
#pragma unroll
    for (int o = 0; o < K; ++o) {
      c[o] = n[o];
      out[(size_t)o * B] = n[o];
    }
  }
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

extern "C" int svae_hmm_fb_fwd_f32(int K, int B, int T1, const float* a0,
                                   const float* M, float* alpha, float* beta,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS)                                                   \
  case KS:                                                              \
    hmm_fb_fwd_kernel<KS><<<grid_of(B), kThreads, 0, st>>>(B, T1, a0, M, \
                                                           alpha, beta); \
    return (int)cudaGetLastError();
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_stat_fwd_f32(int K, int B, int T1,
                                        const float* a0, const float* LT,
                                        const float* lo, float* alpha,
                                        float* beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS)                                              \
  case KS:                                                         \
    hmm_fb_stat_fwd_kernel<KS><<<grid_of(B), kThreads, 0, st>>>(   \
        B, T1, a0, LT, lo, alpha, beta);                           \
    return (int)cudaGetLastError();
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}
