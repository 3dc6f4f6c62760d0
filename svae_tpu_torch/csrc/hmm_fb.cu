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
// What bounds them on an H100. Each chain is serial in its T-1 steps,
// each step K max-shifted logsumexps of K terms. At the SLDS shapes (B = 16
// sequences, 32 chains, T = 80, K = 4) the streamed kernel moves about
// 0.12 MB, under 0.1 us of HBM time, and does about 2x10^5 operations: far
// fewer chains than the card has threads, so the latency of one chain's
// step, times T-1, bounds them, not bytes or the arithmetic rate.
//
// What the design does about it. Lanes [0, B) run the alpha recursion,
// lanes [B, 2B) the beta recursion of the same sequences (independent
// chains; the Pallas kernel interleaves them only to fill a grid step).
// hmm_fb_fwd_kernel gives each chain segment_lanes(K) adjacent lanes of a
// warp (K = 3 leaves one idle), lane j owning state j of the carry: a
// step takes the K carried values by shuffles within the segment, adds
// the lane's column of M_t (its row, for beta) and computes one
// logsumexp of K terms, K expf and one logf where a thread per chain ran
// K^2 and K. Each lane loads only its K elements of a step, and those of
// the next kHmmRing - 1 steps are in flight: a ring in shared memory,
// filled by cp.async, one group of copies a step (the step clamped at the
// chain's end), so that a step waits only on its own group. A ring of
// registers did not pay here, though its loads were unconditional: nvcc
// moved each new load into the ring's register right after issuing it,
// and the move waits for the load, a whole L2 latency a step (its SASS).
// The logsumexp keeps the op order of the thread-per-chain kernel (the
// max, then the sum in index order), so the outputs are bitwise the same.
// The stationary kernel still runs one thread per chain; it
// holds the whole (K, K) matrix in registers (it is the same for every
// lane) and forms (lt + lo) before adding the carry, the op order of the
// streamed kernel, whose elements are precomputed as lt + lo. Streams keep
// the lane innermost ((T-1, K*K, B) and (T-1, K, B)); T and B are runtime
// arguments, K a template parameter, so the loops unroll.

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

// How many steps ahead a lane loads its chain elements (chip_variants.py;
// the kernel runs one warp a block: four ran slower).
constexpr int kHmmRing = 4;

// Layouts: a0 (K, B); M (T1, K*K, B), entry i*K + j; out alpha, beta
// (T1, K, B): alpha_1..alpha_T1 and beta_0..beta_{T1-1}. segment_lanes(K)
// lanes a chain, chain c = alpha lane c < B or beta lane c - B; one warp a
// block.
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_fwd_kernel(int B, int T1, const float* __restrict__ a0,
                  const float* __restrict__ M, float* __restrict__ alpha,
                  float* __restrict__ beta) {
  constexpr int W = segment_lanes(K), R = kHmmRing;
  // the ring: slot u holds the lane's K elements of a coming step
  __shared__ float ring[R][K][kThreads];
  const int lane = threadIdx.x;
  const int g = blockIdx.x * kThreads + lane;
  // a warp past the last chain leaves whole; in the last warp, lanes past
  // it (and K = 3's idle lane) shadow a real lane and store nothing
  if ((g - lane) / W >= 2 * B) return;
  const bool live = g / W < 2 * B && g % W < K;
  const int chain = min(g / W, 2 * B - 1);
  const int j = min(g % W, K - 1);  // the state this lane owns
  const bool fwd = chain < B;
  const int b = fwd ? chain : chain - B;
  const long long KB = (long long)K * B, KKB = KB * K;
  // the lane's K elements of chain step s (column j of M_t for alpha, t =
  // s; row j for beta, t = T1-1-s), k-th at src + k * stride; the source
  // steps down M's rows one step a load and stays at the chain's last
  const long long stride = fwd ? KB : B;
  const long long step = fwd ? KKB : -KKB;
  long long src = (fwd ? (long long)j * B : (T1 - 1) * KKB + j * KB) + b;
  const long long last = src + (T1 - 1) * step;
  auto load = [&](int u) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      cp_async4(&ring[u][k][lane], M + src + k * stride);
    cp_async_commit();
    src = src == last ? src : src + step;
  };
  // steps s+1 ... s+R-1 in flight while step s computes, each step's
  // copies a group; the loop unrolled by R so that every slot is a
  // constant
#pragma unroll
  for (int u = 0; u < R; ++u) load(u);

  // the carry's state j: alpha_t ascending, beta_{t+1} descending
  float c = fwd ? a0[(long long)j * B + b] : 0.f;
  float* out = fwd ? alpha + (long long)j * B + b
                   : beta + (T1 - 1) * KB + (long long)j * B + b;
  const long long ostep = fwd ? KB : -KB;
  for (int s0 = 0; s0 < T1; s0 += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (s0 + u >= T1) break;
      cp_async_wait<R - 1>();
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m = ring[u][k][lane];
        const float ck = __shfl_sync(0xffffffffu, c, k, W);
        v[k] = fwd ? ck + m : m + ck;
      }
      c = lse<K>(v);
      if (live) *out = c;
      out += ostep;
      load(u);  // step s+R into the slot just read
    }
  }
  cp_async_wait<0>();
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

// The streamed kernel's blocks: 2B chains of segment_lanes(K) lanes.
template <int K>
inline dim3 segment_grid(int B) {
  return dim3((2 * B * segment_lanes(K) + kThreads - 1) / kThreads);
}

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
#define SVAE_CASE(KS)                                                \
  case KS:                                                           \
    hmm_fb_fwd_kernel<KS><<<segment_grid<KS>(B), kThreads, 0, st>>>( \
        B, T1, a0, M, alpha, beta);                                  \
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
