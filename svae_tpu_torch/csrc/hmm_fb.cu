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
// Both kernels give each chain segment_lanes(K) adjacent lanes of a warp
// (K = 3 leaves one idle), lane j owning state j of the carry, and run the
// same chain step (chain_steps): it takes the K carried values by shuffles
// within the segment, adds them to the lane's K elements of the step (the
// lane's column of M_t, its row for beta) and computes one logsumexp of K
// terms, K expf and one logf where a thread per chain ran K^2 and K. The
// elements do not depend on the carry, and what a lane loads for them is
// in flight the ring's depth less one steps ahead (kHmmRing,
// kHmmStatRing): a ring in shared memory, filled by cp.async, one group of
// copies a step (the step clamped at the chain's end), so that a step
// waits only on its own group. A ring of registers
// did not pay here, though its loads were unconditional: nvcc moved each
// new load into the ring's register right after issuing it, and the move
// waits for the load, a whole L2 latency a step (its SASS).
//
// The two kernels differ only in where a lane's elements come from.
// hmm_fb_fwd_kernel rings its K elements of M_t. hmm_fb_stat_fwd_kernel,
// with M_t(i, j) = LT(i, j) + lo_t(j), holds the lane's K entries of LT in
// registers (column j for alpha, row j for beta), loaded once, and rings
// only observations: an alpha lane needs lo_t(j) alone, a beta lane
// lo_t(k) for every k, which it takes from lane k of its segment by a
// shuffle (ringing all K in each lane, K copies a step, ran slower). It
// forms (lt + lo) before adding the carry, so its elements are those the
// streamed kernel reads from M = LT + lo formed in float32. The logsumexp
// keeps the op order of the thread-per-chain kernels (the max, then the
// sum in index order), so both kernels' outputs are bitwise those of the
// kernels they replaced, and the stationary kernel's are the streamed
// kernel's on the packed LT + lo. Streams keep the lane innermost
// ((T-1, K*K, B) and (T-1, K, B)); T and B are runtime arguments, K a
// template parameter, so the loops unroll.

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

// How many steps ahead a lane of the stationary kernel loads its
// observations (chip_variants.py).
constexpr int kHmmStatRing = 8;

// A lane's place in a chain kernel, one warp a block: segment_lanes(K)
// lanes a chain, chain c = alpha lane c < B or beta lane c - B. In the last
// warp, lanes past the last chain (and K = 3's idle lane) shadow a real
// lane and are not live: they compute, so that every shuffle has its
// lanes, and store nothing. A warp past the last chain leaves whole
// first (warp_past_chains).
struct ChainLane {
  bool live, fwd;
  int j, b;  // the state the lane owns, the sequence
};

template <int K>
__device__ __forceinline__ bool warp_past_chains(int B) {
  return (int)blockIdx.x * kThreads / segment_lanes(K) >= 2 * B;
}

template <int K>
__device__ __forceinline__ ChainLane chain_lane(int B) {
  constexpr int W = segment_lanes(K);
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int chain = min(g / W, 2 * B - 1);
  const bool fwd = chain < B;
  return {g / W < 2 * B && g % W < K, fwd, min(g % W, K - 1),
          fwd ? chain : chain - B};
}

// The T1 steps of the chain of a lane that owns state j of sequence b,
// from alpha_0 (a0 (K, B)) or beta = 0. load(u) issues the copies of the
// next chain step into ring slot u, one group; elem(u, k) gives the lane's
// k-th element of the step in slot u, M_t(k, j) for alpha (t = s),
// M_t(j, k) for beta (t = T1-1-s). Steps s+1 ... s+R-1 are in flight
// while step s computes; the loop is unrolled by R so that every slot is a
// constant. Writes the carry's state j at each step: alpha_1..alpha_T1,
// beta_{T1-1}..beta_0 (T1, K, B).
template <int K, int R, class Load, class Elem>
__device__ __forceinline__ void chain_steps(int B, int T1, ChainLane ln,
                                            const float* __restrict__ a0,
                                            float* __restrict__ alpha,
                                            float* __restrict__ beta,
                                            Load load, Elem elem) {
  constexpr int W = segment_lanes(K);
  const bool live = ln.live, fwd = ln.fwd;
  const int j = ln.j, b = ln.b;
  const long long KB = (long long)K * B;
#pragma unroll
  for (int u = 0; u < R; ++u) load(u);
  // j * B + b spelled out at each use: one shared 64-bit offset gives
  // hmm_fb_fwd_kernel 1-2 more registers at K = 2, 3, 4 (ptxas)
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
        const float m = elem(u, k);
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

// Layouts: a0 (K, B); M (T1, K*K, B), entry i*K + j; out alpha, beta
// (T1, K, B): alpha_1..alpha_T1 and beta_0..beta_{T1-1}.
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_fwd_kernel(int B, int T1, const float* __restrict__ a0,
                  const float* __restrict__ M, float* __restrict__ alpha,
                  float* __restrict__ beta) {
  constexpr int R = kHmmRing;
  // the ring: slot u holds the lane's K elements of a coming step
  __shared__ float ring[R][K][kThreads];
  if (warp_past_chains<K>(B)) return;
  const ChainLane ln = chain_lane<K>(B);
  const int lane = threadIdx.x;
  const long long KB = (long long)K * B, KKB = KB * K;
  // the lane's K elements of chain step s (column j of M_t for alpha, t =
  // s; row j for beta, t = T1-1-s), k-th at src + k * stride; the source
  // steps down M's rows one step a load and stays at the chain's last
  const long long stride = ln.fwd ? KB : B;
  const long long step = ln.fwd ? KKB : -KKB;
  long long src =
      (ln.fwd ? (long long)ln.j * B : (T1 - 1) * KKB + ln.j * KB) + ln.b;
  const long long last = src + (T1 - 1) * step;
  chain_steps<K, R>(
      B, T1, ln, a0, alpha, beta,
      [&](int u) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          cp_async4(&ring[u][k][lane], M + src + k * stride);
        cp_async_commit();
        src = src == last ? src : src + step;
      },
      [&](int u, int k) { return ring[u][k][lane]; });
}

// As hmm_fb_fwd_kernel with M_t(i, j) = LT(i, j) + lo_t(j). Layouts: a0
// (K, B); LT (K, K); lo (T1, K, B); out alpha, beta (T1, K, B).
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_stat_fwd_kernel(int B, int T1, const float* __restrict__ a0,
                       const float* __restrict__ LT,
                       const float* __restrict__ lo,
                       float* __restrict__ alpha, float* __restrict__ beta) {
  constexpr int R = kHmmStatRing, W = segment_lanes(K);
  // the ring: slot u holds the lane's observation of a coming step
  __shared__ float ring[R][kThreads];
  if (warp_past_chains<K>(B)) return;
  const ChainLane ln = chain_lane<K>(B);
  const int lane = threadIdx.x;
  // the lane's K entries of LT: column j (LT(k, j)) for alpha, row j
  // (LT(j, k)) for beta, the same at every step
  float lt[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    lt[k] = LT[ln.fwd ? k * K + ln.j : ln.j * K + k];
  const long long KB = (long long)K * B;
  // the lane's observation of chain step s, lo_t(j) (t = s for alpha,
  // T1-1-s for beta); the source steps down lo's rows one step a load and
  // stays at the chain's last
  const long long step = ln.fwd ? KB : -KB;
  long long src = (ln.fwd ? 0 : (T1 - 1) * KB) + (long long)ln.j * B + ln.b;
  const long long last = src + (T1 - 1) * step;
  chain_steps<K, R>(
      B, T1, ln, a0, alpha, beta,
      [&](int u) {
        cp_async4(&ring[u][lane], lo + src);
        cp_async_commit();
        src = src == last ? src : src + step;
      },
      [&](int u, int k) {
        // lo_t(k) from lane k of the segment; an alpha lane keeps its own
        const float o = ring[u][lane];
        const float ok = __shfl_sync(0xffffffffu, o, k, W);
        return lt[k] + (ln.fwd ? o : ok);
      });
}

// The kernels' blocks: 2B chains of segment_lanes(K) lanes.
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
#define SVAE_CASE(KS)                                                     \
  case KS:                                                                \
    hmm_fb_stat_fwd_kernel<KS><<<segment_grid<KS>(B), kThreads, 0, st>>>( \
        B, T1, a0, LT, lo, alpha, beta);                                  \
    return (int)cudaGetLastError();
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}
