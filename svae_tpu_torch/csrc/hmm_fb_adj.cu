// Hopper kernels of the adjoint of the HMM forward-backward pass (the
// backward of ops/hmm_fb.py's HmmFb and HmmFbStat).
//
// The three kernels of the streamed adjoint together replace
// svae_tpu/ops/pallas_hmm.py:_hmm_fb_adj_kernel; those of the stationary
// adjoint (its weight pass, the streamed adjoint's chain pass and a sums
// pass) replace svae_tpu/ops/pallas_hmm.py:_hmm_fb_stat_adj_kernel.
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
// the latency of each chain's serial steps, with far fewer chains than
// the card has threads; the bytes (about 0.3 MB at B=16, T=80, K=4) are
// far below what the card moves in that time.
//
// What the design does about it. The weights w and v depend only on M and
// the forward's messages, not on the carried cotangent, so they leave the
// chain (the rule of the other adjoints' factor passes, adj_passes.cuh):
// 1. hmm_fb_adj_weights_kernel runs one thread per (step, entry i*K + j,
//    sequence), the sequence fastest, and writes W_t = [w_ij] and V_t =
//    [v_ij] lane-minor in M's layout: every expf of the adjoint is here.
//    It reads alpha_t at step t and the step before (a0 at t = 0), beta_t
//    and beta_{t+1} (0 at the last step), so no shifted copies are built.
// 2. hmm_fb_adj_chain_kernel runs each chain on segment_lanes(K) lanes of
//    a warp, as hmm_fb_fwd_kernel does, lane i owning state i of the
//    carry: the alpha chains (lanes [0, B) of 2B) descending, g = c +
//    dalpha_t, c'(i) = sum_j g_j w_t(i, j); the beta chains ascending, h =
//    c + dbeta_t, c'(j) = sum_i h_i v_t(i, j). A step is K shuffles and K
//    multiply-adds in the index order of the thread-per-chain kernel; the
//    lane's row of W_t (column of V_t) and direct cotangent for the next
//    kHmmAdjRing - 1 steps are in flight in a ring in shared memory, as
//    in hmm_fb_fwd_kernel. It writes g_t and h_t (T-1, K, B) and da0.
// 3. hmm_fb_adj_dM_kernel, one thread per (step, entry, sequence), writes
//    dM_t(i, j) = g_t(j) w_ij + h_t(i) v_ij once: both directions' parts,
//    summed in the kernel.
// svae_hmm_fb_adj_f32 launches the three, one after the other, with W, V,
// g and h as the caller's scratch.
//
// The stationary adjoint, M_t(i, j) = LT(i, j) + lo_t(j), runs the same
// weights and chains: its weight pass is hmm_fb_adj_weights_kernel's body
// (adj_weights) reading m as LT(i, j) + lo_t(j) from the (K, K) matrix and
// the observation stream, in the grouping p + (lt + ob) - q, so its
// weights are the streamed pass's on M = LT + lo bit for bit; the chain
// pass is hmm_fb_adj_chain_kernel as it is. What is left is two sums,
// which hmm_fb_stat_adj_sums_kernel takes in one launch:
//   dlo_t(j) = g_t(j) + sum_i h_t(i) v_t(i, j): the alpha half is g itself,
//     since sum_i w_ij = 1, and the beta half is the beta chain's new
//     carry, recomputed here (the chain pass stores h, the carry plus the
//     direct cotangent); one thread per (step, state, sequence);
//   dLT(i, j) = sum_{t, b} g_t(j) w_ij + h_t(i) v_ij, the sum of the
//     streamed dM over steps and sequences: a block per entry, each thread
//     summing a fixed stride of the (T-1) B terms, then a tree in shared
//     memory; the order is fixed, so the result is deterministic.
// svae_hmm_fb_stat_adj_f32 launches the three passes with W, V, g and h
// as the caller's scratch. No two threads write one address and there are
// no atomics. T and B are runtime arguments, K a template parameter;
// streams keep the lane innermost.

#include "adj_passes.cuh"

namespace {

// How many steps ahead a lane of the chain pass loads (chip_variants.py;
// the chain pass runs one warp a block: four ran slower).
constexpr int kHmmAdjRing = 8;

// How many threads a block of the stationary adjoint's sums pass runs.
constexpr int kSumThreads = 512;

// The weight pass's body, one thread per (step t, entry e = i*K + j,
// sequence b), b fastest. Inputs: a0 (K, B); alpha, beta (T1, K, B) as the
// forward kernels return them; elem(idx, t, i, j, b) gives the chain
// element M_t(i, j) of sequence b (idx its index in (T1, K*K, B)). Outputs
// W, V (T1, K*K, B): w_ij from alpha_t (a0 at t = 0) and alpha_{t+1}, v_ij
// from beta_t and beta_{t+1} (0 at the last step).
template <int K, class Elem>
__device__ __forceinline__ void adj_weights(int B, int T1,
                                            const float* __restrict__ a0,
                                            const float* __restrict__ alpha,
                                            const float* __restrict__ beta,
                                            float* __restrict__ W,
                                            float* __restrict__ V,
                                            Elem elem) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)T1 * K * K * B) return;
  const int b = (int)(idx % B);
  const size_t r = idx / B;
  const int e = (int)(r % (K * K)), t = (int)(r / (K * K));
  const int i = e / K, j = e - i * K;
  const size_t vec = (size_t)t * K * B + b;
  const float m = elem(idx, t, i, j, b);
  const float p = t > 0 ? alpha[vec - (size_t)K * B + (size_t)i * B]
                        : a0[(size_t)i * B + b];
  W[idx] = expf(p + m - alpha[vec + (size_t)j * B]);
  const float q = t < T1 - 1 ? beta[vec + (size_t)(K + j) * B] : 0.f;
  V[idx] = expf(m + q - beta[vec + (size_t)i * B]);
}

// The streamed adjoint's weight pass: the elements from M (T1, K*K, B).
template <int K>
__global__ void __launch_bounds__(kPassThreads)
hmm_fb_adj_weights_kernel(int B, int T1, const float* __restrict__ a0,
                          const float* __restrict__ M,
                          const float* __restrict__ alpha,
                          const float* __restrict__ beta,
                          float* __restrict__ W, float* __restrict__ V) {
  adj_weights<K>(B, T1, a0, alpha, beta, W, V,
                 [&](size_t idx, int, int, int, int) { return M[idx]; });
}

// The stationary adjoint's weight pass: the elements LT(i, j) + lo_t(j)
// from LT (K, K) and lo (T1, K, B).
template <int K>
__global__ void __launch_bounds__(kPassThreads)
hmm_fb_stat_adj_weights_kernel(int B, int T1, const float* __restrict__ a0,
                               const float* __restrict__ LT,
                               const float* __restrict__ lo,
                               const float* __restrict__ alpha,
                               const float* __restrict__ beta,
                               float* __restrict__ W,
                               float* __restrict__ V) {
  adj_weights<K>(B, T1, a0, alpha, beta, W, V,
                 [&](size_t, int t, int i, int j, int b) {
                   return LT[i * K + j] + lo[((size_t)t * K + j) * B + b];
                 });
}

// segment_lanes(K) lanes a chain, chain c = alpha lane c < B (descending
// t) or beta lane c - B (ascending); one warp a block. Inputs: W, V from
// the weight pass; dalpha, dbeta (T1, K, B), the cotangents of the
// forward's outputs. Outputs: g (the alpha chains' g_t), h (the beta
// chains' h_t), (T1, K, B) each; da0 (K, B).
template <int K>
__global__ void __launch_bounds__(kThreads)
hmm_fb_adj_chain_kernel(int B, int T1, const float* __restrict__ W,
                        const float* __restrict__ V,
                        const float* __restrict__ dalpha,
                        const float* __restrict__ dbeta,
                        float* __restrict__ g, float* __restrict__ h,
                        float* __restrict__ da0) {
  constexpr int S = segment_lanes(K), R = kHmmAdjRing;
  // the ring: slot u holds the lane's K weights and its direct cotangent
  // of a coming step
  __shared__ float ring[R][K + 1][kThreads];
  const int lane = threadIdx.x;
  const int gid = blockIdx.x * kThreads + lane;
  // as hmm_fb_fwd_kernel: a warp past the last chain leaves whole; lanes
  // past it and K = 3's idle lane shadow a real lane and store nothing
  if ((gid - lane) / S >= 2 * B) return;
  const bool live = gid / S < 2 * B && gid % S < K;
  const int chain = min(gid / S, 2 * B - 1);
  const int i = min(gid % S, K - 1);  // the state this lane owns
  const bool fwd = chain < B;
  const int b = fwd ? chain : chain - B;
  const long long KB = (long long)K * B, KKB = KB * K;
  // chain step s is t = T1-1-s for alpha, t = s for beta; the lane's K
  // weights (row i of W_t, column i of V_t) at X + src + k * stride, its
  // direct cotangent at dX + vec; both step one row a load and stay at the
  // chain's last
  const float* X = fwd ? W : V;
  const float* dX = fwd ? dalpha : dbeta;
  const long long stride = fwd ? B : KB;
  const long long step = fwd ? -KKB : KKB, vstep = fwd ? -KB : KB;
  const long long t0 = fwd ? T1 - 1 : 0;
  long long src = t0 * KKB + (fwd ? i * KB : (long long)i * B) + b;
  long long vec = t0 * KB + (long long)i * B + b;
  const long long last = src + (T1 - 1) * step;
  auto load = [&](int u) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      cp_async4(&ring[u][k][lane], X + src + k * stride);
    cp_async4(&ring[u][K][lane], dX + vec);
    cp_async_commit();
    const bool more = src != last;
    src = more ? src + step : src;
    vec = more ? vec + vstep : vec;
  };
#pragma unroll
  for (int u = 0; u < R; ++u) load(u);

  float c = 0.f;  // the carried cotangent's state i
  float* out = (fwd ? g : h) + t0 * KB + (long long)i * B + b;
  for (int s0 = 0; s0 < T1; s0 += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (s0 + u >= T1) break;
      cp_async_wait<R - 1>();
      const float gi = c + ring[u][K][lane];
      if (live) *out = gi;
      out += vstep;
      float n = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        n += __shfl_sync(0xffffffffu, gi, k, S) * ring[u][k][lane];
      c = n;
      load(u);  // step s+R into the slot just read
    }
  }
  cp_async_wait<0>();
  if (fwd && live) da0[(long long)i * B + b] = c;
}

// One thread per (step t, entry e = i*K + j, sequence b), b fastest:
// dM_t(i, j) = g_t(j) w_ij + h_t(i) v_ij. Inputs: W, V from the weight
// pass, g, h from the chain pass. Output dM (T1, K*K, B).
template <int K>
__global__ void __launch_bounds__(kPassThreads)
hmm_fb_adj_dM_kernel(int B, int T1, const float* __restrict__ W,
                     const float* __restrict__ V,
                     const float* __restrict__ g,
                     const float* __restrict__ h, float* __restrict__ dM) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)T1 * K * K * B) return;
  const int b = (int)(idx % B);
  const size_t r = idx / B;
  const int e = (int)(r % (K * K)), t = (int)(r / (K * K));
  const int i = e / K, j = e - i * K;
  const size_t vec = (size_t)t * K * B + b;
  dM[idx] = g[vec + (size_t)j * B] * W[idx] + h[vec + (size_t)i * B] * V[idx];
}

// The stationary adjoint's sums pass: blocks 0 ... K*K-1 reduce dLT, a
// block an entry e = i*K + j, thread k summing the terms (t, b) of index
// k, k + kSumThreads, ... of the T1*B, then a tree in shared memory; the
// blocks after them write dlo, a thread per (step t, state j, sequence b),
// b fastest: dlo_t(j) = g_t(j) + sum_i h_t(i) v_t(i, j), the sum in the
// index order of the chain pass's carry. Inputs: W, V (T1, K*K, B) from
// the weight pass, g, h (T1, K, B) from the chain pass. Outputs: dlo (T1,
// K, B) and dLT (K, K).
template <int K>
__global__ void __launch_bounds__(kSumThreads)
hmm_fb_stat_adj_sums_kernel(int B, int T1, const float* __restrict__ W,
                            const float* __restrict__ V,
                            const float* __restrict__ g,
                            const float* __restrict__ h,
                            float* __restrict__ dlo,
                            float* __restrict__ dLT) {
  constexpr int KK = K * K;
  const long long KB = (long long)K * B, KKB = KB * K;
  const int tid = threadIdx.x;
  if (blockIdx.x < KK) {
    __shared__ float red[kSumThreads];
    const int e = blockIdx.x, i = e / K, j = e - i * K;
    const int n = T1 * B;
    float s = 0.f;
#pragma unroll 4
    for (int q = tid; q < n; q += kSumThreads) {
      const int t = q / B, b = q - t * B;
      const long long at = t * KKB + (long long)e * B + b;
      const long long vec = t * KB + b;
      s += g[vec + (long long)j * B] * W[at] +
           h[vec + (long long)i * B] * V[at];
    }
    red[tid] = s;
    __syncthreads();
#pragma unroll
    for (int o = kSumThreads / 2; o > 0; o /= 2) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
    if (tid == 0) dLT[e] = red[0];
    return;
  }
  const long long idx = (long long)(blockIdx.x - KK) * kSumThreads + tid;
  if (idx >= T1 * KB) return;
  const int b = (int)(idx % B);
  const long long r = idx / B;
  const int j = (int)(r % K), t = (int)(r / K);
  const long long vec = t * KB + b, at = t * KKB + (long long)j * B + b;
  float n = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i)
    n += h[vec + (long long)i * B] * V[at + (long long)i * K * B];
  dlo[idx] = g[idx] + n;
}


// The streamed adjoint's passes (n = (T-1) K^2 B threads for the weight
// and dM passes, 2B chains of segment_lanes(K) lanes for the chain pass).
template <int K>
int launch_weights(int B, int T1, const float* a0, const float* M,
                   const float* alpha, const float* beta, float* W, float* V,
                   cudaStream_t st) {
  const size_t n = (size_t)T1 * K * K * B;
  hmm_fb_adj_weights_kernel<K><<<(unsigned)((n + kPassThreads - 1) /
                                            kPassThreads),
                                 kPassThreads, 0, st>>>(B, T1, a0, M, alpha,
                                                        beta, W, V);
  return (int)cudaGetLastError();
}

template <int K>
int launch_stat_weights(int B, int T1, const float* a0, const float* LT,
                        const float* lo, const float* alpha,
                        const float* beta, float* W, float* V,
                        cudaStream_t st) {
  const size_t n = (size_t)T1 * K * K * B;
  hmm_fb_stat_adj_weights_kernel<K><<<(unsigned)((n + kPassThreads - 1) /
                                                 kPassThreads),
                                      kPassThreads, 0, st>>>(
      B, T1, a0, LT, lo, alpha, beta, W, V);
  return (int)cudaGetLastError();
}

template <int K>
int launch_chain(int B, int T1, const float* W, const float* V,
                 const float* dalpha, const float* dbeta, float* g, float* h,
                 float* da0, cudaStream_t st) {
  const int threads = 2 * B * segment_lanes(K);
  hmm_fb_adj_chain_kernel<K><<<(threads + kThreads - 1) / kThreads, kThreads,
                               0, st>>>(B, T1, W, V, dalpha, dbeta, g, h, da0);
  return (int)cudaGetLastError();
}

template <int K>
int launch_dM(int B, int T1, const float* W, const float* V, const float* g,
              const float* h, float* dM, cudaStream_t st) {
  const size_t n = (size_t)T1 * K * K * B;
  hmm_fb_adj_dM_kernel<K><<<(unsigned)((n + kPassThreads - 1) /
                                       kPassThreads),
                            kPassThreads, 0, st>>>(B, T1, W, V, g, h, dM);
  return (int)cudaGetLastError();
}

// K*K dLT blocks, then the dlo blocks of T1*K*B threads.
template <int K>
int launch_sums(int B, int T1, const float* W, const float* V, const float* g,
                const float* h, float* dlo, float* dLT, cudaStream_t st) {
  const long long n = (long long)T1 * K * B;
  const unsigned blocks =
      (unsigned)(K * K + (n + kSumThreads - 1) / kSumThreads);
  hmm_fb_stat_adj_sums_kernel<K><<<blocks, kSumThreads, 0, st>>>(
      B, T1, W, V, g, h, dlo, dLT);
  return (int)cudaGetLastError();
}

template <int K>
int launch_stat_adj(int B, int T1, const float* a0, const float* LT,
                    const float* lo, const float* alpha, const float* beta,
                    const float* dalpha, const float* dbeta, float* W,
                    float* V, float* g, float* h, float* dlo, float* da0,
                    float* dLT, cudaStream_t st) {
  int err = launch_stat_weights<K>(B, T1, a0, LT, lo, alpha, beta, W, V, st);
  if (err) return err;
  err = launch_chain<K>(B, T1, W, V, dalpha, dbeta, g, h, da0, st);
  if (err) return err;
  return launch_sums<K>(B, T1, W, V, g, h, dlo, dLT, st);
}

template <int K>
int launch_adj(int B, int T1, const float* a0, const float* M,
               const float* alpha, const float* beta, const float* dalpha,
               const float* dbeta, float* W, float* V, float* g, float* h,
               float* dM, float* da0, cudaStream_t st) {
  int err = launch_weights<K>(B, T1, a0, M, alpha, beta, W, V, st);
  if (err) return err;
  err = launch_chain<K>(B, T1, W, V, dalpha, dbeta, g, h, da0, st);
  if (err) return err;
  return launch_dM<K>(B, T1, W, V, g, h, dM, st);
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after its
// launches (0 on success); an unsupported K returns cudaErrorInvalidValue.
// T1 is the number of steps (T-1). svae_hmm_fb_adj_f32 runs the three
// passes (W, V (T-1, K*K, B) and g, h (T-1, K, B) are its scratch); the
// next three run one each. svae_hmm_fb_stat_adj_f32 runs the stationary
// adjoint's three (the same scratch); the two after it run its weight and
// sums passes alone (its chain pass is svae_hmm_fb_adj_chain_f32).
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
                                   const float* dbeta, float* W, float* V,
                                   float* g, float* h, float* dM, float* da0,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS)                                                      \
  case KS:                                                                 \
    return launch_adj<KS>(B, T1, a0, M, alpha, beta, dalpha, dbeta, W, V, \
                          g, h, dM, da0, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_adj_weights_f32(int K, int B, int T1,
                                           const float* a0, const float* M,
                                           const float* alpha,
                                           const float* beta, float* W,
                                           float* V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS) \
  case KS:            \
    return launch_weights<KS>(B, T1, a0, M, alpha, beta, W, V, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_adj_chain_f32(int K, int B, int T1,
                                         const float* W, const float* V,
                                         const float* dalpha,
                                         const float* dbeta, float* g,
                                         float* h, float* da0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS) \
  case KS:            \
    return launch_chain<KS>(B, T1, W, V, dalpha, dbeta, g, h, da0, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_adj_dM_f32(int K, int B, int T1, const float* W,
                                      const float* V, const float* g,
                                      const float* h, float* dM,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS) \
  case KS:            \
    return launch_dM<KS>(B, T1, W, V, g, h, dM, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_stat_adj_f32(
    int K, int B, int T1, const float* a0, const float* LT, const float* lo,
    const float* alpha, const float* beta, const float* dalpha,
    const float* dbeta, float* W, float* V, float* g, float* h, float* dlo,
    float* da0, float* dLT, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS)                                                       \
  case KS:                                                                  \
    return launch_stat_adj<KS>(B, T1, a0, LT, lo, alpha, beta, dalpha,     \
                               dbeta, W, V, g, h, dlo, da0, dLT, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_stat_adj_weights_f32(int K, int B, int T1,
                                                const float* a0,
                                                const float* LT,
                                                const float* lo,
                                                const float* alpha,
                                                const float* beta, float* W,
                                                float* V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS) \
  case KS:            \
    return launch_stat_weights<KS>(B, T1, a0, LT, lo, alpha, beta, W, V, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}

extern "C" int svae_hmm_fb_stat_adj_sums_f32(int K, int B, int T1,
                                             const float* W, const float* V,
                                             const float* g, const float* h,
                                             float* dlo, float* dLT,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(KS) \
  case KS:            \
    return launch_sums<KS>(B, T1, W, V, g, h, dlo, dLT, st);
  SVAE_HMM_SWITCH(SVAE_CASE)
#undef SVAE_CASE
}
