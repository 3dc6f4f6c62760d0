// Hopper kernels of the adjoint of the packed stationary LDS filter
// (estep.cu's filter_fwd_kernel), in two passes.
//
// They replace svae_tpu/ops/pallas_estep.py:_filter_adj_kernel.
//
// What bounds it on an H100. Each (sequence, direction) is a serial chain:
// step t's cotangent needs step t+1's. At the main-path shape (B=64,
// T=100, d=10) there are 2B = 128 chains of T-1 = 99 steps. The bound is
// the function's bytes (chip_smoke.bound: ~3 us), far below what the
// serial chains allow, so what the design can cut is the latency of one
// chain's step. The earlier kernel walked each chain on one thread (4
// blocks of 32 threads: 4 of the 132 SMs), recomputing the step's Cholesky
// factor and two d x d triangular solves in front of the carried algebra,
// at 13 us a step and with 5,924 bytes of spills at d=10.
//
// What the design does about it. Only G = M-bar' + dJ_t and g = h-bar' +
// dh_t depend on the carried cotangents; the factorization of the step's
// M = J_pre + A (+ diag jd backward) does not. So, in the Pallas kernel's
// own form with W = M^-1:
//
// 1. filter_adj_factor_kernel runs one thread per (step, lane), 12,672 at
//    config 2: it factors M, inverts it in place and writes W, K = W D^T
//    and w = W v for the step, lane-minor ((step, [W | K | w], lane)), so
//    that a warp's stores coalesce. (Written chain-major, one contiguous
//    row per (lane, step), its stores scattered and the pass was several
//    times slower than the chain pass's reads of the lane-minor rows.)
// 2. filter_adj_chain_kernel runs one chain per block of d*d threads,
//    thread (i, j) owning entry (i, j) of every d x d matrix. With
//    Gs = G + G^T, P = K Gs and a = K g, a step is products only:
//      M-bar = 1/2 P K^T - 1/2 (a w^T + w a^T) - 1/2 lam (w w^T + W),
//      h-bar = lam w + a,
//    the earlier kernel's L^-T Z L^-1 and L^-T (lam z + a) with L^-T Y = K
//    and L^-T z = w: two dot products of length d a thread, between four
//    block barriers. The parameter sums stay in each thread's registers,
//    off the carried chain: dA += M-bar, dC += G and dD += -P^T + g w^T
//    (Gs K^T = (K Gs)^T). The next steps' K_ij, W_ij, w, dJ_ij and dh_i
//    are loaded into a ring of registers while a step computes. K, G, Gs
//    and P sit in shared memory with rows padded to d+1 floats, so that
//    a thread's row or column read is free of bank conflicts and the
//    rest are broadcasts. (One thread a row, or a few a row, the d^2
//    products per thread were not what set the step's time: the same
//    design at d threads a chain took longer a step.)
//
// The factor row and the chain step live in adj_passes.cuh
// (store_filter_factor, filter_chain_stage, filter_chain_products), shared
// with bidir_adj.cu, whose adjoint has the same algebra on per-lane streams.
//
// Node cotangents are written per direction in frame order, (2, 2, T, d,
// B) (kind, direction), each entry by one lane once, and the wrapper adds
// the two directions; dA, dC, dD are written per lane as (3, d*d, 2B), and
// the wrapper sums the lanes. No atomics: every sum is deterministic.

#include "adj_passes.cuh"

namespace {

// Floats of one (step, lane) of the factor pass's output: W, K, w.
template <int D>
struct FacRow {
  static constexpr int value = 2 * D * D + D;
};

// One thread per (step t, lane), lane = r*B + b fastest. Inputs as the
// forward's: J0 (d*d, 2B), h0 (d, 2B), A, D (2, d, d), jd, n2 (T, d, B),
// the forward's outputs J (T-1, d*d, 2B), h (T-1, d, 2B) (step t's
// pre-step message is J0/h0 at t = 0, the output of step t-1 otherwise).
// Output fac (T-1, 2d^2 + d, 2B): W, K (row-major d x d), w.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
filter_adj_factor_kernel(int B, int T, const float* __restrict__ J0,
                         const float* __restrict__ h0,
                         const float* __restrict__ A,
                         const float* __restrict__ Dm,
                         const float* __restrict__ jd,
                         const float* __restrict__ n2,
                         const float* __restrict__ Jf,
                         const float* __restrict__ hf,
                         float* __restrict__ fac) {
  constexpr int DD = D * D;
  constexpr int R = FacRow<D>::value;
  __shared__ float sA[2 * DD], sD[2 * DD];
  for (int k = threadIdx.x; k < 2 * DD; k += blockDim.x) {
    sA[k] = A[k];
    sD[k] = Dm[k];
  }
  __syncthreads();
  const int NL = 2 * B, T1 = T - 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * NL) return;
  const int t = idx / NL;
  const int lane = idx - t * NL;
  const int r = lane >= B ? 1 : 0;
  const int b = lane - r * B;
  const int frame = r == 0 ? t + 1 : T - 1 - t;
  const float* a = sA + r * DD;
  const float* dm = sD + r * DD;
  const float* Jp = t == 0 ? J0 : Jf + (size_t)(t - 1) * DD * NL;
  const float* hp = t == 0 ? h0 : hf + (size_t)(t - 1) * D * NL;

  float L[D][D], rd[D], v[D];
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
SVAE_PASS_UNROLL
    for (int j = 0; j <= i; ++j)
      L[i][j] = Jp[(i * D + j) * NL + lane] + a[i * D + j];
    v[i] = hp[i * NL + lane];
    if (r == 1) {
      L[i][i] += jd[(frame * D + i) * B + b];
      v[i] += n2[(frame * D + i) * B + b];
    }
  }
  chol_inplace<D>(L, rd);
  inverse_from_chol<D>(L, rd);  // L now holds the lower triangle of W
  // fac (T-1, R, 2B): lane-minor, so that the warp's stores coalesce
  store_filter_factor<D>(
      L, v, [&](int j, int k) { return dm[j * D + k]; },
      fac + (size_t)t * R * NL + lane, NL);
}

// How many steps ahead the chain pass loads.
constexpr int kFilterRing = 2;

// One block of d*d threads per lane (chain) r*B + b, thread (i, j)
// owning entry (i, j) of every d x d matrix of the step, walking t = T-2
// ... 0. Inputs: fac from filter_adj_factor_kernel, the cotangents dJ
// (T-1, d*d, 2B), dh (T-1, d, 2B) and dln (2B). Outputs: dnode (2, 2, T,
// d, B) = [djd, dn2] x [forward, backward] in frame order (frame 0 is
// zero: it reaches the filter only through J0/h0), dJ0 (d*d, 2B), dh0 (d,
// 2B) and dpar (3, d*d, 2B) = per-lane [dA, dC, dD].
template <int D>
__global__ void __launch_bounds__(D * D)
filter_adj_chain_kernel(int B, int T, const float* __restrict__ fac,
                        const float* __restrict__ dJ,
                        const float* __restrict__ dh,
                        const float* __restrict__ dln,
                        float* __restrict__ dnode, float* __restrict__ dJ0,
                        float* __restrict__ dh0, float* __restrict__ dpar) {
  constexpr int DD = D * D;
  constexpr int R = FacRow<D>::value;
  constexpr int SP = FilterChainShared<D>::SP;
  constexpr int Q = kFilterRing;
  __shared__ FilterChainShared<D> sm;
  const int lane = blockIdx.x;
  const int i = threadIdx.x / D;
  const int j = threadIdx.x - i * D;
  const int NL = 2 * B, T1 = T - 1;
  const int r = lane >= B ? 1 : 0;
  const int b = lane - r * B;
  const size_t plane = (size_t)T * D * B;
  float* djd_out = dnode + r * plane;
  float* dn2_out = dnode + (2 + r) * plane;
  const float lam = dln[lane];

  // entry (i, j) of the carried M-bar and of the parameter sums; h-bar_i
  float Mc = 0.f, aA = 0.f, aC = 0.f, aD = 0.f, hc = 0.f;

  // steps t-1 ... t-Q in flight while step t computes: a ring of Q
  // register slots, the loop unrolled by Q so that every slot index is a
  // constant. A slot holds K_ij, W_ij, dJ_ij, w_i, w_j and dh_i of its
  // step (all lane-minor).
  float nK[Q], nW[Q], ndJ[Q], nwi[Q], nwj[Q], ndh[Q];
  // (The loads are unconditional, the step clamped to 0: a load under a
  // condition leaves its slot's register to merge two values, and the
  // move that merges them waits for the load at once.)
  auto load = [&](int t, int u) {
    t = t > 0 ? t : 0;
    const float* f = fac + (size_t)t * R * NL + lane;
    nW[u] = f[(i * D + j) * NL];
    nK[u] = f[(DD + i * D + j) * NL];
    nwi[u] = f[(2 * DD + i) * NL];
    nwj[u] = f[(2 * DD + j) * NL];
    ndJ[u] = dJ[((size_t)t * DD + i * D + j) * NL + lane];
    ndh[u] = dh[((size_t)t * D + i) * NL + lane];
  };
#pragma unroll
  for (int u = 0; u < Q; ++u) load(T1 - 1 - u, u);
  for (int t0 = T1 - 1; t0 >= 0; t0 -= Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int t = t0 - u;
      if (t < 0) break;
      // step t's slot into place, then step t-Q's loads in flight
      const float Wij = nW[u], wi = nwi[u], wj = nwj[u];
      const float G = Mc + ndJ[u];
      const float g = hc + ndh[u];
      filter_chain_stage<D>(sm, i, j, nK[u], G, g);
      load(t - Q, u);
      __syncthreads();
      filter_chain_products<D>(sm, i, j, G, Wij, wi, wj, lam, Mc, hc);
      // node cotangents: evidence enters C forward and A backward
      if (i == j) {
        const int frame = r == 0 ? t + 1 : T - 1 - t;
        djd_out[(frame * D + i) * B + b] = r == 0 ? G : Mc;
        dn2_out[(frame * D + i) * B + b] = r == 0 ? g : hc;
      }
      // the parameter sums: dA += M-bar, dC += G, dD += g w^T - P^T
      aA += Mc;
      aC += G;
      aD += g * wj - sm.P[j * SP + i];
      __syncthreads();
    }
  }

  if (j == 0) {
    djd_out[i * B + b] = 0.f;
    dn2_out[i * B + b] = 0.f;
    dh0[i * NL + lane] = hc;
  }
  dJ0[(i * D + j) * NL + lane] = Mc;
  dpar[(i * D + j) * NL + lane] = aA;
  dpar[(DD + i * D + j) * NL + lane] = aC;
  dpar[(2 * DD + i * D + j) * NL + lane] = aD;
}

template <int D>
int launch_factor(int B, int T, const float* J0, const float* h0,
                  const float* A, const float* Dm, const float* jd,
                  const float* n2, const float* J, const float* h,
                  float* fac, cudaStream_t stream) {
  const int n = (T - 1) * 2 * B;
  filter_adj_factor_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          B, T, J0, h0, A, Dm, jd, n2, J, h, fac);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chain(int B, int T, const float* fac, const float* dJ,
                 const float* dh, const float* dln, float* dnode, float* dJ0,
                 float* dh0, float* dpar, cudaStream_t stream) {
  filter_adj_chain_kernel<D><<<2 * B, D * D, 0, stream>>>(
      B, T, fac, dJ, dh, dln, dnode, dJ0, dh0, dpar);
  return (int)cudaGetLastError();
}

template <int D>
int launch_filter_adj(int B, int T, const float* J0, const float* h0,
                      const float* A, const float* Dm, const float* jd,
                      const float* n2, const float* J, const float* h,
                      const float* dJ, const float* dh, const float* dln,
                      float* fac, float* dnode, float* dJ0, float* dh0,
                      float* dpar, cudaStream_t stream) {
  const int err = launch_factor<D>(B, T, J0, h0, A, Dm, jd, n2, J, h, fac,
                                   stream);
  if (err != 0) return err;
  return launch_chain<D>(B, T, fac, dJ, dh, dln, dnode, dJ0, dh0, dpar,
                         stream);
}

}  // namespace

// Plain C entries for ctypes; each returns cudaGetLastError() after its
// launches (0 on success), cudaErrorInvalidValue for an unsupported d.
// svae_filter_adj_f32 runs both passes (fac is its scratch, (T-1, 2d^2 +
// d, 2B)); the other two run one pass each.
extern "C" int SVAE_ENTRY(svae_filter_adj_f32)(int d, int B, int T, const float* J0,
                                   const float* h0, const float* A,
                                   const float* Dm, const float* jd,
                                   const float* n2, const float* J,
                                   const float* h, const float* dJ,
                                   const float* dh, const float* dln,
                                   float* fac, float* dnode, float* dJ0,
                                   float* dh0, float* dpar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                       \
  case DIM:                                                                  \
    return launch_filter_adj<DIM>(B, T, J0, h0, A, Dm, jd, n2, J, h, dJ, dh, \
                                  dln, fac, dnode, dJ0, dh0, dpar, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_filter_adj_factor_f32)(int d, int B, int T,
                                          const float* J0, const float* h0,
                                          const float* A, const float* Dm,
                                          const float* jd, const float* n2,
                                          const float* J, const float* h,
                                          float* fac, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_factor<DIM>(B, T, J0, h0, A, Dm, jd, n2, J, h, fac, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_filter_adj_chain_f32)(int d, int B, int T,
                                         const float* fac, const float* dJ,
                                         const float* dh, const float* dln,
                                         float* dnode, float* dJ0,
                                         float* dh0, float* dpar,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_chain<DIM>(B, T, fac, dJ, dh, dln, dnode, dJ0, dh0, dpar, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
