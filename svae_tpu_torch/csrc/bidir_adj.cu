// Hopper kernels of the unified adjoint of the generic bidirectional
// information filter on per-sequence pairs (bpairs.cu's bidir_fwd_kernel),
// in two passes.
//
// They replace svae_tpu/ops/pallas_bidir.py:_bidir_adj_kernel.
//
// What bounds it on an H100. Each lane's cotangent is a serial chain
// descending in the stream coordinate: the forward filter's adjoint runs
// t descending, the backward filter's t ascending, and both are the same
// descending walk over their (pre-reversed) streams. At the ragged slice's
// shape (2B = 128 lanes, T up to 512, d=10) the function's bytes
// (chip_smoke.bound: ~13 us at T=128) are far below what the serial chains
// allow, so what the design can cut is the latency of one chain's step.
// The earlier kernel walked each lane on one thread, re-factoring M and
// running its triangular solves a step, at ~15 us a step and with 428
// bytes of spill stores at d=10.
//
// What the design does about it. The algebra is filter_adj.cu's, on
// per-lane streams: A_t, D_t and f_t stream per step and lane, lam is the
// lane's log-normalizer cotangent (zero on the backward lanes of the
// E-step, whose ln is not used), and every cotangent is written per step
// and lane instead of summed. The factorization of M = J_pre + A_t does
// not depend on the carried cotangents, so:
//
// 1. bidir_adj_factor_kernel runs one thread per (step, lane), 65,408 at
//    ragged T=512: it factors M (J_pre read straight from the forward's
//    input J0 at t = 0 or its output at t-1, so no shifted copies of the
//    messages are made), inverts it in place and writes W = M^-1,
//    K = W D_t^T and w = W (h_pre + f_t), lane-minor, in
//    filter_adj_factor_kernel's row layout.
// 2. bidir_adj_chain_kernel runs one chain per block of d*d threads, as
//    filter_adj_chain_kernel, and shares its step (adj_passes.cuh): with
//    G = M-bar carried + dJ_t, g = h-bar carried + dh_t, Gs = G + G^T,
//    P = K Gs and a = K g,
//      M-bar = 1/2 P K^T - 1/2 (a w^T + w a^T) - 1/2 lam (w w^T + W),
//      h-bar = lam w + a;
//    it writes dC_t = G, de_t = g, dA_t = M-bar, df_t = h-bar and
//    dD_t = -P^T + g w^T per step, and dJ0, dh0 at the end. The next
//    steps' K, W, w, dJ and dh are loaded into a register ring while a
//    step computes.
//
// Every output is per step and lane, each entry written once by its own
// thread: no atomics, no sums.

#include "adj_passes.cuh"

namespace {

// Floats of one (step, lane) of the factor pass's output: W, K, w.
template <int D>
struct FacRow {
  static constexpr int value = 2 * D * D + D;
};

// One thread per (step t, lane), lane fastest. Inputs: the forward's J0
// (d*d, NL), h0 (d, NL), A, D (T1, d*d, NL) (A's lower triangle read),
// F (T1, d, NL) and its outputs J (T1, d*d, NL), h (T1, d, NL). Output
// fac (T1, 2d^2 + d, NL): W, K (row-major d x d), w.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
bidir_adj_factor_kernel(int NL, int T1, const float* __restrict__ J0,
                        const float* __restrict__ h0,
                        const float* __restrict__ A,
                        const float* __restrict__ Dm,
                        const float* __restrict__ F,
                        const float* __restrict__ Jf,
                        const float* __restrict__ hf,
                        float* __restrict__ fac) {
  constexpr int DD = D * D;
  constexpr int R = FacRow<D>::value;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * NL) return;
  const int t = idx / NL;
  const int lane = idx - t * NL;
  const size_t mat = (size_t)t * DD * NL + lane;
  const size_t vec = (size_t)t * D * NL + lane;
  // the forward step again: M = J_pre + A_t, v = h_pre + f_t
  const float* Jp = (t == 0 ? J0 : Jf + (size_t)(t - 1) * DD * NL) + lane;
  const float* hp = (t == 0 ? h0 : hf + (size_t)(t - 1) * D * NL) + lane;

  float L[D][D], rd[D], v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j)
      L[i][j] = Jp[(i * D + j) * NL] + A[mat + (size_t)(i * D + j) * NL];
    v[i] = hp[i * NL] + F[vec + (size_t)i * NL];
  }
  chol_inplace<D>(L, rd);
  inverse_from_chol<D>(L, rd);  // L now holds the lower triangle of W
  // fac (T1, R, NL): lane-minor, so that the warp's stores coalesce
  store_filter_factor<D>(
      L, v, [&](int j, int k) { return Dm[mat + (size_t)(j * D + k) * NL]; },
      fac + (size_t)t * R * NL + lane, NL);
}

// How many steps ahead the chain pass loads.
constexpr int kBidirRing = 2;

// One block of d*d threads per lane (chain), thread (i, j) owning entry
// (i, j) of every d x d matrix of the step, walking t = T1-1 ... 0.
// Inputs: fac from bidir_adj_factor_kernel, the cotangents dJ (T1, d*d,
// NL), dh (T1, d, NL) and dln (NL). Outputs: dA, dC, dD (T1, d*d, NL), dE,
// dF (T1, d, NL), dJ0 (d*d, NL), dh0 (d, NL).
template <int D>
__global__ void __launch_bounds__(D * D)
bidir_adj_chain_kernel(int NL, int T1, const float* __restrict__ fac,
                       const float* __restrict__ dJ,
                       const float* __restrict__ dh,
                       const float* __restrict__ dln,
                       float* __restrict__ dA, float* __restrict__ dC,
                       float* __restrict__ dD, float* __restrict__ dE,
                       float* __restrict__ dF, float* __restrict__ dJ0,
                       float* __restrict__ dh0) {
  constexpr int DD = D * D;
  constexpr int R = FacRow<D>::value;
  constexpr int SP = FilterChainShared<D>::SP;
  constexpr int Q = kBidirRing;
  __shared__ FilterChainShared<D> sm;
  const int lane = blockIdx.x;
  const int i = threadIdx.x / D;
  const int j = threadIdx.x - i * D;
  const int ij = i * D + j;
  const float lam = dln[lane];

  // entry (i, j) of the carried M-bar; h-bar_i
  float Mc = 0.f, hc = 0.f;

  // steps t-1 ... t-Q in flight while step t computes (a ring of Q
  // register slots, as in filter_adj_chain_kernel; unconditional loads,
  // the step clamped to 0)
  float nK[Q], nW[Q], ndJ[Q], nwi[Q], nwj[Q], ndh[Q];
  auto load = [&](int t, int u) {
    t = t > 0 ? t : 0;
    const float* f = fac + (size_t)t * R * NL + lane;
    nW[u] = f[ij * NL];
    nK[u] = f[(DD + ij) * NL];
    nwi[u] = f[(2 * DD + i) * NL];
    nwj[u] = f[(2 * DD + j) * NL];
    ndJ[u] = dJ[((size_t)t * DD + ij) * NL + lane];
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
      const size_t mat = ((size_t)t * DD + ij) * NL + lane;
      dC[mat] = G;
      dA[mat] = Mc;
      dD[mat] = g * wj - sm.P[j * SP + i];
      if (j == 0) {
        const size_t vec = ((size_t)t * D + i) * NL + lane;
        dE[vec] = g;
        dF[vec] = hc;
      }
      __syncthreads();
    }
  }

  if (j == 0) dh0[i * NL + lane] = hc;
  dJ0[ij * NL + lane] = Mc;
}

template <int D>
int launch_factor(int NL, int T1, const float* J0, const float* h0,
                  const float* A, const float* Dm, const float* F,
                  const float* J, const float* h, float* fac,
                  cudaStream_t stream) {
  const int n = T1 * NL;
  bidir_adj_factor_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          NL, T1, J0, h0, A, Dm, F, J, h, fac);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chain(int NL, int T1, const float* fac, const float* dJ,
                 const float* dh, const float* dln, float* dA, float* dC,
                 float* dD, float* dE, float* dF, float* dJ0, float* dh0,
                 cudaStream_t stream) {
  bidir_adj_chain_kernel<D><<<NL, D * D, 0, stream>>>(
      NL, T1, fac, dJ, dh, dln, dA, dC, dD, dE, dF, dJ0, dh0);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bidir_adj(int NL, int T1, const float* J0, const float* h0,
                     const float* A, const float* Dm, const float* F,
                     const float* J, const float* h, const float* dJ,
                     const float* dh, const float* dln, float* fac,
                     float* dA, float* dC, float* dD, float* dE, float* dF,
                     float* dJ0, float* dh0, cudaStream_t stream) {
  const int err = launch_factor<D>(NL, T1, J0, h0, A, Dm, F, J, h, fac,
                                   stream);
  if (err != 0) return err;
  return launch_chain<D>(NL, T1, fac, dJ, dh, dln, dA, dC, dD, dE, dF, dJ0,
                         dh0, stream);
}

}  // namespace

#define SVAE_DIMS(CASE) CASE(2) CASE(3) CASE(4) CASE(8) CASE(10) CASE(16)

// Plain C entries for ctypes; each returns cudaGetLastError() after its
// launches (0 on success), cudaErrorInvalidValue for an unsupported d.
// svae_bidir_adj_f32 runs both passes (fac is its scratch, (T1, 2d^2 + d,
// NL)); the other two run one pass each.
extern "C" int svae_bidir_adj_f32(int d, int NL, int T1, const float* J0,
                                  const float* h0, const float* A,
                                  const float* Dm, const float* F,
                                  const float* J, const float* h,
                                  const float* dJ, const float* dh,
                                  const float* dln, float* fac, float* dA,
                                  float* dC, float* dD, float* dE,
                                  float* dF, float* dJ0, float* dh0,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                       \
  case DIM:                                                                  \
    return launch_bidir_adj<DIM>(NL, T1, J0, h0, A, Dm, F, J, h, dJ, dh, dln, \
                                 fac, dA, dC, dD, dE, dF, dJ0, dh0, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_bidir_adj_factor_f32(int d, int NL, int T1,
                                         const float* J0, const float* h0,
                                         const float* A, const float* Dm,
                                         const float* F, const float* J,
                                         const float* h, float* fac,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_factor<DIM>(NL, T1, J0, h0, A, Dm, F, J, h, fac, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_bidir_adj_chain_f32(int d, int NL, int T1,
                                        const float* fac, const float* dJ,
                                        const float* dh, const float* dln,
                                        float* dA, float* dC, float* dD,
                                        float* dE, float* dF, float* dJ0,
                                        float* dh0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                       \
  case DIM:                                                                  \
    return launch_chain<DIM>(NL, T1, fac, dJ, dh, dln, dA, dC, dD, dE, dF,   \
                             dJ0, dh0, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
#undef SVAE_DIMS
