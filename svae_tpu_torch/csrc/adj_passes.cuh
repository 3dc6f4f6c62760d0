// Pieces shared by the kernels that run as passes (filter_adj.cu,
// bidir_adj.cu, sampler_adj.cu, sampler_bp_adj.cu, elem_scan_adj.cu, and
// the sampler's in estep.cu): the in-place inverse of a Cholesky factor,
// which their parallel factor passes run on one thread's registers; the
// sampler's step precision Jc = Jf_t - 2 P3, its factor and its inverse W,
// which the forward sampler's factor pass and the adjoints' compute alike,
// on stationary or per-sequence pairs; the
// information filter adjoint's factor row [W | K | w] and its chain step,
// which the stationary (filter_adj.cu) and the per-sequence-pairs
// (bidir_adj.cu) adjoints share; and the geometry of the passes.
// estep_common.cuh, which every other kernel includes, is left as it was.
#pragma once

#include "estep_common.cuh"

namespace {

// Threads per block of the passes that run one thread per (step, lane).
constexpr int kPassThreads = 128;

// The lanes of a block of D threads (one chain of the serial passes).
template <int D>
__device__ __forceinline__ unsigned chain_mask() {
  static_assert(D >= 1 && D <= 32, "a chain's rows must fit one warp");
  return D == 32 ? 0xffffffffu : (1u << D) - 1u;
}

// Overwrite the lower triangular L (rd: its reciprocal diagonal) with
// L^-1, column by column from the right: with the columns to the right
// already inverted, Linv[i][j] = -rd[j] sum_{j<k<=i} Linv[i][k] L[k][j],
// rows descending so that column j's own entries L[k][j], k < i, are still
// read as L.
template <int D>
__device__ __forceinline__ void invert_lower(float (&L)[D][D],
                                             const float (&rd)[D]) {
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
#pragma unroll
    for (int i = D - 1; i > j; --i) {
      float s = 0.f;
#pragma unroll
      for (int k = j + 1; k <= i; ++k) s += L[i][k] * L[k][j];
      L[i][j] = -s * rd[j];
    }
    L[j][j] = rd[j];
  }
}

// Given the lower Cholesky factor L of M (chol_inplace: rd holds the
// reciprocal diagonal), overwrite the lower triangle of L with that of
// W = M^-1 = L^-T L^-1: L^-1 in place, then W = Linv^T Linv row by row
// ascending, W[i][j] = sum_{k>=i} Linv[k][i] Linv[k][j] reading rows
// k >= i only, row i's diagonal (which its other entries read) last.
template <int D>
__device__ __forceinline__ void inverse_from_chol(float (&L)[D][D],
                                                  const float (&rd)[D]) {
  invert_lower<D>(L, rd);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = i; k < D; ++k) s += L[k][i] * L[k][j];
      L[i][j] = s;
    }
    float s = 0.f;
#pragma unroll
    for (int k = i; k < D; ++k) s += L[k][i] * L[k][i];
    L[i][i] = s;
  }
}

// The lower Cholesky factor L (rd: its reciprocal diagonal) of one
// sequence's Jc = Jf_t - 2 P3: Jt points at Jf_t's entry of the sequence
// ((d*d, B) from there, lane-minor; its lower triangle read), s2P3[k]
// gives 2 P3's entry k = i*d + j (a shared row of the stationary P3, or
// TwiceStream's row of a per-sequence one).
template <int D, class TwoP3>
__device__ __forceinline__ void factor_jc(const float* __restrict__ Jt,
                                          const TwoP3& s2P3, int B,
                                          float (&L)[D][D], float (&rd)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j)
      L[i][j] = Jt[(i * D + j) * B] - s2P3[i * D + j];
  }
  chol_inplace<D>(L, rd);
}

// 2 P3_t's entries of one sequence on a per-sequence (T-1, d*d, B) stream,
// p at the step and sequence's entry.
struct TwiceStream {
  const float* p;
  int B;
  __device__ __forceinline__ float operator[](int k) const {
    return 2.f * p[(size_t)k * B];
  }
};

// factor_jc on per-sequence pairs: Jc_t = Jf_t - 2 P3_t of sequence b, at
// = t*d*d*B + b its entry of both (T-1, d*d, B) streams. The factor passes
// of the per-sequence samplers (sampler_bp_adj.cu) run it, once for the S
// samples of a sequence, and store_inverse writes their W.
template <int D>
__device__ __forceinline__ void factor_jc_bp(const float* __restrict__ Jf,
                                             const float* __restrict__ P3,
                                             size_t at, int B,
                                             float (&L)[D][D],
                                             float (&rd)[D]) {
  factor_jc<D>(Jf + at, TwiceStream{P3 + at, B}, B, L, rd);
}

// Overwrite the factor L of factor_jc with the lower triangle of W = Jc^-1
// and write W, full, at out (the sequence's entry of (d*d, B), lane-minor).
template <int D>
__device__ __forceinline__ void store_inverse(float (&L)[D][D],
                                              const float (&rd)[D],
                                              float* __restrict__ out,
                                              int B) {
  inverse_from_chol<D>(L, rd);
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      out[(i * D + j) * B] = j <= i ? L[i][j] : L[j][i];
  }
}

// The information filter adjoint's factor row of one (step, lane) at out
// ([W | K | w], 2 d^2 + d floats NL apart): from the lower triangle of
// W = M^-1 in L (inverse_from_chol's), the step's vector v (w = W v) and
// its coupling block, Dat(j, k) = D[j][k] (K = W D^T).
template <int D, class DAt>
__device__ __forceinline__ void store_filter_factor(const float (&L)[D][D],
                                                    const float (&v)[D],
                                                    DAt Dat,
                                                    float* __restrict__ out,
                                                    int NL) {
  constexpr int DD = D * D;
  auto W = [&](int i, int j) { return j <= i ? L[i][j] : L[j][i]; };
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      out[(i * D + j) * NL] = W(i, j);
      s += W(i, j) * v[j];
    }
    out[(2 * DD + i) * NL] = s;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) s += W(i, k) * Dat(j, k);
      out[(DD + i * D + j) * NL] = s;
    }
  }
}

// The shared memory of the information filter adjoint's chain pass (one
// chain per block of d*d threads, thread (i, j) owning entry (i, j)): K,
// G, Gs = G + G^T and P = K Gs with rows padded to d+1 floats, so that a
// thread's row or column read is free of bank conflicts and the rest are
// broadcasts; g and a = K g.
template <int D>
struct FilterChainShared {
  static constexpr int SP = D + 1;
  float K[D * SP], G[D * SP], Gs[D * SP], P[D * SP], g[D], a[D];
};

// A chain step's first stage, thread (i, j): K_ij, G_ij and g_i into
// shared memory. The caller then issues its loads and a block barrier.
template <int D>
__device__ __forceinline__ void filter_chain_stage(FilterChainShared<D>& s,
                                                   int i, int j, float K,
                                                   float G, float g) {
  constexpr int SP = FilterChainShared<D>::SP;
  s.K[i * SP + j] = K;
  s.G[i * SP + j] = G;
  if (j == 0) s.g[i] = g;
}

// The rest of the step after the caller's barrier, products only, with
// two block barriers: Gs = G + G^T, P = K Gs, a = K g, then entry (i, j)
// of M-bar = 1/2 P K^T - 1/2 (a w^T + w a^T) - 1/2 lam (w w^T + W) into
// Mc and h-bar_i = lam w_i + a_i into hc. s.P stays readable until the
// caller's closing barrier (the cotangent of D is g w^T - P^T).
template <int D>
__device__ __forceinline__ void filter_chain_products(
    FilterChainShared<D>& s, int i, int j, float G, float Wij, float wi,
    float wj, float lam, float& Mc, float& hc) {
  constexpr int SP = FilterChainShared<D>::SP;
  s.Gs[i * SP + j] = G + s.G[j * SP + i];
  __syncthreads();

  // P = K Gs; a = K g (one thread a row)
  float P = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) P += s.K[i * SP + k] * s.Gs[k * SP + j];
  s.P[i * SP + j] = P;
  if (j == 0) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) a += s.K[i * SP + k] * s.g[k];
    s.a[i] = a;
  }
  __syncthreads();

  float m = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) m += s.P[i * SP + k] * s.K[j * SP + k];
  const float ai = s.a[i];
  Mc = 0.5f * m - 0.5f * (ai * wj + wi * s.a[j]) -
       0.5f * lam * (wi * wj + Wij);
  hc = lam * wi + ai;
}

}  // namespace
