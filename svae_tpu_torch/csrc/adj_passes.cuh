// Pieces shared by the two redesigned adjoint kernels (filter_adj.cu,
// sampler_adj.cu): the in-place inverse of a Cholesky factor, which their
// parallel factor passes run on one thread's registers, and the geometry
// of their passes. estep_common.cuh, which every other kernel includes, is
// left as it was.
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

}  // namespace
