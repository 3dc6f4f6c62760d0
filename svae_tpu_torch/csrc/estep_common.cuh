// Shared pieces of the port's kernels (estep.cu, filter_adj.cu,
// sampler_adj.cu, elem_scan.cu, elem_scan_adj.cu and the rest): the block
// width and the unrolled small-matrix Cholesky factor and triangular solves
// every kernel runs on one thread's registers.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr float kLog2Pi = 1.8378770664093453f;

// How far the element-scan kernels' loops over rows unroll: fully up to
// d=10, not at all beyond (which bounds their build time at d=16).
template <int D>
struct Rows {
  static constexpr int value = D <= 10 ? D : 1;
};

// In-place lower Cholesky factor of the lower triangle of L (row by row);
// rd gets the reciprocal diagonal. Returns sum_i log L_ii (half logdet).
// A non-positive pivot gives NaN, which then propagates to every output.
template <int D>
__device__ __forceinline__ float chol_inplace(float (&L)[D][D],
                                              float (&rd)[D]) {
  float half_logdet = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrtf(s);
        rd[i] = 1.f / L[i][i];
        half_logdet += logf(L[i][i]);
      } else {
        L[i][j] = s * rd[j];
      }
    }
  }
  return half_logdet;
}

// x = L^-1 b (forward substitution against the lower factor).
template <int D>
__device__ __forceinline__ void solve_lower(const float (&L)[D][D],
                                            const float (&rd)[D],
                                            const float (&b)[D],
                                            float (&x)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * x[k];
    x[i] = s * rd[i];
  }
}

// x = L^-T b (backward substitution against the lower factor).
template <int D>
__device__ __forceinline__ void solve_upper(const float (&L)[D][D],
                                            const float (&rd)[D],
                                            const float (&b)[D],
                                            float (&x)[D]) {
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s -= L[k][i] * x[k];
    x[i] = s * rd[i];
  }
}

}  // namespace
