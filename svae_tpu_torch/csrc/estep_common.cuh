// Shared pieces of the port's kernels (estep.cu, filter_adj.cu,
// sampler_adj.cu, elem_scan.cu, elem_scan_adj.cu and the rest): the block
// width, the unrolled small-matrix Cholesky factor and triangular solves
// every kernel runs on one thread's registers, the pieces of the
// warp-per-chain filters' Gauss-Jordan step (estep.cu, bpairs.cu), and
// the lane segment and the shared-memory prefetch ring of the HMM chains
// (hmm_fb.cu, hmm_fb_adj.cu).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// The latent sizes a d-templated source instantiates and the names of its
// C entries: d <= 16 in the source itself; d = 24 and 32 in its twin
// X_wide.cu, which defines SVAE_WIDE and includes X.cu, so that the two
// compile in parallel, and whose entries carry the suffix _wide
// (ops/_build.py calls the twin for d = 24 and 32).
#ifdef SVAE_WIDE
#define SVAE_BUILT_DIMS(CASE) CASE(24) CASE(32)
#define SVAE_ENTRY(name) name##_wide
#else
#define SVAE_BUILT_DIMS(CASE) CASE(2) CASE(3) CASE(4) CASE(8) CASE(10) CASE(16)
#define SVAE_ENTRY(name) name
#endif

// The loops over d of the passes that run one thread a (step, lane): the
// factor and dJc passes and their Cholesky, solve and inverse helpers.
// Unrolled in full up to d = 16; at d = 24 and 32 not unrolled, their
// d x d matrices in local memory, where they spill in any case: unrolled
// at d = 32, ptxas took 200-390 s a source.
#ifdef SVAE_WIDE
#define SVAE_PASS_UNROLL _Pragma("unroll 1")
#else
#define SVAE_PASS_UNROLL _Pragma("unroll")
#endif

namespace {

constexpr int kThreads = 32;
constexpr float kLog2Pi = 1.8378770664093453f;

// The lanes of a warp that one chain of k states takes, one state a lane:
// the least power of two >= k, the `width` of the chain's shuffles.
__host__ __device__ constexpr int segment_lanes(int k) {
  int w = 1;
  while (w < k) w *= 2;
  return w;
}

// A 4-byte asynchronous copy from global to shared memory (cp.async), the
// commit of the copies issued so far as a group, and the wait until at most
// n groups are pending: a prefetch ring in shared memory whose wait counts
// groups, so a chain step waits only on the copies it reads (the HMM chain
// kernels). Compiled for the host (nvcc's host pass, a host build of the
// source), the copy is a plain load and store and the rest do nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// How far the element-scan kernels' loops over rows unroll: fully up to
// d=10, not at all beyond (which bounds their build time at d=16).
template <int D>
struct Rows {
  static constexpr int value = D <= 10 ? D : 1;
};

// The scalar of the sampler factor passes' factors and solves at d: float,
// and double past d = 16: at d = 32 the float32 sums of 32 terms a pivot
// took the sampler past twice the float32 plain version's error in the
// stiff case (chip_smoke.check_stiff). The passes store float either way.
template <int D>
using PassReal = typename std::conditional<(D > 16), double, float>::type;

__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// In-place lower Cholesky factor of the lower triangle of L (row by row);
// rd gets the reciprocal diagonal. Returns sum_i log L_ii (half logdet).
// A non-positive pivot gives NaN, which then propagates to every output.
// T is float, or double for PassReal<32>.
template <int D, class T>
__device__ __forceinline__ T chol_inplace(T (&L)[D][D], T (&rd)[D]) {
  T half_logdet = T(0);
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
SVAE_PASS_UNROLL
    for (int j = 0; j <= i; ++j) {
      T s = L[i][j];
SVAE_PASS_UNROLL
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrt_of(s);
        rd[i] = T(1) / L[i][i];
        half_logdet += log_of(L[i][i]);
      } else {
        L[i][j] = s * rd[j];
      }
    }
  }
  return half_logdet;
}

// x = L^-1 b (forward substitution against the lower factor).
template <int D, class T>
__device__ __forceinline__ void solve_lower(const T (&L)[D][D],
                                            const T (&rd)[D],
                                            const T (&b)[D], T (&x)[D]) {
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
    T s = b[i];
SVAE_PASS_UNROLL
    for (int k = 0; k < i; ++k) s -= L[i][k] * x[k];
    x[i] = s * rd[i];
  }
}

// x = L^-T b (backward substitution against the lower factor).
template <int D, class T>
__device__ __forceinline__ void solve_upper(const T (&L)[D][D],
                                            const T (&rd)[D],
                                            const T (&b)[D], T (&x)[D]) {
SVAE_PASS_UNROLL
  for (int i = D - 1; i >= 0; --i) {
    T s = b[i];
SVAE_PASS_UNROLL
    for (int k = i + 1; k < D; ++k) s -= L[k][i] * x[k];
    x[i] = s * rd[i];
  }
}

// The reciprocal of a pivot that is not positive.
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// w . x for a row w of d floats in shared memory (16-byte aligned, padded
// with zeros to DP), read four at a time.
template <int D, int DP>
__device__ __forceinline__ float row_dot(const float* w, const float (&x)[D]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int k = 0; k < DP; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + k);
    s0 += v.x * x[k];
    if (k + 1 < D) s1 += v.y * x[k + 1];
    if (k + 2 < D) s0 += v.z * x[k + 2];
    if (k + 3 < D) s1 += v.w * x[k + 3];
  }
  return s0 + s1;
}

// sum_k log p_k over a step's pivots, lane k holding p_k (1 on the other
// lanes): one logf a lane and a butterfly sum over the warp, off the
// chain, where a logf a pivot on every lane would cost d of them a step.
__device__ __forceinline__ float warp_log_sum(float p) {
  float s = logf(p);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

}  // namespace
