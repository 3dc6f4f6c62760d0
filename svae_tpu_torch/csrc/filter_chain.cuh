// The warp-per-chain information filter step, shared by bpairs.cu's
// bidir_fwd_kernel (every block a per-lane stream) and kalman_fwd.cu's
// shared-pair filters (the pair blocks one row a step for the batch, only
// the node evidence per lane). Each kernel brings its own reader, which
// puts a step's operands on the lanes; the step itself is written once.
//
// One warp runs one chain: lane j < d holds column j of M = J + A_t and
// row j of D_t (column j of D_t^T), lane d the vector v = h + f_t, and a
// step is a Gauss-Jordan elimination of the tile [M | D_t^T | v] over d
// rounds of pivot-column shuffles, which leaves X = M^-1 [D_t^T | v] on the
// lanes. Then column j of J' = C_t - D_t X_D goes on lane j, which already
// holds the column that the next step's M reads, h' = D_t X_v + e_t on lane
// d, and ln gains d/2 log 2pi - 1/2 sum log p_k + 1/2 v . X_v + pc_t, the
// log sum over the warp off the chain, summed in double on the vector
// lane. A non-positive pivot gives a NaN reciprocal, which poisons the
// step's J, h and the chain's ln. J' is written as C_t - D_t X_D with C
// read in full, and the carry takes C's lower triangle, as the plain
// version (ops/bpairs.py bidir_fwd_plain) does.
//
// At d = 32 the tile's d + 1 columns outnumber the lanes (kWideChain): the
// vector column, v = h + f_t, and the carried h are held whole on every
// lane, which reduce them in the same rounds (warp-uniform values), the
// reader gives every lane f_t and e_t, and lane 0 writes h'.
#pragma once

#include "estep_common.cuh"

namespace {

// A chain whose vector column has no lane of its own (d = 32).
template <int D>
constexpr bool kWideChain = D == 32;

// One step's operands on one lane.
template <int D>
struct FilterOperands {
  // d = 32: f_t and e_t, whole, on every lane
  float f[kWideChain<D> ? D : 1], e[kWideChain<D> ? D : 1];
  float A[D];   // lane j < d: column j of A_t (from its lower triangle)
  float Dr[D];  // lane j < d: row j of D_t; the vector lane: f_t
  float Cc[D];  // lane j < d: column j of C_t in full
  // lane j < d: row j of C_t, whose entries left of the diagonal hold the
  // lower triangle of column j above it; the vector lane: e_t
  float Cr[D];
  float pc;     // pc_t (read on the vector lane)
};

// The T1 steps of the chain on lane j of its warp (j in [0, 32)), from the
// carry cj (lane j < d: column j of J, its lower triangle read; lane d: h).
// The reader:
//   step(t, op) puts step t's operands in op and returns D_t as a tile of d
//     rows DP floats apart (16-byte aligned, padded), which every lane of
//     the warp may read once it returns; it also issues the coming steps'
//     loads;
//   out(t) is where the lane writes step t's output, entry i at
//     out(t)[i * ostep]: lane j < d column j of J'_t, lane d h'_t.
// Lanes write only where ``stores``. Returns the chain's summed ln on the
// vector lane when kLn (else 0, and no log is taken). At d = 32, hc is the
// carried h (h0 on entry) on every lane, hout(t, i) where lane 0 writes
// entry i of h'_t, and the ln is returned on every lane; below, hc and
// hout are not read.
template <int D, int DP, bool kLn, class Step, class Out, class HOut>
__device__ __forceinline__ double filter_chain(
    int T1, int j, float (&cj)[D], float (&hc)[kWideChain<D> ? D : 1],
    Step&& step, Out&& out, HOut&& hout, size_t ostep, bool stores) {
  static_assert(D <= 32, "a chain's columns must fit one warp");
  constexpr bool kWide = kWideChain<D>;
  constexpr unsigned kAll = 0xffffffffu;
  const bool vec = j == D;           // the lane of the vector column
  const int jc = j < D ? j : D - 1;  // the column a lane holds (clamped)
  double acc = 0.0;

#pragma unroll 1
  for (int t = 0; t < T1; ++t) {
    FilterOperands<D> op;
    const float* sDt = step(t, op);

    float m[D], x[D], v[D];
    float xv[kWide ? D : 1];  // d = 32: the vector column
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = cj[i] + op.A[i];
      v[i] = cj[i] + op.Dr[i];  // the vector lane's h + f
      x[i] = vec ? v[i] : op.Dr[i];
      if constexpr (kWide) {
        v[i] = hc[i] + op.f[i];
        xv[i] = v[i];
      }
    }
    float pj = 1.f;  // this lane's pivot
#pragma unroll
    for (int k = 0; k < D; ++k) {
      // the pivot column, from lane k
      float col[D];
#pragma unroll
      for (int i = 0; i < D; ++i) col[i] = __shfl_sync(kAll, m[i], k);
      const float p = col[k];
      if (j == k) pj = p;
      const float rp = p > 0.f ? __fdividef(1.f, p) : nan_f();
      const float mk = m[k] * rp, xk = x[k] * rp;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if (i == k) continue;
        m[i] -= col[i] * mk;
        x[i] -= col[i] * xk;
      }
      m[k] = mk;
      x[k] = xk;
      if constexpr (kWide) {
        const float vk = xv[k] * rp;
#pragma unroll
        for (int i = 0; i < D; ++i)
          if (i != k) xv[i] -= col[i] * vk;
        xv[k] = vk;
      }
    }

    // y = D_t X, column j of it on lane j
    float y[D], q = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y[i] = row_dot<D, DP>(sDt + i * DP, x);
      if constexpr (kWide)
        q += v[i] * xv[i];
      else
        q += v[i] * x[i];
    }
    if (kLn)
      acc += 0.5f * D * kLog2Pi - 0.5f * warp_log_sum(pj) + 0.5f * q + op.pc;

    // lane j < d writes column j of J' in full and carries its lower
    // triangle; the vector lane writes and carries h'
    float* o_t = out(t);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float o = vec ? y[i] + op.Cr[i] : op.Cc[i] - y[i];
      cj[i] = vec || i >= jc ? o : op.Cr[i] - y[i];
      if (stores) o_t[i * ostep] = o;
    }
    if constexpr (kWide) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        hc[i] = row_dot<D, DP>(sDt + i * DP, xv) + op.e[i];
        if (stores && j == 0) *hout(t, i) = hc[i];
      }
    }
  }
  return acc;
}

}  // namespace
