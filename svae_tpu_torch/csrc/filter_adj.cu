// Hopper kernel of the adjoint of the packed stationary LDS filter
// (estep.cu's filter_fwd_kernel).
//
// filter_adj_kernel<D> replaces
// svae_tpu/ops/pallas_estep.py:_filter_adj_kernel.
//
// What bounds it on an H100. Like the forward, each (sequence, direction)
// is a serial chain: step t's cotangent needs step t+1's. At the main-path
// shape (B=64, T=100, d=10) there are 2B = 128 chains of T-1 steps of some
// 6 d^3 flops each, far too few threads to fill the card, so the kernel is
// bound by the latency of one chain's arithmetic, not by bytes (each step
// reads the pre-step message and the output cotangent, d*d + d floats
// each, and writes 2d) nor by peak FLOP/s.
//
// What the design does about it. One thread walks one chain through all
// T-1 steps, descending, in one launch, with the carried cotangents
// (M-bar, h-bar) in its registers. It recomputes the step's Cholesky
// factor from the pre-step message, which it reads straight from the
// forward kernel's output (J0/h0 at t = 0, the output of step t-1
// otherwise), so no shifted copy of the messages is made. The algebra is
// that of the Pallas kernel, rewritten around the factor L of M:
// with Y = L^-1 D^T, z = L^-1 v, a = Y g and Gs = G + G^T,
//   Mbar = L^-T Z L^-1,
//   Z = 1/2 Y Gs Y^T - 1/2 (a z^T + z a^T) - 1/2 lam (z z^T + I),
//   hbar = L^-T (lam z + a),
//   dD += -(Gs Y^T - g z^T) L^-1,
// which is the Pallas kernel's -W Wbar W - lam/2 W (symmetrized),
// W (lam v + D^T g) and -Gs D W + g w^T with W = M^-1 never formed.
// The stationary A and D of the direction sit in shared memory. Node
// cotangents are written per direction in frame order, (2, 2, T, d, B)
// (kind, direction), each entry by one thread once, and the wrapper adds
// the two directions: no atomics, so the sum is deterministic. The
// per-lane dA, dC, dD sums are written as (3, d*d, 2B), and the wrapper
// sums the lanes. At d=10 the live state (L, Y, Gs Y^T, Z, the carried
// M-bar and three d x d accumulators) is far beyond 255 registers and
// spills to local memory; a warp per chain is the known next step.

#include "estep_common.cuh"

namespace {

// One thread per (sequence b, direction r), lane r*B + b, walking
// t = T-2 ... 0. Inputs: the forward's J0 (d*d, 2B), h0 (d, 2B), A, D
// (2, d, d), jd, n2 (T, d, B), its outputs J (T-1, d*d, 2B), h (T-1, d, 2B),
// and their cotangents dJ, dh (same shapes) and dln (2B). Outputs: dnode
// (2, 2, T, d, B) = [djd, dn2] x [forward, backward] in frame order (frame
// 0 is zero: it reaches the filter only through J0/h0), dJ0 (d*d, 2B),
// dh0 (d, 2B) and dpar (3, d*d, 2B) = per-lane [dA, dC, dD].
template <int D>
__global__ void __launch_bounds__(kThreads)
filter_adj_kernel(int B, int T, const float* __restrict__ J0,
                  const float* __restrict__ h0, const float* __restrict__ A,
                  const float* __restrict__ Dm, const float* __restrict__ jd,
                  const float* __restrict__ n2, const float* __restrict__ Jf,
                  const float* __restrict__ hf, const float* __restrict__ dJ,
                  const float* __restrict__ dh,
                  const float* __restrict__ dln, float* __restrict__ dnode,
                  float* __restrict__ dJ0, float* __restrict__ dh0,
                  float* __restrict__ dpar) {
  constexpr int DD = D * D;
  const int r = blockIdx.y;
  __shared__ float sA[DD], sD[DD];
  for (int k = threadIdx.x; k < DD; k += blockDim.x) {
    sA[k] = A[r * DD + k];
    sD[k] = Dm[r * DD + k];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int NL = 2 * B;
  const int lane = r * B + b;
  const size_t plane = (size_t)T * D * B;
  float* djd_out = dnode + r * plane;
  float* dn2_out = dnode + (2 + r) * plane;
  const float lam = dln[lane];

  float Mc[D][D];  // carried M-bar (lower triangle)
  float hc[D];
  float accA[D][D], accC[D][D], accD[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    hc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      Mc[i][j] = 0.f;
      accA[i][j] = accC[i][j] = accD[i][j] = 0.f;
    }
  }

  for (int t = T - 2; t >= 0; --t) {
    const int frame = r == 0 ? t + 1 : T - 1 - t;
    float jv[D], nv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      jv[i] = jd[(frame * D + i) * B + b];
      nv[i] = n2[(frame * D + i) * B + b];
    }
    // the forward step again: M = J_pre + A (+ diag jd backward)
    const float* Jp = t == 0 ? J0 : Jf + (size_t)(t - 1) * DD * NL;
    const float* hp = t == 0 ? h0 : hf + (size_t)(t - 1) * D * NL;
    float L[D][D], rd[D], vin[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = Jp[(i * D + j) * NL + lane] + sA[i * D + j];
      if (r == 1) L[i][i] += jv[i];
      vin[i] = hp[i * NL + lane] + (r == 1 ? nv[i] : 0.f);
    }
    chol_inplace<D>(L, rd);
    float z[D];
    solve_lower<D>(L, rd, vin, z);
    float Y[D][D];  // L^-1 D^T
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = sD[j * D + i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][j];
        Y[i][j] = s * rd[i];
      }
    }

    // cotangents of the step's outputs: G = Mc + dJ_t, g = hc + dh_t
    const float* dJt = dJ + (size_t)t * DD * NL;
    const float* dht = dh + (size_t)t * D * NL;
    float G[D][D], g[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        G[i][j] = (j <= i ? Mc[i][j] : Mc[j][i]) +
                  dJt[(i * D + j) * NL + lane];
      g[i] = hc[i] + dht[i * NL + lane];
    }
    // Q = Gs Y^T, a = Y g
    float Q[D][D], a[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) s += (G[i][j] + G[j][i]) * Y[k][j];
        Q[i][k] = s;
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += Y[i][j] * g[j];
      a[i] = s;
    }
    // Z (symmetric, lower triangle)
    float Z[D][D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int l = 0; l <= k; ++l) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) s += Y[k][i] * Q[i][l];
        s = 0.5f * s - 0.5f * (a[k] * z[l] + z[k] * a[l]) -
            0.5f * lam * z[k] * z[l];
        if (k == l) s -= 0.5f * lam;
        Z[k][l] = s;
      }
    }
    // R = L^-T Z (full), then M-bar = L^-T R^T, lower triangle only:
    // column j of M-bar is L^-T R[j][:]^T, whose entries i >= j need only
    // entries k > i of the same column.
    float R[D][D];
#pragma unroll
    for (int l = 0; l < D; ++l) {
#pragma unroll
      for (int i = D - 1; i >= 0; --i) {
        float s = i >= l ? Z[i][l] : Z[l][i];
#pragma unroll
        for (int k = i + 1; k < D; ++k) s -= L[k][i] * R[k][l];
        R[i][l] = s * rd[i];
      }
    }
    float Mb[D][D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int i = D - 1; i >= j; --i) {
        float s = R[j][i];
#pragma unroll
        for (int k = i + 1; k < D; ++k) s -= L[k][i] * Mb[k][j];
        Mb[i][j] = s * rd[i];
      }
    }
    float hb_in[D], hb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) hb_in[i] = lam * z[i] + a[i];
    solve_upper<D>(L, rd, hb_in, hb);

    // node cotangents: evidence enters C forward and A backward
#pragma unroll
    for (int i = 0; i < D; ++i) {
      djd_out[(frame * D + i) * B + b] = r == 0 ? G[i][i] : Mb[i][i];
      dn2_out[(frame * D + i) * B + b] = r == 0 ? g[i] : hb[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        accA[i][j] += j <= i ? Mb[i][j] : Mb[j][i];
        accC[i][j] += G[i][j];
      }
      // row i of dD: -(Q[i][:] - g_i z^T) L^-1 = -(L^-T (Q[i][:] - g_i z))^T
      float p[D], x[D];
#pragma unroll
      for (int k = 0; k < D; ++k) p[k] = Q[i][k] - g[i] * z[k];
      solve_upper<D>(L, rd, p, x);
#pragma unroll
      for (int k = 0; k < D; ++k) accD[i][k] -= x[k];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      hc[i] = hb[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) Mc[i][j] = Mb[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    djd_out[i * B + b] = 0.f;
    dn2_out[i * B + b] = 0.f;
    dh0[i * NL + lane] = hc[i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      dJ0[(i * D + j) * NL + lane] = j <= i ? Mc[i][j] : Mc[j][i];
      dpar[(i * D + j) * NL + lane] = accA[i][j];
      dpar[(DD + i * D + j) * NL + lane] = accC[i][j];
      dpar[(2 * DD + i * D + j) * NL + lane] = accD[i][j];
    }
  }
}

template <int D>
int launch_filter_adj(int B, int T, const float* J0, const float* h0,
                      const float* A, const float* Dm, const float* jd,
                      const float* n2, const float* J, const float* h,
                      const float* dJ, const float* dh, const float* dln,
                      float* dnode, float* dJ0, float* dh0, float* dpar,
                      cudaStream_t stream) {
  dim3 grid((B + kThreads - 1) / kThreads, 2);
  filter_adj_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, T, J0, h0, A, Dm, jd, n2, J, h, dJ, dh, dln, dnode, dJ0, dh0, dpar);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes; returns cudaGetLastError() after the launch
// (0 on success), cudaErrorInvalidValue for an unsupported d.
extern "C" int svae_filter_adj_f32(int d, int B, int T, const float* J0,
                                   const float* h0, const float* A,
                                   const float* Dm,
                                   const float* jd, const float* n2,
                                   const float* J, const float* h,
                                   const float* dJ, const float* dh,
                                   const float* dln, float* dnode,
                                   float* dJ0, float* dh0, float* dpar,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_FILTER_ADJ(DIM)                                                \
  case DIM:                                                                 \
    return launch_filter_adj<DIM>(B, T, J0, h0, A, Dm, jd, n2, J, h, dJ, dh, \
                                  dln, dnode, dJ0, dh0, dpar, s);
  switch (d) {
    SVAE_FILTER_ADJ(2)
    SVAE_FILTER_ADJ(3)
    SVAE_FILTER_ADJ(4)
    SVAE_FILTER_ADJ(8)
    SVAE_FILTER_ADJ(10)
    SVAE_FILTER_ADJ(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_FILTER_ADJ
}
