// Hopper kernel of the unified adjoint of the generic bidirectional
// information filter on per-sequence pairs (bpairs.cu's bidir_fwd_kernel).
//
// bidir_adj_kernel<D> replaces svae_tpu/ops/pallas_bidir.py:_bidir_adj_kernel.
//
// What bounds it on an H100. Each lane's cotangent is a serial chain
// descending in the stream coordinate: the forward filter's adjoint runs
// t descending, the backward filter's t ascending, and both are the same
// descending walk over their (pre-reversed) streams. At the ragged slice's
// shape (2B = 128 lanes, T up to 512, d=10) the chains are far too few to
// fill the card, so the latency of one chain's arithmetic (some 6 d^3
// flops a step) bounds the kernel, not bytes (a step reads 3.1 d^2 + 3d
// floats and writes 3 d^2 + 2d) nor peak FLOP/s.
//
// What the design does about it. One thread walks one lane through all
// T-1 steps in one launch, with the carried cotangents (M-bar, h-bar) in
// registers. It recomputes the step's Cholesky factor from the pre-step
// message, read straight from the forward's input J0/h0 (t = 0) or its
// output at t-1, so no shifted copies of the messages (the Pallas
// primitive's Mst/vst residuals) are made. The algebra is filter_adj.cu's,
// around the factor L of M = J_pre + A_t: with v = h_pre + f_t,
// Y = L^-1 D_t^T, z = L^-1 v, a = Y g, Gs = G + G^T,
//   dA_t = M-bar = L^-T Z L^-1,
//   Z = 1/2 Y Gs Y^T - 1/2 (a z^T + z a^T) - 1/2 lam (z z^T + I),
//   df_t = h-bar = L^-T (lam z + a),
//   dD_t = -(Gs Y^T - g z^T) L^-1,   dC_t = G,   de_t = g,
// where G = M-bar carried + dJ_t, g = h-bar carried + dh_t and lam is the
// lane's log-normalizer cotangent (zero on the backward lanes of the
// E-step, whose ln is not used). Every output is per step and lane, each
// written once by its own thread: no atomics, no sums. At d=10 the live
// state (L, Y, Gs Y^T, Z, R and the carry) exceeds 255 registers and
// spills to local memory; a warp per chain is the known next step.

#include "estep_common.cuh"

namespace {

// One thread per lane, walking t = T1-1 ... 0. Inputs: the forward's J0
// (d*d, NL), h0 (d, NL), A, D (T1, d*d, NL), F (T1, d, NL), its outputs
// J (T1, d*d, NL), h (T1, d, NL), their cotangents dJ, dh (same shapes) and
// dln (NL). Outputs: dA, dC, dD (T1, d*d, NL), dE, dF (T1, d, NL), dJ0
// (d*d, NL), dh0 (d, NL).
template <int D>
__global__ void __launch_bounds__(kThreads)
bidir_adj_kernel(int NL, int T1, const float* __restrict__ J0,
                 const float* __restrict__ h0, const float* __restrict__ A,
                 const float* __restrict__ Dm, const float* __restrict__ F,
                 const float* __restrict__ Jf, const float* __restrict__ hf,
                 const float* __restrict__ dJ, const float* __restrict__ dh,
                 const float* __restrict__ dln, float* __restrict__ dA,
                 float* __restrict__ dC, float* __restrict__ dD,
                 float* __restrict__ dE, float* __restrict__ dF,
                 float* __restrict__ dJ0, float* __restrict__ dh0) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= NL) return;
  const float lam = dln[lane];

  float Mc[D][D];  // carried M-bar (lower triangle)
  float hc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    hc[i] = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) Mc[i][j] = 0.f;
  }

  for (int t = T1 - 1; t >= 0; --t) {
    const size_t mat = (size_t)t * DD * NL + lane;
    const size_t vec = (size_t)t * D * NL + lane;
    // the forward step again: M = J_pre + A_t, v = h_pre + f_t
    const float* Jp = (t == 0 ? J0 : Jf + (size_t)(t - 1) * DD * NL) + lane;
    const float* hp = (t == 0 ? h0 : hf + (size_t)(t - 1) * D * NL) + lane;
    float L[D][D], rd[D], vin[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = Jp[(size_t)(i * D + j) * NL] +
                  A[mat + (size_t)(i * D + j) * NL];
      vin[i] = hp[(size_t)i * NL] + F[vec + (size_t)i * NL];
    }
    chol_inplace<D>(L, rd);
    float z[D];
    solve_lower<D>(L, rd, vin, z);
    float Y[D][D];  // L^-1 D^T
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = Dm[mat + (size_t)(j * D + i) * NL];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * Y[k][j];
        Y[i][j] = s * rd[i];
      }
    }

    // G = Mc + dJ_t, written out as dC_t; its symmetric part Gs = G + G^T
    // (lower triangle) and g = hc + dh_t, written out as dE_t
    float Gs[D][D], g[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const size_t ij = mat + (size_t)(i * D + j) * NL;
        const float gij = Mc[i][j] + dJ[ij];
        dC[ij] = gij;
        if (j < i) {
          const size_t ji = mat + (size_t)(j * D + i) * NL;
          const float gji = Mc[i][j] + dJ[ji];
          dC[ji] = gji;
          Gs[i][j] = gij + gji;
        } else {
          Gs[i][i] = 2.f * gij;
        }
      }
      g[i] = hc[i] + dh[vec + (size_t)i * NL];
      dE[vec + (size_t)i * NL] = g[i];
    }
    // Q = Gs Y^T, a = Y g
    float Q[D][D], a[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          s += (j <= i ? Gs[i][j] : Gs[j][i]) * Y[k][j];
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
    // dD_t row i: -(Q[i][:] - g_i z^T) L^-1 = -(L^-T (Q[i][:] - g_i z))^T
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float p[D], x[D];
#pragma unroll
      for (int k = 0; k < D; ++k) p[k] = Q[i][k] - g[i] * z[k];
      solve_upper<D>(L, rd, p, x);
#pragma unroll
      for (int k = 0; k < D; ++k) dD[mat + (size_t)(i * D + k) * NL] = -x[k];
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
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int i = D - 1; i >= j; --i) {
        float s = R[j][i];
#pragma unroll
        for (int k = i + 1; k < D; ++k) s -= L[k][i] * Mc[k][j];
        Mc[i][j] = s * rd[i];
      }
    }
    float hb_in[D];
#pragma unroll
    for (int i = 0; i < D; ++i) hb_in[i] = lam * z[i] + a[i];
    solve_upper<D>(L, rd, hb_in, hc);

#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        dA[mat + (size_t)(i * D + j) * NL] = j <= i ? Mc[i][j] : Mc[j][i];
      dF[vec + (size_t)i * NL] = hc[i];
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) {
    dh0[i * NL + lane] = hc[i];
#pragma unroll
    for (int j = 0; j < D; ++j)
      dJ0[(i * D + j) * NL + lane] = j <= i ? Mc[i][j] : Mc[j][i];
  }
}

template <int D>
int launch_bidir_adj(int NL, int T1, const float* J0, const float* h0,
                     const float* A, const float* Dm, const float* F,
                     const float* J, const float* h, const float* dJ,
                     const float* dh, const float* dln, float* dA, float* dC,
                     float* dD, float* dE, float* dF, float* dJ0, float* dh0,
                     cudaStream_t stream) {
  dim3 grid((NL + kThreads - 1) / kThreads);
  bidir_adj_kernel<D><<<grid, kThreads, 0, stream>>>(
      NL, T1, J0, h0, A, Dm, F, J, h, dJ, dh, dln, dA, dC, dD, dE, dF, dJ0,
      dh0);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes; returns cudaGetLastError() after the launch
// (0 on success), cudaErrorInvalidValue for an unsupported d.
extern "C" int svae_bidir_adj_f32(int d, int NL, int T1, const float* J0,
                                  const float* h0, const float* A,
                                  const float* Dm, const float* F,
                                  const float* J, const float* h,
                                  const float* dJ, const float* dh,
                                  const float* dln, float* dA, float* dC,
                                  float* dD, float* dE, float* dF,
                                  float* dJ0, float* dh0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_BIDIR_ADJ(DIM)                                                  \
  case DIM:                                                                  \
    return launch_bidir_adj<DIM>(NL, T1, J0, h0, A, Dm, F, J, h, dJ, dh, dln, \
                                 dA, dC, dD, dE, dF, dJ0, dh0, s);
  switch (d) {
    SVAE_BIDIR_ADJ(2)
    SVAE_BIDIR_ADJ(3)
    SVAE_BIDIR_ADJ(4)
    SVAE_BIDIR_ADJ(8)
    SVAE_BIDIR_ADJ(10)
    SVAE_BIDIR_ADJ(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_BIDIR_ADJ
}
