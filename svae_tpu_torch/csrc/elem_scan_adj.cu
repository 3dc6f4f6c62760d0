// Hopper kernel of the adjoint of the chain-element prefix scan (the
// backward of ops/chunked.py's ElemScan).
//
// elem_scan_adj_kernel<D> replaces
// svae_tpu/ops/pallas_chunked.py:_scan_adj_kernel.
//
// The sweep runs j = L-1 .. 0 with a carried cotangent g of out[j] (the
// cotangent handed down from step j+1 plus douts[j]). Step 0 passes it
// through (out[0] = leaves[0]); a step j > 0 applies the closed-form
// vector-Jacobian product of out[j] = combine(a, b), a = out[j-1] (the
// saved prefix), b = leaves[j], derived in
// svae_tpu/ops/pallas_chunked.py:_combine_vjp_rows. With M = sym(J22a +
// J11b) = L L^T, v = M^-1 (h2a + h1b), X = M^-1 J12a^T, Y = M^-1 J12b and
// the cotangent (G11, G12, G22, g1, g2, gc), G11 and G22 symmetrized:
//   u = -(X g1 + Y g2),  db0 = gc v + u,
//   Q1 = G11 X^T + G12 Y^T + g1 v^T,  Q2 = G22 Y^T + g2 v^T,
//   dM = sym(X Q1 + Y Q2) - gc/2 (M^-1 + v v^T),
//   dJ12a = -(Q1 + G11 X^T),  dJ12b = -(X G12 + 2 Y G22 + v g2^T),
//   d(a) = (G11, dJ12a, dM, g1, db0, gc)   -> the carry to step j-1,
//   d(b) = (dM, dJ12b, G22, db0, g2, gc)   -> dleaves[j].
// (sym(X Q1 + Y Q2) is the pallas form's X G11 X^T + Y G12^T X^T +
// Y G22 Y^T - u v^T, symmetrized.) M^-1 comes from the factor by solves,
// never a general inverse.
//
// What bounds it on an H100: as the forward (csrc/elem_scan.cu), the
// latency of one lane's serial chain of L-1 steps, with far fewer lanes
// than the card holds; each step reads three elements and writes one.
//
// What the design does about it. One thread runs one lane, the whole sweep
// in one launch, with no atomics: every lane writes only its own rows. The
// factor of M is recomputed from the saved prefix instead of being saved by
// the forward. The carried cotangent lives in a two-buffer scratch the
// wrapper allocates (one buffer read, one written a step, so a step never
// overwrites what it still reads), which leaves the factor, X, Y and the
// lower triangle of dM (about 320 floats at d=10) as the live state; a row
// of Q1 and Q2 at a time is formed and folded into dM and dJ12a. D is a
// template parameter; the loops over rows unroll fully up to d=10 and stay
// rolled at d=16, as in the forward.

#include "estep_common.cuh"

namespace {

// Layouts: leaves, pref, douts, dleaves (L, R, N) with R = 3d^2 + 2d + 1
// rows per element (J11, J12, J22 row-major, h1, h2, c); pref is the
// forward's output; scratch (2, R, N).
template <int D>
__global__ void __launch_bounds__(kThreads)
elem_scan_adj_kernel(int L, int N, const float* __restrict__ leaves,
                     const float* __restrict__ pref,
                     const float* __restrict__ douts, float* dleaves,
                     float* scratch) {
  constexpr int DD = D * D, R = 3 * DD + 2 * D + 1;
  constexpr int kJ12 = DD, kJ22 = 2 * DD, kH1 = 3 * DD, kH2 = kH1 + D,
                kC = kH2 + D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t step = (size_t)R * N;

  for (int s = 0; s < L; ++s) {
    const int j = L - 1 - s;
    float* g = scratch + (size_t)(s & 1) * step + lane;        // cot. out[j]
    float* gn = scratch + (size_t)((s + 1) & 1) * step + lane;  // to out[j-1]
    const float* go = douts + (size_t)j * step + lane;
    float* db = dleaves + (size_t)j * step + lane;
    for (int r = 0; r < R; ++r)
      g[(size_t)r * N] = (s ? g[(size_t)r * N] : 0.f) + go[(size_t)r * N];
    if (j == 0) {
      for (int r = 0; r < R; ++r) db[(size_t)r * N] = g[(size_t)r * N];
      break;
    }
    // symmetrize G11 and G22 in place
    for (int i = 0; i < D; ++i) {
      for (int k = 0; k < i; ++k) {
        const int p = i * D + k, q = k * D + i;
        const float s11 = 0.5f * (g[(size_t)p * N] + g[(size_t)q * N]);
        const float s22 =
            0.5f * (g[(size_t)(kJ22 + p) * N] + g[(size_t)(kJ22 + q) * N]);
        g[(size_t)p * N] = s11;
        g[(size_t)q * N] = s11;
        g[(size_t)(kJ22 + p) * N] = s22;
        g[(size_t)(kJ22 + q) * N] = s22;
      }
    }
    const float* a = pref + (size_t)(j - 1) * step + lane;
    const float* b = leaves + (size_t)j * step + lane;
    auto A = [&](int r) { return a[(size_t)r * N]; };
    auto Bl = [&](int r) { return b[(size_t)r * N]; };
    auto G = [&](int r) { return g[(size_t)r * N]; };

    float Lm[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k)
        Lm[i][k] = 0.5f * (A(kJ22 + i * D + k) + A(kJ22 + k * D + i) +
                           Bl(i * D + k) + Bl(k * D + i));
    }
    chol_inplace<D>(Lm, rd);

    float y[D], z[D], v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = A(kH2 + i) + Bl(kH1 + i);
    solve_lower<D>(Lm, rd, y, z);
    solve_upper<D>(Lm, rd, z, v);

    // Xc[k] = M^-1 (row k of J12a) = column k of X;
    // Yc[k] = M^-1 (column k of J12b) = column k of Y
    float Xc[D][D], Yc[D][D];
#pragma unroll (Rows<D>::value)
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int m = 0; m < D; ++m) y[m] = A(kJ12 + k * D + m);
      solve_lower<D>(Lm, rd, y, z);
      solve_upper<D>(Lm, rd, z, Xc[k]);
#pragma unroll
      for (int m = 0; m < D; ++m) y[m] = Bl(kJ12 + m * D + k);
      solve_lower<D>(Lm, rd, y, z);
      solve_upper<D>(Lm, rd, z, Yc[k]);
    }

    float g1[D], g2[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      g1[i] = G(kH1 + i);
      g2[i] = G(kH2 + i);
    }
    const float gc = G(kC);
    // the pass-through parts: d(b) gets G22, g2, gc; d(a) gets G11, g1, gc;
    // both get db0 = gc v - (X g1 + Y g2)
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float u = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) u -= Xc[k][i] * g1[k] + Yc[k][i] * g2[k];
      const float db0 = gc * v[i] + u;
      db[(size_t)(kH1 + i) * N] = db0;
      db[(size_t)(kH2 + i) * N] = g2[i];
      gn[(size_t)(kH1 + i) * N] = g1[i];
      gn[(size_t)(kH2 + i) * N] = db0;
    }
    db[(size_t)kC * N] = gc;
    gn[(size_t)kC * N] = gc;
    for (int p = 0; p < DD; ++p) {
      db[(size_t)(kJ22 + p) * N] = G(kJ22 + p);
      gn[(size_t)p * N] = G(p);
    }

    // row m of Q1 and Q2 at a time: dJ12a's row m, and its rank-one share
    // of the lower triangle of sym(X Q1 + Y Q2)
    float Dm[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) Dm[i][k] = 0.f;
    }
#pragma unroll (Rows<D>::value)
    for (int m = 0; m < D; ++m) {
      float q1[D], q2[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float p11 = 0.f, p12 = 0.f, p22 = 0.f;
#pragma unroll
        for (int n = 0; n < D; ++n) {
          p11 += G(m * D + n) * Xc[n][k];
          p12 += G(kJ12 + m * D + n) * Yc[n][k];
          p22 += G(kJ22 + m * D + n) * Yc[n][k];
        }
        q1[k] = p11 + p12 + g1[m] * v[k];
        q2[k] = p22 + g2[m] * v[k];
        gn[(size_t)(kJ12 + m * D + k) * N] = -(q1[k] + p11);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int k = 0; k <= i; ++k)
          Dm[i][k] += 0.5f * (Xc[m][i] * q1[k] + Xc[m][k] * q1[i] +
                              Yc[m][i] * q2[k] + Yc[m][k] * q2[i]);
      }
    }

    // dJ12b, a column at a time
#pragma unroll (Rows<D>::value)
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float acc = v[i] * g2[k];
#pragma unroll
        for (int n = 0; n < D; ++n)
          acc += Xc[n][i] * G(kJ12 + n * D + k) +
                 2.f * Yc[n][i] * G(kJ22 + n * D + k);
        db[(size_t)(kJ12 + i * D + k) * N] = -acc;
      }
    }

    // M^-1 = L^-T L^-1 from the columns of L^-1: Li[c] = L^-1 e_c
    float Li[D][D];
#pragma unroll (Rows<D>::value)
    for (int c = 0; c < D; ++c) {
#pragma unroll
      for (int m = 0; m < D; ++m) y[m] = m == c ? 1.f : 0.f;
      solve_lower<D>(Lm, rd, y, Li[c]);
    }
#pragma unroll (Rows<D>::value)
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k) {
        float minv = 0.f;
#pragma unroll
        for (int m = 0; m < D; ++m) minv += Li[i][m] * Li[k][m];
        const float dm = Dm[i][k] - 0.5f * gc * (minv + v[i] * v[k]);
        db[(size_t)(i * D + k) * N] = dm;
        db[(size_t)(k * D + i) * N] = dm;
        gn[(size_t)(kJ22 + i * D + k) * N] = dm;
        gn[(size_t)(kJ22 + k * D + i) * N] = dm;
      }
    }
  }
}

template <int D>
int launch_scan_adj(int L, int N, const float* leaves, const float* pref,
                    const float* douts, float* dleaves, float* scratch,
                    cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads);
  elem_scan_adj_kernel<D><<<grid, kThreads, 0, stream>>>(
      L, N, leaves, pref, douts, dleaves, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Returns cudaGetLastError() after the launch (0
// on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int svae_elem_scan_adj_f32(int d, int L, int N,
                                      const float* leaves, const float* pref,
                                      const float* douts, float* dleaves,
                                      float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_scan_adj<2>(L, N, leaves, pref, douts, dleaves, scratch, s);
    case 3: return launch_scan_adj<3>(L, N, leaves, pref, douts, dleaves, scratch, s);
    case 4: return launch_scan_adj<4>(L, N, leaves, pref, douts, dleaves, scratch, s);
    case 8: return launch_scan_adj<8>(L, N, leaves, pref, douts, dleaves, scratch, s);
    case 10: return launch_scan_adj<10>(L, N, leaves, pref, douts, dleaves, scratch, s);
    case 16: return launch_scan_adj<16>(L, N, leaves, pref, douts, dleaves, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
