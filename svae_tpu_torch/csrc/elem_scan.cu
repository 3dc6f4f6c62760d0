// Hopper kernel of the chain-element prefix scan (the forward of
// ops/chunked.py's ElemScan), the within-chunk and chunk-boundary passes of
// the chunked parallel-in-time LDS E-step.
//
// elem_scan_kernel<D> replaces svae_tpu/ops/pallas_chunked.py:_scan_fwd_kernel.
//
// Each of N lanes scans L Gaussian chain elements e = (J11, J12, J22, h1,
// h2, c): out[0] = leaves[0], out[j] = combine(out[j-1], leaves[j]), where
// combine marginalizes the variable the two blocks share. With
// M = sym(J22a + J11b), L = chol(M), w = L^-1 (h2a + h1b),
// Z = L^-1 J12a^T and W = L^-1 J12b:
//   J11 = sym(J11a) - Z^T Z,  J12 = -Z^T W,  J22 = sym(J22b) - W^T W,
//   h1 = h1a - Z^T w,  h2 = h2b - W^T w,
//   c = ca + cb + d/2 log 2pi - sum_i log L_ii + |w|^2 / 2,
// the combine of svae_tpu/ops/pallas_chunked.py:_combine_rows with the two
// back substitutions of each solve folded into Z^T Z, Z^T W and W^T W.
//
// What bounds it on an H100. Each lane is a serial chain of L combines, a
// d x d Cholesky factor and 2d triangular solves each, and the chunked
// E-step runs few lanes (B*C = 512 within the chunks at the config-2 and
// long-T shapes, B across them): far fewer threads than the card holds.
// The bytes (each step reads one element and writes one, 321 floats at
// d=10) are far below what the card moves in that time: the kernel is
// bound by the latency of one lane's arithmetic.
//
// What the design does about it. One thread runs one lane, the whole scan
// in one launch. The carried element is not held in registers: the thread
// reads it back from the row it wrote a step before (its own write, so no
// synchronization), which leaves the factor, Z and W (about 265 floats at
// d=10) as the live state. Elements keep the lane innermost, so the threads
// of a warp read and write neighbouring addresses. D is a template
// parameter; up to d=10 every loop is unrolled and every array index is a
// constant, at d=16 the loops over rows stay rolled to keep the build short
// (the arrays live in local memory there either way). Lanes past N return;
// the caller pads time with decoupled unit-Gaussian steps, so the algebra
// needs no masks. A failed factor gives NaN, which reaches every later
// element of its lane.

#include "estep_common.cuh"

namespace {

// Layouts: leaves, out (L, R, N) with R = 3d^2 + 2d + 1 rows per element:
// J11, J12, J22 (row-major d x d each), h1, h2 (d each), c.
template <int D>
__global__ void __launch_bounds__(kThreads)
elem_scan_kernel(int L, int N, const float* __restrict__ leaves,
                 float* out) {
  constexpr int DD = D * D, R = 3 * DD + 2 * D + 1;
  constexpr int kJ12 = DD, kJ22 = 2 * DD, kH1 = 3 * DD, kH2 = kH1 + D,
                kC = kH2 + D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  const size_t step = (size_t)R * N;

  for (int r = 0; r < R; ++r)
    out[(size_t)r * N + lane] = leaves[(size_t)r * N + lane];

  for (int j = 1; j < L; ++j) {
    const float* a = out + (size_t)(j - 1) * step + lane;  // out[j-1]
    const float* b = leaves + (size_t)j * step + lane;
    float* o = out + (size_t)j * step + lane;
    auto A = [&](int r) { return a[(size_t)r * N]; };
    auto Bl = [&](int r) { return b[(size_t)r * N]; };

    float Lm[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k <= i; ++k)
        Lm[i][k] = 0.5f * (A(kJ22 + i * D + k) + A(kJ22 + k * D + i) +
                           Bl(i * D + k) + Bl(k * D + i));
    }
    const float half_logdet = chol_inplace<D>(Lm, rd);

    float x[D], w[D];
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = A(kH2 + i) + Bl(kH1 + i);
    solve_lower<D>(Lm, rd, x, w);

    // Zt[k] = L^-1 (row k of J12a), so Zt[k][m] = Z[m][k];
    // Wt[k] = L^-1 (column k of J12b), so Wt[k][m] = W[m][k]
    float Zt[D][D], Wt[D][D];
#pragma unroll (Rows<D>::value)
    for (int k = 0; k < D; ++k) {
      float y[D];
#pragma unroll
      for (int m = 0; m < D; ++m) y[m] = A(kJ12 + k * D + m);
      solve_lower<D>(Lm, rd, y, Zt[k]);
#pragma unroll
      for (int m = 0; m < D; ++m) y[m] = Bl(kJ12 + m * D + k);
      solve_lower<D>(Lm, rd, y, Wt[k]);
    }

#pragma unroll (Rows<D>::value)
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float s12 = 0.f;
#pragma unroll
        for (int m = 0; m < D; ++m) s12 += Zt[i][m] * Wt[k][m];
        o[(size_t)(kJ12 + i * D + k) * N] = -s12;
        if (k > i) continue;
        float s11 = 0.5f * (A(i * D + k) + A(k * D + i));
        float s22 = 0.5f * (Bl(kJ22 + i * D + k) + Bl(kJ22 + k * D + i));
#pragma unroll
        for (int m = 0; m < D; ++m) {
          s11 -= Zt[i][m] * Zt[k][m];
          s22 -= Wt[i][m] * Wt[k][m];
        }
        o[(size_t)(i * D + k) * N] = s11;
        o[(size_t)(k * D + i) * N] = s11;
        o[(size_t)(kJ22 + i * D + k) * N] = s22;
        o[(size_t)(kJ22 + k * D + i) * N] = s22;
      }
      float s1 = A(kH1 + i), s2 = Bl(kH2 + i);
#pragma unroll
      for (int m = 0; m < D; ++m) {
        s1 -= Zt[i][m] * w[m];
        s2 -= Wt[i][m] * w[m];
      }
      o[(size_t)(kH1 + i) * N] = s1;
      o[(size_t)(kH2 + i) * N] = s2;
    }

    float ww = 0.f;
#pragma unroll
    for (int m = 0; m < D; ++m) ww += w[m] * w[m];
    o[(size_t)kC * N] =
        A(kC) + Bl(kC) + 0.5f * D * kLog2Pi - half_logdet + 0.5f * ww;
  }
}

template <int D>
int launch_scan(int L, int N, const float* leaves, float* out,
                cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads);
  elem_scan_kernel<D><<<grid, kThreads, 0, stream>>>(L, N, leaves, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Returns cudaGetLastError() after the launch (0
// on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int svae_elem_scan_f32(int d, int L, int N, const float* leaves,
                                  float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_scan<2>(L, N, leaves, out, s);
    case 3: return launch_scan<3>(L, N, leaves, out, s);
    case 4: return launch_scan<4>(L, N, leaves, out, s);
    case 8: return launch_scan<8>(L, N, leaves, out, s);
    case 10: return launch_scan<10>(L, N, leaves, out, s);
    case 16: return launch_scan<16>(L, N, leaves, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
