// Hopper kernels of the adjoint of the chain-element prefix scan (the
// backward of ops/chunked.py's ElemScan), in two passes.
//
// They replace svae_tpu/ops/pallas_chunked.py:_scan_adj_kernel.
//
// The sweep runs j = L-1 .. 0 with a carried cotangent g of out[j] (the
// cotangent handed down from step j+1 plus douts[j]). Step 0 passes it
// through (out[0] = leaves[0]); a step j > 0 applies the closed-form
// vector-Jacobian product of out[j] = combine(a, b), a = out[j-1] (the
// saved prefix), b = leaves[j], derived in
// svae_tpu/ops/pallas_chunked.py:_combine_vjp_rows. With M = sym(J22a +
// J11b), W = M^-1, v = W (h2a + h1b), X = W J12a^T, Y = W J12b and the
// cotangent (G11, G12, G22, g1, g2, gc), G11 and G22 symmetrized:
//   db0 = gc v - (X g1 + Y g2),
//   Q1 = G11 X^T + G12 Y^T + g1 v^T,  Q2 = G22 Y^T + g2 v^T,
//   dM = sym(X Q1 + Y Q2) - gc/2 (W + v v^T),
//   dJ12a = -(Q1 + G11 X^T),  dJ12b = -(X G12 + 2 Y G22 + v g2^T),
//   d(a) = (G11, dJ12a, dM, g1, db0, gc)   -> the carry to step j-1,
//   d(b) = (dM, dJ12b, G22, db0, g2, gc)   -> dleaves[j].
// (sym(X Q1 + Y Q2) is the pallas form's X G11 X^T + Y G12^T X^T +
// Y G22 Y^T - u v^T, symmetrized.)
//
// What bounds it on an H100. Each lane is a serial chain of L-1 combines;
// the function's bytes (chip_smoke.bound: ~8.5 us at the config-2 fold)
// are far below what the chains allow, so what the design can cut is the
// latency of one chain's step. The earlier kernel walked each lane on one
// thread, re-factoring M and running 3d+1 pairs of triangular solves for
// X, Y, v and W a step, with the whole cotangent round-tripped through a
// global two-buffer scratch: ~250 us a combine at d=10, 27,720 bytes of
// spill stores.
//
// What the design does about it. M, and so X, Y, v and W, depend only on
// the saved prefix and the leaves, not on the carried cotangent:
//
// 1. elem_scan_adj_factor_kernel runs one thread per (step j >= 1, lane),
//    6,144 at the config-2 fold: it factors M, inverts it in place
//    (inverse_from_chol) and writes X, Y, W and v for the step,
//    lane-minor ((j-1, [X | Y | W | v], lane)), so that a warp's stores
//    coalesce.
// 2. elem_scan_adj_chain_kernel runs d*d threads a chain, thread (i, k)
//    owning entry (i, k) of G11, G12, G22, Q1, Q2 and dM, two adjacent
//    chains a block (one a block ran its step 3x slower at 512 lanes than
//    at 64, each thread's load of a lane-minor row likely a sector of its
//    own): a step is
//    length-d dot products between three block barriers, with X, Y, the
//    G's and Q's in shared memory, rows padded to d+1 floats. The carry
//    stays in registers (the matrices) and in the registers of the
//    threads (i, 0) (the vectors g1 and db0); the next steps' rows of
//    fac and douts are loaded into a ring of registers while a step
//    computes, unconditionally (their step clamped). G11 and G22 are
//    symmetrized as they are formed: the carried parts are symmetric, so
//    each thread reads douts' entries (i, k) and (k, i) and needs no
//    transpose in shared memory. dJ12b, which no later step reads, is
//    formed in the step beside Q1 and Q2.
//
// Every output entry is written once by its own thread: no atomics, no
// scratch but the factor pass's output.

#include "adj_passes.cuh"

namespace {

// Floats of one (step, lane) of the factor pass's output: X, Y, W
// (row-major d x d each), v.
template <int D>
struct ScanFacRow {
  static constexpr int value = 3 * D * D + D;
};

// One thread per (step j >= 1, lane), lane fastest. Inputs leaves, pref
// (L, R, N) with R = 3d^2 + 2d + 1 rows per element (J11, J12, J22
// row-major, h1, h2, c); pref is the forward's output. Output fac (L-1,
// 3d^2 + d, N): row j-1 holds step j's X, Y, W, v.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
elem_scan_adj_factor_kernel(int L, int N, const float* __restrict__ leaves,
                            const float* __restrict__ pref,
                            float* __restrict__ fac) {
  constexpr int DD = D * D, R = 3 * DD + 2 * D + 1;
  constexpr int F = ScanFacRow<D>::value;
  constexpr int kJ12 = DD, kJ22 = 2 * DD, kH1 = 3 * DD, kH2 = kH1 + D;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (L - 1) * N) return;
  const int t = idx / N;  // step j = t + 1
  const int lane = idx - t * N;
  const float* a = pref + (size_t)t * R * N + lane;          // out[j-1]
  const float* b = leaves + (size_t)(t + 1) * R * N + lane;  // leaves[j]

  float Lm[D][D], rd[D], y[D];
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
SVAE_PASS_UNROLL
    for (int k = 0; k <= i; ++k)
      Lm[i][k] = 0.5f * (a[(kJ22 + i * D + k) * N] + a[(kJ22 + k * D + i) * N] +
                         b[(i * D + k) * N] + b[(k * D + i) * N]);
    y[i] = a[(kH2 + i) * N] + b[(kH1 + i) * N];
  }
  chol_inplace<D>(Lm, rd);
  inverse_from_chol<D>(Lm, rd);  // Lm now holds the lower triangle of W
  auto W = [&](int i, int k) { return k <= i ? Lm[i][k] : Lm[k][i]; };

  // fac (L-1, F, N): lane-minor, so that the warp's stores coalesce
  float* out = fac + (size_t)t * F * N + lane;
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) {
    float s = 0.f;
SVAE_PASS_UNROLL
    for (int k = 0; k < D; ++k) {
      out[(2 * DD + i * D + k) * N] = W(i, k);
      s += W(i, k) * y[k];
    }
    out[(3 * DD + i) * N] = s;
  }
  // column k of X = W (row k of J12a); column k of Y = W (column k of J12b)
#pragma unroll (Rows<D>::value)
  for (int k = 0; k < D; ++k) {
    float r[D];
SVAE_PASS_UNROLL
    for (int m = 0; m < D; ++m) r[m] = a[(kJ12 + k * D + m) * N];
SVAE_PASS_UNROLL
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
SVAE_PASS_UNROLL
      for (int m = 0; m < D; ++m) s += W(i, m) * r[m];
      out[(i * D + k) * N] = s;
    }
SVAE_PASS_UNROLL
    for (int m = 0; m < D; ++m) r[m] = b[(kJ12 + m * D + k) * N];
SVAE_PASS_UNROLL
    for (int i = 0; i < D; ++i) {
      float s = 0.f;
SVAE_PASS_UNROLL
      for (int m = 0; m < D; ++m) s += W(i, m) * r[m];
      out[(DD + i * D + k) * N] = s;
    }
  }
}

// How many steps ahead the chain pass loads.
constexpr int kScanRing = 2;

// Chains (adjacent lanes) a block of the chain pass runs side by side, so
// that a warp's loads and stores of the lane-minor rows share sectors.
// Measured at d=10 on an H100 (PERF.md section 6): 2 lanes a block cut
// the step 24% at 512 lanes and cost nothing at 64; 4 cut it 25% at 512
// and cost 13% at 64, where the chains are too few to fill the card; 8
// spill.
constexpr int kScanLanes = 2;

// The chains a block of the chain pass runs at d: kScanLanes while their
// d*d threads each fit a block of 1,024, else one (d > 22).
template <int D>
constexpr int kChainLanes = D * D * kScanLanes <= 1024 ? kScanLanes : 1;

// Blocks of G = kChainLanes<D> chains (lanes blockIdx.x * G + l), d*d*G
// threads, thread (i, k, l) owning entry (i, k) of every d x d matrix of
// lane l's step, walking j = L-1 ... 0. Inputs: fac from
// elem_scan_adj_factor_kernel and the cotangents douts (L, R, N). Output
// dleaves (L, R, N).
template <int D>
__global__ void __launch_bounds__(D * D * kChainLanes<D>)
elem_scan_adj_chain_kernel(int L, int N, const float* __restrict__ fac,
                           const float* __restrict__ douts,
                           float* __restrict__ dleaves) {
  constexpr int DD = D * D, R = 3 * DD + 2 * D + 1;
  constexpr int F = ScanFacRow<D>::value;
  constexpr int kJ12 = DD, kJ22 = 2 * DD, kH1 = 3 * DD, kH2 = kH1 + D,
                kC = kH2 + D;
  constexpr int G = kChainLanes<D>;
  constexpr int SP = D + 1;  // padded row stride of the shared matrices
  constexpr int Q = kScanRing;
  // shared matrices with the block's lanes innermost: entry (r, c) of lane
  // l at (r * SP + c) * G + l, so that a warp's G lanes read G adjacent
  // banks and its threads' rows fall on disjoint ones
  __shared__ float sX[D * SP * G], sY[D * SP * G], sG11[D * SP * G],
      sG12[D * SP * G], sG22[D * SP * G], sQ1[D * SP * G], sQ2[D * SP * G],
      sS[D * SP * G], sg1[D * G], sg2[D * G], sv[D * G];
  const int l = threadIdx.x % G;
  const int i = threadIdx.x / G / D;
  const int k = threadIdx.x / G - i * D;
  const int ik = i * D + k, ki = k * D + i;
  // a lane past N runs lane N-1's loads and the block's barriers, and
  // stores nothing
  const int lane0 = blockIdx.x * G + l;
  const bool live = lane0 < N;
  const int lane = live ? lane0 : N - 1;
  const size_t step = (size_t)R * N;
  auto at = [&](int r, int c) { return (r * SP + c) * G + l; };

  // the carried cotangent of out[j-1]: entry (i, k) of its J11 (G11), J12
  // (dJ12a) and J22 (dM), and c (gc); h1 (g1) and h2 (db0) entry i on the
  // threads (i, 0, l)
  float c11 = 0.f, c12 = 0.f, c22 = 0.f, ch1 = 0.f, ch2 = 0.f, cc = 0.f;

  // steps j-1 ... j-Q in flight while step j computes: a ring of Q
  // register slots, the loop unrolled by Q so that every slot index is a
  // constant. A slot holds X, Y, W entry (i, k), v_i, v_k and douts'
  // J11, J22 entries (i, k) and (k, i), J12 entry (i, k), h1_i, h2_i, c.
  float nX[Q], nY[Q], nW[Q], nvi[Q], nvk[Q], n11[Q], n11t[Q], n12[Q],
      n22[Q], n22t[Q], nh1[Q], nh2[Q], nc[Q];
  // (unconditional loads, the step clamped to 1: see filter_adj.cu)
  auto load = [&](int j, int u) {
    j = j > 1 ? j : 1;
    const float* f = fac + (size_t)(j - 1) * F * N + lane;
    nX[u] = f[ik * N];
    nY[u] = f[(DD + ik) * N];
    nW[u] = f[(2 * DD + ik) * N];
    nvi[u] = f[(3 * DD + i) * N];
    nvk[u] = f[(3 * DD + k) * N];
    const float* g = douts + (size_t)j * step + lane;
    n11[u] = g[ik * N];
    n11t[u] = g[ki * N];
    n12[u] = g[(kJ12 + ik) * N];
    n22[u] = g[(kJ22 + ik) * N];
    n22t[u] = g[(kJ22 + ki) * N];
    nh1[u] = g[(kH1 + i) * N];
    nh2[u] = g[(kH2 + i) * N];
    nc[u] = g[kC * N];
  };
  if (L > 1) {
#pragma unroll
    for (int u = 0; u < Q; ++u) load(L - 1 - u, u);
  }
  for (int j0 = L - 1; j0 >= 1; j0 -= Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int j = j0 - u;
      if (j < 1) break;
      // step j's slot into place (G11, G22 symmetrized), then step j-Q's
      // loads in flight
      const float Wik = nW[u], vi = nvi[u], vk = nvk[u];
      const float G11 = c11 + 0.5f * (n11[u] + n11t[u]);
      const float G12 = c12 + n12[u];
      const float G22 = c22 + 0.5f * (n22[u] + n22t[u]);
      const float gc = cc + nc[u];
      const float g1 = ch1 + nh1[u], g2 = ch2 + nh2[u];  // on (i, 0, l)
      sX[at(i, k)] = nX[u];
      sY[at(i, k)] = nY[u];
      sG11[at(i, k)] = G11;
      sG12[at(i, k)] = G12;
      sG22[at(i, k)] = G22;
      if (k == 0) {
        sg1[i * G + l] = g1;
        sg2[i * G + l] = g2;
        sv[i * G + l] = vi;
      }
      load(j - Q, u);
      __syncthreads();

      // P11 = G11 X^T, P12 = G12 Y^T, P22 = G22 Y^T; the two products of
      // dJ12b, X G12 and Y G22; on (i, 0, l), X g1 + Y g2
      float p11 = 0.f, p12 = 0.f, p22 = 0.f, b12 = 0.f, b22 = 0.f;
#pragma unroll
      for (int n = 0; n < D; ++n) {
        p11 += sG11[at(i, n)] * sX[at(k, n)];
        p12 += sG12[at(i, n)] * sY[at(k, n)];
        p22 += sG22[at(i, n)] * sY[at(k, n)];
        b12 += sX[at(i, n)] * sG12[at(n, k)];
        b22 += sY[at(i, n)] * sG22[at(n, k)];
      }
      const float q1 = p11 + p12 + sg1[i * G + l] * vk;
      const float q2 = p22 + sg2[i * G + l] * vk;
      sQ1[at(i, k)] = q1;
      sQ2[at(i, k)] = q2;
      float* db = dleaves + (size_t)j * step + lane;
      if (live) {
        db[(kJ12 + ik) * N] = -(b12 + 2.f * b22 + vi * sg2[k * G + l]);
        db[(kJ22 + ik) * N] = G22;
      }
      if (k == 0) {
        float u1 = 0.f, u2 = 0.f;
#pragma unroll
        for (int n = 0; n < D; ++n) {
          u1 += sX[at(i, n)] * sg1[n * G + l];
          u2 += sY[at(i, n)] * sg2[n * G + l];
        }
        const float db0 = gc * vi - (u1 + u2);
        if (live) {
          db[(kH1 + i) * N] = db0;
          db[(kH2 + i) * N] = g2;
        }
        ch1 = g1;
        ch2 = db0;
      }
      if (live && ik == 0) db[kC * N] = gc;
      __syncthreads();

      // S = X Q1 + Y Q2
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < D; ++m)
        s += sX[at(i, m)] * sQ1[at(m, k)] + sY[at(i, m)] * sQ2[at(m, k)];
      sS[at(i, k)] = s;
      __syncthreads();

      // dM = sym(S) - gc/2 (W + v v^T), exactly symmetric: threads (i, k)
      // and (k, i) add the same two entries
      const float dM =
          0.5f * (sS[at(i, k)] + sS[at(k, i)]) - 0.5f * gc * (Wik + vi * vk);
      if (live) db[ik * N] = dM;
      c11 = G11;
      c12 = -(q1 + p11);
      c22 = dM;
      cc = gc;
    }
  }

  // step 0 passes its cotangent through
  if (!live) return;
  const float* g = douts + lane;
  float* db = dleaves + lane;
  db[ik * N] = c11 + g[ik * N];
  db[(kJ12 + ik) * N] = c12 + g[(kJ12 + ik) * N];
  db[(kJ22 + ik) * N] = c22 + g[(kJ22 + ik) * N];
  if (k == 0) {
    db[(kH1 + i) * N] = ch1 + g[(kH1 + i) * N];
    db[(kH2 + i) * N] = ch2 + g[(kH2 + i) * N];
  }
  if (ik == 0) db[kC * N] = cc + g[kC * N];
}

template <int D>
int launch_factor(int L, int N, const float* leaves, const float* pref,
                  float* fac, cudaStream_t stream) {
  const int n = (L - 1) * N;
  if (n == 0) return 0;  // a one-step chain has no combine
  elem_scan_adj_factor_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          L, N, leaves, pref, fac);
  return (int)cudaGetLastError();
}

template <int D>
int launch_chain(int L, int N, const float* fac, const float* douts,
                 float* dleaves, cudaStream_t stream) {
  constexpr int G = kChainLanes<D>;
  elem_scan_adj_chain_kernel<D><<<(N + G - 1) / G, D * D * G, 0, stream>>>(
      L, N, fac, douts, dleaves);
  return (int)cudaGetLastError();
}

template <int D>
int launch_scan_adj(int L, int N, const float* leaves, const float* pref,
                    const float* douts, float* dleaves, float* fac,
                    cudaStream_t stream) {
  const int err = launch_factor<D>(L, N, leaves, pref, fac, stream);
  if (err != 0) return err;
  return launch_chain<D>(L, N, fac, douts, dleaves, stream);
}

}  // namespace

// Plain C entries for ctypes; each returns cudaGetLastError() after its
// launches (0 on success), cudaErrorInvalidValue for an unsupported d.
// svae_elem_scan_adj_f32 runs both passes (fac is its scratch, (L-1,
// 3d^2 + d, N)); the other two run one pass each.
extern "C" int SVAE_ENTRY(svae_elem_scan_adj_f32)(int d, int L, int N,
                                      const float* leaves, const float* pref,
                                      const float* douts, float* dleaves,
                                      float* fac, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_scan_adj<DIM>(L, N, leaves, pref, douts, dleaves, fac, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_elem_scan_adj_factor_f32)(int d, int L, int N,
                                             const float* leaves,
                                             const float* pref, float* fac,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_factor<DIM>(L, N, leaves, pref, fac, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_elem_scan_adj_chain_f32)(int d, int L, int N,
                                            const float* fac,
                                            const float* douts,
                                            float* dleaves, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_chain<DIM>(L, N, fac, douts, dleaves, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
