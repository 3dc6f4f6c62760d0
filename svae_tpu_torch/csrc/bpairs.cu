// Hopper kernels of the LDS E-step on per-sequence ("bpairs") pair
// potentials: the generic bidirectional information filter and the
// backward conditional sampler, both reading their pair blocks as streams;
// and the same sampler on pair rows shared by the batch.
//
// bidir_fwd_kernel<D> replaces svae_tpu/ops/pallas_bidir.py:_bidir_fwd_kernel;
// sampler_bp_fwd_factor_kernel<D> and sampler_bp_fwd_chain_kernel<D>
// together replace svae_tpu/ops/pallas_vjp.py:_sampler_fwd_kernel;
// sampler_shared_factor_kernel<D> and sampler_bp_fwd_chain_kernel<D>
// together replace svae_tpu/ops/pallas_kalman.py:_sampler_kernel.
//
// What bounds them on an H100. As in estep.cu, every lane is a serial
// chain of T-1 small dense steps, and at the ragged slice's shape (B=64,
// 2B = 128 filter chains, S*B = 64 sampler chains, T up to 512, d=10) there
// are far fewer chains than the card holds threads: the latency of one
// chain's step bounds them. Unlike estep.cu's, these kernels stream the
// pair blocks: a filter step reads A (lower triangle), C, D, e, f and pc,
// 2.55 d^2 + 2d + 1 floats a lane (about 1.1 KB at d=10) where the
// stationary filter reads 2d, and writes d^2 + d as it does. The function's
// bytes still take far less time than the chain's steps.
//
// What the design does about it.
//
// The filter's factorization cannot leave its chain: the step's M = J + A_t
// depends on the carried J. So bidir_fwd_kernel takes estep.cu's
// filter_fwd design, one warp per chain, a Gauss-Jordan elimination of
// [M | D_t^T | v] on its lanes a step: the step of filter_chain.cuh, which
// the shared-pair filters of kalman_fwd.cu run too; this kernel is its
// reader for per-lane streams.
// What differs from the stationary filter: every block is a per-lane
// stream ((T-1, d*d, lanes), the lane innermost, the layout bidir_adj's
// passes and the packing glue read). D_t changes every step, so each lane
// stores its row of D_t into a double-buffered shared tile every step (one
// warp barrier a step), and D_t X reads it as broadcasts. A lane loads
// its column of A and row of D (the vector lane: f) for step t+1 while
// step t computes, and its column of C, the row of C that holds its
// column's lower triangle (the vector lane: e) and pc at the start of the
// step that reads them at its end; the loads are unconditional and the
// step clamped (a load under a condition waits at once). J is written as
// C_t - D_t X_D with C read in full, and the carry takes C's lower
// triangle, as the plain version does. One chain's entries lie 4 NL bytes
// apart, so each float a lane loads costs a sector of its own; adjacent
// chains in one block (kBidirChains warps) would share those sectors, but
// 2 and 4 a block ran 3-33% slower than 1 (PERF.md §6), so a block runs
// one chain.
//
// The sampler's factorization depends neither on the carried sample nor
// on the sample s, so it leaves the chain, as in estep.cu's sampler. With
// L_t = chol(Jc_t), Jc_t = Jf_t - 2 P3_t, a step is
//   x_t = Jc_t^-1 (hf_t + P2_t^T x_{t+1}) + L_t^-T eps_t = c_t + Q_t x_{t+1},
//   c_t = L_t^-T (L_t^-1 hf_t + eps_t),  Q_t = Jc_t^-1 P2_t^T.
// The one-thread-per-chain kernel this replaces refactored Jc_t on the
// chain, 4.5 us a step at d=10 with 64 threads busy at ragged T=512.
// 1. sampler_bp_fwd_factor_kernel runs one thread per (step, sequence),
//    32,704 at T=512, B=64: it factors Jc_t once for the S samples
//    (adj_passes.cuh's factor_jc), writes c per sample, and Q_t by two
//    triangular solves a column, lane-minor in Jf's layout. P2_t streams,
//    unlike estep.cu's stationary P2, so folding it into Q here leaves the
//    chain one matrix-vector product, one barrier and d loads a thread a
//    step, where W_t and P2_t streamed to the chain took two of each (1.8x
//    slower at T=512, PERF.md §6).
// 2. sampler_bp_fwd_chain_kernel runs one chain per block of d threads
//    (sample s, sequence b), thread i owning row i: x_t[i] = c_t[i] +
//    Q_t[i] . x_{t+1}, x_{t+1} through shared memory double-buffered by the
//    step's parity, and the coming steps' rows of Q and c in a ring in
//    shared memory (kBpFwdRing steps) filled by cp.async, as the HMM
//    chains' (0.26-0.29 us a step with a ring of registers, whose every
//    load the step waited on; 0.11-0.14 us with this ring).
// svae_sampler_bp_fwd_f32 launches the two, one after the other, with Q
// and c as the caller's scratch. The sampler reads the pairs at sequence
// lane % B.
// The shared-pair sampler (ops/kalman_fwd.py) is this sampler with P2_t
// and P3_t one (d*d) row a step for the whole batch. Its one-thread-per-
// chain kernel refactored Jc_t on the chain as well, 2.6 us a step at d=10
// and B=8, T=2048. Now it runs the same two passes, from
// svae_sampler_shared_f32: sampler_shared_factor_kernel is the factor
// pass's body (sampler_fwd_factor) reading each step's rows at stride 1,
// the same address for every thread of a step (a warp's threads hold one
// step, or a few at small B, so the rows come as broadcasts, and a (step,
// sequence) reads 1.5 d^2 fewer floats than on expanded pairs); the Q_t
// it writes is per sequence, since Jf_t is, and the chain pass is
// sampler_bp_fwd_chain_kernel as it is.
// T and the lane counts are runtime arguments (the length buckets and a
// tail batch vary them); only d is a template parameter, so the steps'
// loops unroll. There is no lane or time padding: every stream
// row is a real step.

#include "adj_passes.cuh"
#include "filter_chain.cuh"

namespace {

// How many chains (one warp each) a block of bidir_fwd_kernel runs.
constexpr int kBidirChains = 1;

// How many steps the sampler's chain pass keeps in its shared-memory ring
// (chip_variants.py: 4, 8 and 16 within 7%).
constexpr int kBpFwdRing = 8;

// One warp per lane (chain) l of the NL lanes, kBidirChains a block, on
// filter_chain.cuh's step with M = J + A_t, v = h + f_t, J' = C_t - D_t X_D,
// h' = D_t X_v + e_t, ln += d/2 log 2pi - 1/2 sum log p_k + 1/2 v . X_v +
// pc_t. Layouts: J0 (d*d, NL), h0 (d, NL); A, C, D (T1, d*d, NL); E, F
// (T1, d, NL); Pc (T1, NL); out J (T1, d*d, NL), h (T1, d, NL), ln (NL).
// J0 and A are read as their lower triangles.
template <int D>
__global__ void __launch_bounds__(32 * kBidirChains)
bidir_fwd_kernel(int NL, int T1, const float* __restrict__ J0,
                 const float* __restrict__ h0, const float* __restrict__ A,
                 const float* __restrict__ C, const float* __restrict__ Dm,
                 const float* __restrict__ E, const float* __restrict__ F,
                 const float* __restrict__ Pc, float* __restrict__ Jout,
                 float* __restrict__ hout, float* __restrict__ ln) {
  constexpr int DD = D * D;
  constexpr int DP = (D + 3) & ~3;  // the D tile's row stride, for float4
  __shared__ __align__(16) float sDall[kBidirChains][2 * D * DP];
  const int lane = blockIdx.x * kBidirChains + threadIdx.x / 32;
  if (lane >= NL) return;  // the whole warp
  float* sD = sDall[threadIdx.x / 32];
  const int j = threadIdx.x % 32;
  for (int k = j; k < 2 * D * DP; k += 32) sD[k] = 0.f;  // the padding
  __syncwarp();  // before the first step's rows land on the zeros
  const bool vec = j == D;           // the lane of the vector column
  const int jc = j < D ? j : D - 1;  // the column a lane reads (clamped)
  const size_t mstep = (size_t)DD * NL;
  // a lane's row streams, stride NL between entries: row jc of D (the
  // vector lane: f) and row jc of C (the vector lane: e)
  const float* Drow = vec ? F + lane : Dm + (size_t)jc * D * NL + lane;
  const float* Crow = vec ? E + lane : C + (size_t)jc * D * NL + lane;
  const size_t rstep = vec ? (size_t)D * NL : mstep;
  // entry i of column jc of a symmetric block, read from its lower triangle
  auto lo = [&](int i) { return (i > jc ? i * D + jc : jc * D + i) * NL; };

  // lane j < D: column j of the carried J; lane D: the carried h (d = 32:
  // hc, on every lane)
  float cj[D], hc[kWideChain<D> ? D : 1];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    cj[i] = vec ? h0[i * NL + lane] : J0[lo(i) + lane];
    if constexpr (kWideChain<D>) hc[i] = h0[i * NL + lane];
  }

  // step t+1's column of A and row of D (f) in flight while step t
  // computes (unconditional loads, the step clamped to T1-1)
  float nA[D], nR[D];
  auto load = [&](int t) {
    t = t < T1 ? t : T1 - 1;
    const float* a = A + t * mstep + lane;
    const float* r = Drow + t * rstep;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      nA[i] = a[lo(i)];
      nR[i] = r[(size_t)i * NL];
    }
  };
  load(0);
  // the reader: step t's column of A and row of D from the registers
  // loaded the step before; what the step reads at its end, column jc of
  // C_t in full (Cc), the row of C_t that holds the column's lower
  // triangle above the diagonal (the vector lane: e_t) (Cr) and pc_t, from
  // device memory; then the next step's loads; then the lane's row of D_t
  // into the warp's tile of the step's parity
  auto step = [&](int t, FilterOperands<D>& op) -> const float* {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      op.A[i] = nA[i];
      op.Dr[i] = nR[i];
    }
    const float* c = C + t * mstep + lane;
    const float* cr = Crow + t * rstep;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      op.Cc[i] = c[(size_t)(i * D + jc) * NL];
      op.Cr[i] = cr[(size_t)i * NL];
    }
    op.pc = Pc[(size_t)t * NL + lane];
    if constexpr (kWideChain<D>) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        op.f[i] = F[((size_t)t * D + i) * NL + lane];
        op.e[i] = E[((size_t)t * D + i) * NL + lane];
      }
    }
    load(t + 1);
    float* sDt = sD + (t & 1) * D * DP;
    if (j < D) {
#pragma unroll
      for (int i = 0; i < D; ++i) sDt[j * DP + i] = op.Dr[i];
    }
    // (one barrier a step: the tile written here was last read two steps
    // ago, before every lane passed the previous step's barrier)
    __syncwarp();
    return sDt;
  };
  auto out = [&](int t) {
    return vec ? hout + (size_t)t * D * NL + lane
               : Jout + t * mstep + (size_t)jc * NL + lane;
  };
  auto hout_at = [&](int t, int i) {
    return hout + ((size_t)t * D + i) * NL + lane;
  };
  const double acc = filter_chain<D, DP, true>(
      T1, j, cj, hc, step, out, hout_at, vec ? (size_t)NL : (size_t)D * NL,
      j <= D);
  if (vec || (kWideChain<D> && j == 0)) ln[lane] = (float)acc;
}

// The factor pass's body, one thread per (step t, sequence b), b fastest.
// Inputs: P2, P3, as (T-1, d*d, B) streams per sequence (kShared false)
// or as (T-1, d*d) rows shared by the batch (kShared true); Jf (T-1, d*d,
// B) (P3's and Jf's lower triangles read), hf (T-1, d, B), eps (T-1, d,
// S*B). Outputs: the step's matrix Q_t = W_t P2_t^T (T-1, d*d, B) in Jf's
// layout and c (T-1, d, S*B), per sample s of sequence b (lane s*B + b)
// c = L^-T (L^-1 hf_t + eps_t) = W_t hf_t + L^-T eps_t, with L =
// chol(Jc_t), Jc_t = Jf_t - 2 P3_t and W_t = Jc_t^-1. A shared row is one
// address for every thread of a step, so a warp's threads (one or a few
// steps) read it as broadcasts.
template <int D, bool kShared>
__device__ __forceinline__ void sampler_fwd_factor(
    int B, int S, int T1, const float* __restrict__ P2,
    const float* __restrict__ P3, const float* __restrict__ Jf,
    const float* __restrict__ hf, const float* __restrict__ eps,
    float* __restrict__ Q, float* __restrict__ c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * B) return;
  const int t = idx / B;
  const int b = idx - t * B;
  const int SB = S * B;
  const size_t at = (size_t)t * D * D * B + b;
  // the step's pair entry k at pat + k * ps
  const size_t pat = kShared ? (size_t)t * D * D : at;
  const int ps = kShared ? 1 : B;
  using T = PassReal<D>;
  T L[D][D], rd[D], hv[D], y[D];
  factor_jc<D>(Jf + at, TwiceStream{P3 + pat, ps}, B, L, rd);
SVAE_PASS_UNROLL
  for (int i = 0; i < D; ++i) hv[i] = hf[((size_t)t * D + i) * B + b];
  solve_lower<D>(L, rd, hv, y);
  for (int s = 0; s < S; ++s) {
    const size_t v = (size_t)t * D * SB + s * B + b;
    T z[D], cv[D];
SVAE_PASS_UNROLL
    for (int i = 0; i < D; ++i) z[i] = y[i] + eps[v + (size_t)i * SB];
    solve_upper<D>(L, rd, z, cv);
SVAE_PASS_UNROLL
    for (int i = 0; i < D; ++i) c[v + (size_t)i * SB] = cv[i];
  }
  // Q = Jc^-1 P2^T, column k of it by two triangular solves against row
  // k of P2_t (fewer operations than W and a product, and no explicit
  // inverse's rounding)
#pragma unroll (Rows<D>::value)
  for (int k = 0; k < D; ++k) {
    T p[D], z[D], q[D];
SVAE_PASS_UNROLL
    for (int m = 0; m < D; ++m) p[m] = P2[pat + (size_t)(k * D + m) * ps];
    solve_lower<D>(L, rd, p, z);
    solve_upper<D>(L, rd, z, q);
SVAE_PASS_UNROLL
    for (int i = 0; i < D; ++i) Q[at + (size_t)(i * D + k) * B] = q[i];
  }
}

// The factor pass on per-sequence pairs (sampler_fwd_factor's streams).
template <int D>
__global__ void __launch_bounds__(kPassThreads)
sampler_bp_fwd_factor_kernel(int B, int S, int T1,
                             const float* __restrict__ P2,
                             const float* __restrict__ P3,
                             const float* __restrict__ Jf,
                             const float* __restrict__ hf,
                             const float* __restrict__ eps,
                             float* __restrict__ Q, float* __restrict__ c) {
  sampler_fwd_factor<D, false>(B, S, T1, P2, P3, Jf, hf, eps, Q, c);
}

// The factor pass on pair rows shared by the batch (sampler_fwd_factor's
// rows), the first pass of the shared-pair sampler.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
sampler_shared_factor_kernel(int B, int S, int T1,
                             const float* __restrict__ P2,
                             const float* __restrict__ P3,
                             const float* __restrict__ Jf,
                             const float* __restrict__ hf,
                             const float* __restrict__ eps,
                             float* __restrict__ Q, float* __restrict__ c) {
  sampler_fwd_factor<D, true>(B, S, T1, P2, P3, Jf, hf, eps, Q, c);
}

// One block of D threads per chain (sample s, sequence b), lane s*B + b,
// thread i owning row i, walking t = T-2 ... 0 from the terminal sample:
// x_t = c_t + Q_t x_{t+1}. Inputs: Q and c from the factor pass, xT (d,
// S*B). Output x (T-1, d, S*B).
template <int D>
__global__ void __launch_bounds__(32)
sampler_bp_fwd_chain_kernel(int B, int SB, int T1, const float* __restrict__ Q,
                            const float* __restrict__ c,
                            const float* __restrict__ xT,
                            float* __restrict__ x) {
  constexpr int R = kBpFwdRing;
  __shared__ __align__(16) float sx[2][D];
  const unsigned mask = chain_mask<D>();
  const int lane = blockIdx.x;
  const int i = threadIdx.x;
  const int b = lane % B;
  float xi = xT[i * SB + lane];
  // steps t-1 ... t-R+1 in flight while step t computes: slot u of a
  // ring in shared memory holds the thread's row i of Q_t and c_t[i]; a
  // thread copies and reads its own row alone, so a step waits on its own
  // copies (cp.async.wait_group) and takes no barrier for them. The copies
  // are unconditional, their sources stepping down one step a copy and
  // staying at step 0. (A ring of registers, loaded unconditionally, waited
  // on every load: nvcc moved each into its slot's register right after
  // issuing it, PERF.md §6.)
  __shared__ float ring[R][D][D + 1];
  const size_t qstep = (size_t)D * D * B, cstep = (size_t)D * SB;
  const float* qs = Q + ((size_t)(T1 - 1) * D * D + i * D) * B + b;
  const float* cs = c + ((size_t)(T1 - 1) * D + i) * SB + lane;
  const float* qlast = Q + (size_t)i * D * B + b;
  auto load = [&](int u) {
#pragma unroll
    for (int k = 0; k < D; ++k) cp_async4(&ring[u][i][k], qs + (size_t)k * B);
    cp_async4(&ring[u][i][D], cs);
    cp_async_commit();
    const bool more = qs != qlast;
    qs = more ? qs - qstep : qs;
    cs = more ? cs - cstep : cs;
  };
#pragma unroll
  for (int u = 0; u < R; ++u) load(u);
  for (int t0 = T1 - 1; t0 >= 0; t0 -= R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int t = t0 - u;
      if (t < 0) break;
      cp_async_wait<R - 1>();
      float Qr[D];
#pragma unroll
      for (int k = 0; k < D; ++k) Qr[k] = ring[u][i][k];
      const float ci = ring[u][i][D];
      // x_{t+1} into the buffer of the step's parity: the other one may
      // still be read by a thread in the step before (one barrier a step)
      float* sv = sx[t & 1];
      sv[i] = xi;
      load(u);  // step t-R into the slot just read
      __syncwarp(mask);
      // (Q_t x_{t+1})_i + c_t[i], in two partial sums to halve the
      // dependent adds
      float s0 = ci, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < D; k += 2) {
        s0 += Qr[k] * sv[k];
        if (k + 1 < D) s1 += Qr[k + 1] * sv[k + 1];
      }
      xi = s0 + s1;
      x[((size_t)t * D + i) * SB + lane] = xi;
    }
  }
  cp_async_wait<0>();
}

template <int D>
int launch_bidir_fwd(int NL, int T1, const float* J0, const float* h0,
                     const float* A, const float* C, const float* Dm,
                     const float* E, const float* F, const float* Pc,
                     float* J, float* h, float* ln, cudaStream_t stream) {
  dim3 grid((NL + kBidirChains - 1) / kBidirChains);
  bidir_fwd_kernel<D><<<grid, 32 * kBidirChains, 0, stream>>>(
      NL, T1, J0, h0, A, C, Dm, E, F, Pc, J, h, ln);
  return (int)cudaGetLastError();
}

// The factor pass on per-sequence pairs or (kShared) on shared rows.
template <int D, bool kShared>
int launch_sampler_bp_factor(int B, int S, int T1, const float* P2,
                             const float* P3, const float* Jf,
                             const float* hf, const float* eps, float* Q,
                             float* c, cudaStream_t stream) {
  const int n = T1 * B;
  const int blocks = (n + kPassThreads - 1) / kPassThreads;
  if (kShared)
    sampler_shared_factor_kernel<D><<<blocks, kPassThreads, 0, stream>>>(
        B, S, T1, P2, P3, Jf, hf, eps, Q, c);
  else
    sampler_bp_fwd_factor_kernel<D><<<blocks, kPassThreads, 0, stream>>>(
        B, S, T1, P2, P3, Jf, hf, eps, Q, c);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_bp_chain(int B, int SB, int T1, const float* Q,
                            const float* c, const float* xT, float* x,
                            cudaStream_t stream) {
  sampler_bp_fwd_chain_kernel<D><<<SB, D, 0, stream>>>(B, SB, T1, Q, c, xT,
                                                       x);
  return (int)cudaGetLastError();
}

template <int D, bool kShared>
int launch_sampler_bp_fwd(int B, int S, int T1, const float* P2,
                          const float* P3, const float* Jf, const float* hf,
                          const float* eps, const float* xT, float* Q,
                          float* c, float* x, cudaStream_t stream) {
  const int err = launch_sampler_bp_factor<D, kShared>(
      B, S, T1, P2, P3, Jf, hf, eps, Q, c, stream);
  if (err != 0) return err;
  return launch_sampler_bp_chain<D>(B, S * B, T1, Q, c, xT, x, stream);
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int SVAE_ENTRY(svae_bidir_fwd_f32)(int d, int NL, int T1, const float* J0,
                                  const float* h0, const float* A,
                                  const float* C, const float* Dm,
                                  const float* E, const float* F,
                                  const float* Pc, float* J, float* h,
                                  float* ln, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_BIDIR_FWD(DIM)                                                 \
  case DIM:                                                                 \
    return launch_bidir_fwd<DIM>(NL, T1, J0, h0, A, C, Dm, E, F, Pc, J, h, \
                                 ln, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_BIDIR_FWD)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_BIDIR_FWD
}

extern "C" int SVAE_ENTRY(svae_sampler_bp_fwd_f32)(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       float* Q, float* c, float* x,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                   \
  case DIM:                                                              \
    return launch_sampler_bp_fwd<DIM, false>(B, S, T1, P2, P3, Jf, hf,  \
                                             eps, xT, Q, c, x, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_sampler_bp_fwd_factor_f32)(int d, int B, int S, int T1,
                                              const float* P2,
                                              const float* P3,
                                              const float* Jf,
                                              const float* hf,
                                              const float* eps, float* Q,
                                              float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                 \
  case DIM:                                                            \
    return launch_sampler_bp_factor<DIM, false>(B, S, T1, P2, P3, Jf,  \
                                                hf, eps, Q, c, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_sampler_bp_fwd_chain_f32)(int d, int B, int S, int T1,
                                             const float* Q, const float* c,
                                             const float* xT, float* x,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_sampler_bp_chain<DIM>(B, S * B, T1, Q, c, xT, x, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

// The shared-pair sampler (P2, P3 (T-1, d*d) rows shared by the batch):
// its factor pass, then sampler_bp_fwd's chain pass on the per-sequence Q
// and per-lane c it writes (the caller's scratch), as
// svae_sampler_bp_fwd_f32 runs them.
extern "C" int SVAE_ENTRY(svae_sampler_shared_f32)(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       float* Q, float* c, float* x,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                   \
  case DIM:                                                              \
    return launch_sampler_bp_fwd<DIM, true>(B, S, T1, P2, P3, Jf, hf,   \
                                            eps, xT, Q, c, x, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int SVAE_ENTRY(svae_sampler_shared_factor_f32)(int d, int B, int S, int T1,
                                              const float* P2,
                                              const float* P3,
                                              const float* Jf,
                                              const float* hf,
                                              const float* eps, float* Q,
                                              float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                 \
  case DIM:                                                            \
    return launch_sampler_bp_factor<DIM, true>(B, S, T1, P2, P3, Jf,   \
                                               hf, eps, Q, c, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
