// Hopper kernels of the forward-only LDS E-step on pair potentials shared
// over the batch but varying in time: the forward and the backward
// information filter. (The backward conditional sampler on shared rows,
// which replaces svae_tpu/ops/pallas_kalman.py:_sampler_kernel, runs
// bpairs.cu's two sampler passes, whose chain pass it shares.)
//
// filter_shared_kernel<D> replaces
// svae_tpu/ops/pallas_kalman.py:_filter_kernel.
// backward_shared_kernel<D> replaces
// svae_tpu/ops/pallas_kalman.py:_backward_kernel.
//
// What bounds them on an H100. As in estep.cu and bpairs.cu, every lane is
// a serial chain of T-1 small dense steps, far fewer chains than the card
// holds threads (B = 64 filter chains at config 2): the latency of one chain's step bounds them, not bytes nor peak
// FLOP/s. What they read differs from bpairs.cu's: the pair blocks P1, P2,
// P3 and pc of step t are one (d*d) row shared by every lane, and only the
// node evidence (N1, N2) and the outputs are per lane, so a filter step
// moves 2 d^2 + 2d floats a lane (its node and its messages), not
// bpairs.cu's 3.5 d^2 + 3d.
//
// What the design does about it. Both filters are bidir_fwd's recursion
// with some operands shared, so they run its step (filter_chain.cuh): one
// warp per chain, a Gauss-Jordan elimination of [M | D_t^T | v] on the
// lanes a step.
//   forward:  A = -2 P3_t, C = -2 (P1_t + N1_{t+1}), D = P2_t, e = N2_{t+1},
//             f = 0, pc_t; t ascending from (J0, h0).
//   backward: A = -2 (P1_t + N1_{t+1}), C = -2 P3_t, D = P2_t^T, e = 0,
//             f = N2_{t+1}, no pc; t = T-2 ... 0 from the zero message.
// shared_filter<D, kBack>, the body of both kernels, is the step's reader
// for these operands: a ring of kSharedRing steps in shared memory, filled
// by cp.async, holds the coming steps' pair rows (A's and C's shared rows,
// D_t as a tile of padded rows, pc_t), copied once a block by all its
// threads, and each chain's node block: lane j < d copies column j of
// N1_{t+1}, the vector lane N2_{t+1}, and a lane reads the row and the
// lower triangle of N1 it also needs from the other lanes' columns. A step
// waits for its own copies (cp.async.wait_group), takes one block barrier,
// and issues the copies of the step kSharedRing - 1 ahead into the slot
// the step before read; the copies are unconditional (the step clamped at
// the chain's end) and their sources step one row a step, as in hmm_fb.cu
// (a register ring's loads wait for the move that nvcc puts right after
// them: hmm_fb.cu's, and bidir_fwd's one-step register prefetch, in their
// SASS). A block runs kSharedChains chains, which share the slot's pair
// rows: one (chip_variants.py and chip_ab.py: two ran the forward 6-8%
// faster at d=10 and d=3 but 1-5% slower at d=2, 4, 8 and 16, spilled at
// d=4, and ran the backward 3% slower; four were slower than either). With
// the loads off the chain (ring depths 2 to 8 within 4%), a step costs its
// instructions: ~1,050 a step forward, ~980 backward, against bidir_fwd's
// ~945 (PERF.md §6). Node streams and outputs keep the lane innermost
// ((T-1, m, lanes)). T and B are runtime arguments; d is a template
// parameter, so every loop unrolls. A failed pivot gives NaN, which reaches
// every later output of the lane (and the forward's ln); the wrappers'
// callers check finiteness once.

#include "filter_chain.cuh"

namespace {

// How many chains (warps) a block of the shared-pair filters runs, and how
// many steps its ring holds (chip_variants.py).
constexpr int kSharedChains = 1;
constexpr int kSharedRing = 4;

// One step of the ring: the step's pair rows, read by every chain of the
// block, and each chain's node entries: lane j < d copies column j of N1
// to n[c][.][j], the vector lane N2 to n[c][.][d] (lane 0 at d = 32, where
// no lane is left), and a lane reads its row of N1 from the other lanes'
// columns.
template <int D>
struct __align__(16) SharedSlot {
  static constexpr int DP = (D + 3) & ~3;  // the D tile's row stride
  // D_t, row i at i * DP (16-byte aligned for row_dot's float4 reads; the
  // padding is never copied to nor read into a product)
  float Dt[D * DP];
  float A[D * D];  // A's shared row: P3_t forward, P1_t backward
  float C[D * D];  // C's shared row: P1_t forward, P3_t backward
  float pc;
  float n[kSharedChains][D][D + 1];
};

// One warp per sequence b, kSharedChains a block, on filter_chain.cuh's
// step (forward: kBack false; backward: true, walking t = T1-1 ... 0); the
// body of filter_shared_kernel and backward_shared_kernel below.
// Layouts: J0 (d*d, B), h0 (d, B) (forward only); PA, PC, P2 (T1, d*d)
// (PA = P3, PC = P1 forward; PA = P1, PC = P3 backward), Pc (T1) (forward
// only); N1 (T1, d*d, B), N2 (T1, d, B) (row t holds node t+1); out J
// (T1, d*d, B), h (T1, d, B) (forward: row t is frame t+1; backward: frame
// t), ln (B) (forward only). J0 and PA are read as their lower triangles,
// PC and N1 in full.
template <int D, bool kBack>
__device__ __forceinline__ void shared_filter(
    int B, int T1, const float* __restrict__ J0, const float* __restrict__ h0,
    const float* __restrict__ PA, const float* __restrict__ P2,
    const float* __restrict__ PC, const float* __restrict__ Pc,
    const float* __restrict__ N1, const float* __restrict__ N2,
    float* __restrict__ Jout, float* __restrict__ hout,
    float* __restrict__ ln) {
  using Slot = SharedSlot<D>;
  constexpr bool kWide = kWideChain<D>;
  // d = 32: a ring of 2 slots (33 KB), under the 48 KB of static shared
  // memory
  constexpr int DD = D * D, DP = Slot::DP, R = kWide ? 2 : kSharedRing;
  constexpr int NT = 32 * kSharedChains;  // the block's threads
  static_assert(R >= 2, "the ring holds the step read and one in flight");
  __shared__ Slot ring[R];
  const int tid = threadIdx.x;
  const int w = tid / 32, j = tid % 32;
  // a warp past the batch shadows its last chain and stores nothing: its
  // threads take every barrier and copy their share of the pair rows
  const bool live = blockIdx.x * kSharedChains + w < B;
  const int b = live ? blockIdx.x * kSharedChains + w : B - 1;
  const bool vec = j == D;           // the lane of the vector column
  const int jc = j < D ? j : D - 1;  // the column a lane holds (clamped)
  const int jn = j < D ? j : D;      // the node column a lane reads
  // entry i of column jc of a symmetric block, from its lower triangle
  auto lo = [&](int i) { return i > jc ? i * D + jc : jc * D + i; };

  // The copies step down the rows one step a copy and stay at the chain's
  // last (ascending forward, descending backward): the pair row r, and a
  // lane's node column, N1's column j (stride D*B) or N2 (stride B).
  const int dir = kBack ? -1 : 1;
  int r = kBack ? T1 - 1 : 0;
  const int rlast = kBack ? 0 : T1 - 1;
  const long long nstep = vec ? (long long)D * B : (long long)DD * B;
  const float* nsrc = (vec ? N2 : N1 + (long long)jc * B) + b +
                      (kBack ? (T1 - 1) * nstep : 0);
  const float* nlast = (vec ? N2 : N1 + (long long)jc * B) + b +
                       (kBack ? 0 : (T1 - 1) * nstep);
  const long long nstride = vec ? (long long)B : (long long)D * B;
  // d = 32: N2's column, which lane 0 copies beside its own, stepping with
  // nsrc
  const float* n2src =
      N2 + b + (kBack ? (T1 - 1) * (long long)D * B : 0);
  int u = 0;  // the slot the next copies go to
  auto load = [&]() {
    Slot& sl = ring[u];
    const long long prow = (long long)r * DD;
#pragma unroll
    for (int q = 0; q < (DD + NT - 1) / NT; ++q) {
      const int k = tid + q * NT;
      if (k < DD) {
        const int i = k / D, c = k % D;  // D_t's entry (i, c)
        cp_async4(&sl.A[k], PA + prow + k);
        cp_async4(&sl.C[k], PC + prow + k);
        cp_async4(&sl.Dt[i * DP + c], P2 + prow + (kBack ? c * D + i : k));
      }
    }
    if (!kBack && tid == 0) cp_async4(&sl.pc, Pc + r);
    if (j <= D) {
#pragma unroll
      for (int i = 0; i < D; ++i)
        cp_async4(&sl.n[w][i][j], nsrc + i * nstride);
    }
    if constexpr (kWide) {
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < D; ++i)
          cp_async4(&sl.n[w][i][D], n2src + (long long)i * B);
      }
      n2src = nsrc == nlast ? n2src : n2src + dir * (long long)D * B;
    }
    cp_async_commit();
    r = r == rlast ? r : r + dir;
    nsrc = nsrc == nlast ? nsrc : nsrc + dir * nstep;
    u = u == R - 1 ? 0 : u + 1;
  };

  // steps 0 ... R-2 in flight before the first
#pragma unroll
  for (int s = 0; s < R - 1; ++s) load();

  // lane j < D: column j of the carried J; lane D: the carried h (the
  // backward starts from the zero message)
  float cj[D], hc[kWide ? D : 1];  // d = 32: the carried h on every lane
#pragma unroll
  for (int i = 0; i < D; ++i) {
    cj[i] = kBack ? 0.f
                  : vec ? h0[(size_t)i * B + b] : J0[(size_t)lo(i) * B + b];
    if constexpr (kWide) hc[i] = kBack ? 0.f : h0[(size_t)i * B + b];
  }

  // the reader: wait for step s's copies, one barrier (every thread's
  // copies land, and every thread is done with step s-1's slot), the
  // copies of step s+R-1 into that slot, then the operands from step s's
  auto step = [&](int s, FilterOperands<D>& op) -> const float* {
    cp_async_wait<R - 2>();
    __syncthreads();
    load();
    const Slot& sl = ring[s % R];
    const float(&n)[D][D + 1] = sl.n[w];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      // N1 at (i, jc) and (jc, i) (the vector lane: N2's entry i), and at
      // lo(i)
      const float nc = n[i][jn], nr = n[jc][i];
      const float nl = i > jc ? nc : nr;
      const float ca = sl.C[i * D + jc], cr = sl.C[jc * D + i];
      op.A[i] = kBack ? -2.f * (sl.A[lo(i)] + nl) : -2.f * sl.A[lo(i)];
      op.Dr[i] = vec ? (kBack ? nc : 0.f) : sl.Dt[jc * DP + i];
      op.Cc[i] = kBack ? -2.f * ca : -2.f * (ca + nc);
      op.Cr[i] = vec ? (kBack ? 0.f : nc)
                     : kBack ? -2.f * cr : -2.f * (cr + nr);
    }
    op.pc = kBack ? 0.f : sl.pc;
    if constexpr (kWide) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        op.f[i] = kBack ? n[i][D] : 0.f;
        op.e[i] = kBack ? 0.f : n[i][D];
      }
    }
    return sl.Dt;
  };
  auto out = [&](int s) {
    const size_t t = kBack ? T1 - 1 - s : s;
    return vec ? hout + t * D * B + b : Jout + t * DD * B + (size_t)jc * B + b;
  };
  auto hout_at = [&](int s, int i) {
    const size_t t = kBack ? T1 - 1 - s : s;
    return hout + (t * D + i) * B + b;
  };
  const double acc = filter_chain<D, DP, !kBack>(
      T1, j, cj, hc, step, out, hout_at, vec ? (size_t)B : (size_t)D * B,
      live && j <= D);
  cp_async_wait<0>();
  if (!kBack && live && (vec || (kWide && j == 0))) ln[b] = (float)acc;
}

// The forward information filter: per step t (the pair row t, the node
// t+1), M = J - 2 P3_t, J' = -2 P1_t - 2 N1_{t+1} - P2_t M^-1 P2_t^T,
// h' = P2_t M^-1 h + N2_{t+1}, ln += d/2 log 2pi - 1/2 log|M| +
// 1/2 h^T M^-1 h + pc_t. Layouts: J0 (d*d, B), h0 (d, B); P1, P2, P3
// (T1, d*d), Pc (T1); N1 (T1, d*d, B), N2 (T1, d, B); out J (T1, d*d, B),
// h (T1, d, B) (row t is frame t+1), ln (B).
template <int D>
__global__ void __launch_bounds__(32 * kSharedChains)
filter_shared_kernel(int B, int T1, const float* __restrict__ J0,
                     const float* __restrict__ h0,
                     const float* __restrict__ P1,
                     const float* __restrict__ P2,
                     const float* __restrict__ P3,
                     const float* __restrict__ Pc,
                     const float* __restrict__ N1,
                     const float* __restrict__ N2, float* __restrict__ Jout,
                     float* __restrict__ hout, float* __restrict__ ln) {
  shared_filter<D, false>(B, T1, J0, h0, P3, P2, P1, Pc, N1, N2, Jout, hout,
                          ln);
}

// The backward information filter, walking t = T1-1 ... 0 from the zero
// message (the beta message of frame T-1): M = Jb_{t+1} - 2 P1_t -
// 2 N1_{t+1}, Jb_t = -2 P3_t - P2_t^T M^-1 P2_t, hb_t = P2_t^T M^-1
// (hb_{t+1} + N2_{t+1}). Layouts: P1, P2, P3 (T1, d*d); N1 (T1, d*d, B),
// N2 (T1, d, B); out J (T1, d*d, B), h (T1, d, B) (row t is frame t).
template <int D>
__global__ void __launch_bounds__(32 * kSharedChains)
backward_shared_kernel(int B, int T1, const float* __restrict__ P1,
                       const float* __restrict__ P2,
                       const float* __restrict__ P3,
                       const float* __restrict__ N1,
                       const float* __restrict__ N2,
                       float* __restrict__ Jout, float* __restrict__ hout) {
  shared_filter<D, true>(B, T1, nullptr, nullptr, P1, P2, P3, nullptr, N1,
                         N2, Jout, hout, nullptr);
}

template <int D>
int launch_filter_shared(int B, int T1, const float* J0, const float* h0,
                         const float* P1, const float* P2, const float* P3,
                         const float* Pc, const float* N1, const float* N2,
                         float* J, float* h, float* ln, cudaStream_t stream) {
  dim3 grid((B + kSharedChains - 1) / kSharedChains);
  filter_shared_kernel<D><<<grid, 32 * kSharedChains, 0, stream>>>(
      B, T1, J0, h0, P1, P2, P3, Pc, N1, N2, J, h, ln);
  return (int)cudaGetLastError();
}

template <int D>
int launch_backward_shared(int B, int T1, const float* P1, const float* P2,
                           const float* P3, const float* N1, const float* N2,
                           float* J, float* h, cudaStream_t stream) {
  dim3 grid((B + kSharedChains - 1) / kSharedChains);
  backward_shared_kernel<D><<<grid, 32 * kSharedChains, 0, stream>>>(
      B, T1, P1, P2, P3, N1, N2, J, h);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int SVAE_ENTRY(svae_filter_shared_f32)(int d, int B, int T1, const float* J0,
                                      const float* h0, const float* P1,
                                      const float* P2, const float* P3,
                                      const float* Pc, const float* N1,
                                      const float* N2, float* J, float* h,
                                      float* ln, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_FILTER_SHARED(DIM)                                          \
  case DIM:                                                              \
    return launch_filter_shared<DIM>(B, T1, J0, h0, P1, P2, P3, Pc, N1, \
                                     N2, J, h, ln, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_FILTER_SHARED)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_FILTER_SHARED
}

extern "C" int SVAE_ENTRY(svae_backward_shared_f32)(int d, int B, int T1,
                                        const float* P1, const float* P2,
                                        const float* P3, const float* N1,
                                        const float* N2, float* J, float* h,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_BACKWARD_SHARED(DIM)                                            \
  case DIM:                                                                  \
    return launch_backward_shared<DIM>(B, T1, P1, P2, P3, N1, N2, J, h, s);
  switch (d) {
    SVAE_BUILT_DIMS(SVAE_BACKWARD_SHARED)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_BACKWARD_SHARED
}
