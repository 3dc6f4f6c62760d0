// Hopper kernels of the LDS E-step on per-sequence ("bpairs") pair
// potentials: the generic bidirectional information filter and the
// backward conditional sampler, both reading their pair blocks as streams.
//
// bidir_fwd_kernel<D> replaces svae_tpu/ops/pallas_bidir.py:_bidir_fwd_kernel.
// sampler_bp_fwd_kernel<D> replaces
// svae_tpu/ops/pallas_vjp.py:_sampler_fwd_kernel.
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
// filter_fwd design, one warp per chain: lane j < d holds column j of M and
// row j of D_t (column j of D_t^T), lane d the vector v = h + f_t, and a
// step is a Gauss-Jordan elimination of the tile [M | D_t^T | v] over d
// rounds of pivot-column shuffles, which leaves X = M^-1 [D_t^T | v] on the
// lanes. Then column j of J' = C_t - D_t X_D goes on lane j, which already
// holds the column that the next step's M reads, h' = D_t X_v + e_t on lane
// d, and ln gains d/2 log 2pi - 1/2 sum log p_k + 1/2 v . X_v + pc_t, the
// log sum over the warp off the chain, summed in double on the vector
// lane. A non-positive pivot gives a NaN reciprocal, which poisons the
// step's J, h and the chain's ln.
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
// The sampler (one thread per chain, unchanged here) reads the pairs at
// sequence lane % B. T and the lane counts are runtime arguments (the
// length buckets and a tail batch vary them); only d is a template
// parameter, so the steps' loops unroll. There is no lane or time padding:
// every stream row is a real step.

#include "estep_common.cuh"

namespace {

// How many chains (one warp each) a block of bidir_fwd_kernel runs.
constexpr int kBidirChains = 1;

// One warp per lane (chain) l of the NL lanes, kBidirChains a block. Per
// stream row t: the Gauss-Jordan elimination of [M | D_t^T | v], M = J +
// A_t, v = h + f_t, gives X = M^-1 [D_t^T | v]; then J' = C_t - D_t X_D,
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
  static_assert(D + 1 <= 32, "a chain's columns must fit one warp");
  constexpr int DD = D * D;
  constexpr int DP = (D + 3) & ~3;  // the D tile's row stride, for float4
  constexpr unsigned kAll = 0xffffffffu;
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

  // lane j < D: column j of the carried J; lane D: the carried h
  float cj[D];
#pragma unroll
  for (int i = 0; i < D; ++i)
    cj[i] = vec ? h0[i * NL + lane] : J0[lo(i) + lane];

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
  // the chain's ln, on the vector lane, summed in double: a float sum of
  // T-1 terms would round at the sum's magnitude every step
  double acc = 0.0;

#pragma unroll 1
  for (int t = 0; t < T1; ++t) {
    float Ar[D], Dr[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      Ar[i] = nA[i];
      Dr[i] = nR[i];
    }
    // what the step reads at its end: column jc of C_t in full (Cc), the
    // row of C_t that holds the column's lower triangle above the
    // diagonal (the vector lane: e_t) (Cr), and pc_t
    float Cc[D], Cr[D];
    const float* c = C + t * mstep + lane;
    const float* cr = Crow + t * rstep;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      Cc[i] = c[(size_t)(i * D + jc) * NL];
      Cr[i] = cr[(size_t)i * NL];
    }
    const float pc = Pc[(size_t)t * NL + lane];
    load(t + 1);
    float* sDt = sD + (t & 1) * D * DP;
    if (j < D) {
#pragma unroll
      for (int i = 0; i < D; ++i) sDt[j * DP + i] = Dr[i];
    }
    // (one barrier a step: the tile written here was last read two steps
    // ago, before every lane passed the previous step's barrier)
    __syncwarp();

    float m[D], x[D], v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      m[i] = cj[i] + Ar[i];
      v[i] = cj[i] + Dr[i];  // the vector lane's h + f
      x[i] = vec ? v[i] : Dr[i];
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
    }

    // y = D_t X, column j of it on lane j
    float y[D], q = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y[i] = row_dot<D, DP>(sDt + i * DP, x);
      q += v[i] * x[i];
    }
    acc += 0.5f * D * kLog2Pi - 0.5f * warp_log_sum(pj) + 0.5f * q + pc;

    // lane j < D writes column j of J' in full and carries its lower
    // triangle; the vector lane writes and carries h'
    float* out = vec ? hout + (size_t)t * D * NL + lane
                     : Jout + t * mstep + (size_t)jc * NL + lane;
    const size_t ostep = vec ? (size_t)NL : (size_t)D * NL;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float o = vec ? y[i] + Cr[i] : Cc[i] - y[i];
      cj[i] = vec || i >= jc ? o : Cr[i] - y[i];
      if (j <= D) out[i * ostep] = o;
    }
  }
  if (vec) ln[lane] = (float)acc;
}

// One thread per (sample s, sequence b), lane s*B + b, walking
// t = T1-1 ... 0 from the terminal sample xT. Per step:
//   Jc = Jf_t - 2 P3_t, L = chol(Jc),
//   x_t = L^-T (L^-1 (hf_t + P2_t^T x_{t+1}) + eps_t).
// Pairs and messages are read at sequence b = lane % B, not tiled S times.
// Layouts: P2, P3, Jf (T1, d*d, B), hf (T1, d, B); eps (T1, d, S*B),
// xT (d, S*B); out x (T1, d, S*B).
template <int D>
__global__ void __launch_bounds__(kThreads)
sampler_bp_fwd_kernel(int B, int SB, int T1, const float* __restrict__ P2,
                      const float* __restrict__ P3,
                      const float* __restrict__ Jf,
                      const float* __restrict__ hf,
                      const float* __restrict__ eps,
                      const float* __restrict__ xT,
                      float* __restrict__ xout) {
  constexpr int DD = D * D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= SB) return;
  const int b = lane % B;

  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = xT[i * SB + lane];

  for (int t = T1 - 1; t >= 0; --t) {
    const size_t mat = (size_t)t * DD * B + b;
    float L[D][D], rd[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const size_t k = mat + (size_t)(i * D + j) * B;
        L[i][j] = Jf[k] - 2.f * P3[k];
      }
    }
    chol_inplace<D>(L, rd);

    float y[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = hf[((size_t)t * D + i) * B + b];
#pragma unroll
      for (int k = 0; k < D; ++k) s += P2[mat + (size_t)(k * D + i) * B] * x[k];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
      y[i] = s * rd[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] += eps[((size_t)t * D + i) * SB + lane];
#pragma unroll
    for (int i = D - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < D; ++k) s -= L[k][i] * x[k];
      x[i] = s * rd[i];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) xout[((size_t)t * D + i) * SB + lane] = x[i];
  }
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

template <int D>
int launch_sampler_bp_fwd(int B, int S, int T1, const float* P2,
                          const float* P3, const float* Jf, const float* hf,
                          const float* eps, const float* xT, float* x,
                          cudaStream_t stream) {
  const int SB = S * B;
  dim3 grid((SB + kThreads - 1) / kThreads);
  sampler_bp_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      B, SB, T1, P2, P3, Jf, hf, eps, xT, x);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after the
// launch (0 on success); an unsupported d returns cudaErrorInvalidValue.
extern "C" int svae_bidir_fwd_f32(int d, int NL, int T1, const float* J0,
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
    SVAE_BIDIR_FWD(2)
    SVAE_BIDIR_FWD(3)
    SVAE_BIDIR_FWD(4)
    SVAE_BIDIR_FWD(8)
    SVAE_BIDIR_FWD(10)
    SVAE_BIDIR_FWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_BIDIR_FWD
}

extern "C" int svae_sampler_bp_fwd_f32(int d, int B, int S, int T1,
                                       const float* P2, const float* P3,
                                       const float* Jf, const float* hf,
                                       const float* eps, const float* xT,
                                       float* x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_SAMPLER_BP_FWD(DIM)                                            \
  case DIM:                                                                 \
    return launch_sampler_bp_fwd<DIM>(B, S, T1, P2, P3, Jf, hf, eps, xT, x, \
                                      s);
  switch (d) {
    SVAE_SAMPLER_BP_FWD(2)
    SVAE_SAMPLER_BP_FWD(3)
    SVAE_SAMPLER_BP_FWD(4)
    SVAE_SAMPLER_BP_FWD(8)
    SVAE_SAMPLER_BP_FWD(10)
    SVAE_SAMPLER_BP_FWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_SAMPLER_BP_FWD
}
