// Hopper kernels of the packed stationary LDS E-step: the bidirectional
// information filter and the backward conditional sampler.
//
// filter_fwd_kernel<D> replaces
// svae_tpu/ops/pallas_estep.py:_filter_fwd_kernel;
// sampler_fwd_factor_kernel<D> and sampler_fwd_chain_kernel<D> together
// replace svae_tpu/ops/pallas_estep.py:_sampler_fwd_kernel.
//
// What bounds them on an H100. Each sequence is a serial chain of T-1
// small dense steps, so a step cannot start before the one before it ends.
// At the main-path shape (B=64, T=100, d=10) the filter has 2B = 128
// chains and the sampler S*B = 128; the functions' bytes bound them at a
// few microseconds (chip_smoke.bound), far below what the serial chains
// allow, so what a design can cut is the time of one chain's step. The
// one-thread-per-chain kernels these replace ran a step's d x d Cholesky
// factor, d-column triangular solve and rank-d update one after the other
// on one thread (4 blocks of 32 threads at config 2): 4.3 us a filter step
// and 2.4 us a sampler step, with 228 and 64 bytes of spills at d=10.
//
// What the design does about it.
//
// The filter's factorization cannot leave its chain: the step's M = J + A
// depends on the carried J. So each chain runs on one warp, 128 warps at
// config 2, and a step is spread over the warp's lanes: lane j < d holds
// column j of M and column j of D^T, lane d the vector v = h (+ f), and the
// step is a Gauss-Jordan elimination of the tile [M | D^T | v], d rounds,
// each of which broadcasts the pivot column by shuffles and updates every
// lane's two columns at once. It leaves X = M^-1 [D^T | v] on the lanes,
// and its pivots are those of LDL^T (M is SPD, so no row is exchanged and
// each pivot is a positive Schur complement). The outputs are one product
// a lane: column j of J' = C - D X_D on lane j (D in shared memory, read
// as broadcasts, four floats at a time) and h' = D X_v on lane d, which
// leaves the carry where the next step reads it; logdet M = sum log p_k
// (one logf a lane and a butterfly sum, off the chain), the quadratic term
// is v . X_v, and the chain's ln sums the steps in double. A non-positive
// pivot gives a NaN reciprocal, which poisons the tile and so the step's
// J, h and the chain's ln, as the factor's sqrt does in the other
// kernels. A step is then one warp's stream of some 900 instructions (d
// rounds of d shuffles and 2d FMAs, the product, the stores), and on an
// H100 the warp issues them at 2-3 cycles each: what bounds the step now
// is that stream, not the chain's arithmetic latency nor the card's
// bytes. Other designs of the step were measured slower at config 2 and
// not kept (PERF.md §6): the same rounds as a Cholesky factor of the
// tile, the factor on every lane with a column of the solve on each, 2 or
// 4 chains a block against 1, two-by-two pivot blocks, the tile split one
// column a lane, and a deeper ring of prefetched evidence. The coming
// frame's node evidence is loaded a step ahead, unconditionally (the frame
// clamped), since a load under a condition compiles to a move that waits
// for it at once.
//
// The sampler's factorization depends neither on the carried sample nor on
// the sample s, so it leaves the chain. With W_t = Jc_t^-1 and L_t =
// chol(Jc_t), Jc_t = Jf_t - 2 P3, a step is
//   x_t = W_t (hf_t + P2^T x_{t+1}) + L_t^-T eps_t = c_t + W_t P2^T x_{t+1},
//   c_t = L_t^-T (L_t^-1 hf_t + eps_t).
// 1. sampler_fwd_factor_kernel runs one thread per (step, sequence), 6,336
//    at config 2: it factors Jc once for the S samples (not S times), writes
//    W in Jf's lane-minor layout and c per sample, the stores of a warp
//    coalesced. W is sampler_adj_factor_kernel's own (adj_passes.cuh).
// 2. sampler_fwd_chain_kernel runs one chain per block of d threads, thread
//    i owning row i: a step is two matrix-vector products, P2^T x_{t+1} and
//    W_t times it, with the vectors passed through shared memory, and the
//    coming steps' rows of W and c in a ring of registers, loaded
//    unconditionally.
// svae_sampler_fwd_f32 launches the two, one after the other, with W and c
// as the caller's scratch.
//
// D is a template parameter so every loop is unrolled and every register
// array index a constant.

#include "adj_passes.cuh"

namespace {

// How many steps ahead the filter and the sampler chain load.
constexpr int kFilterRing = 1;
constexpr int kSamplerRing = 4;

// One warp per chain (sequence b, direction r): lane r*B + b of the
// outputs. Per step t, a Gauss-Jordan elimination of the tile [M | D_r^T |
// v], M = J + A_r (+ diag jv backward), v = h (+ nv backward), gives X =
// M^-1 [D_r^T | v]; then J' = C_r - D_r X_D (+ diag jv forward), h' = D_r
// X_v (+ nv forward), ln += d/2 log 2pi - 1/2 sum log p_k + 1/2 v . X_v.
// Forward chains read frame t+1, backward chains frame T-1-t (the
// time-reversed filter). Layouts: J0 (d*d, 2B), h0 (d, 2B); A, C, D (2, d,
// d); jd, n2 (T, d, B); out J (T-1, d*d, 2B), the lower triangle mirrored,
// h (T-1, d, 2B), ln (2B). One warp a block, blockIdx.x the sequence and
// blockIdx.y the direction. A, C, J0 are read as their lower triangles.
template <int D>
__global__ void __launch_bounds__(32)
filter_fwd_kernel(int B, int T, const float* __restrict__ J0,
                  const float* __restrict__ h0, const float* __restrict__ A,
                  const float* __restrict__ C, const float* __restrict__ Dm,
                  const float* __restrict__ jd, const float* __restrict__ n2,
                  float* __restrict__ Jout, float* __restrict__ hout,
                  float* __restrict__ ln) {
  static_assert(D + 1 <= 32, "a chain's columns must fit one warp");
  constexpr int DD = D * D;
  constexpr int DP = (D + 3) & ~3;  // sD's row stride, for float4 reads
  constexpr int Q = kFilterRing;
  constexpr unsigned kAll = 0xffffffffu;
  const int r = blockIdx.y;
  const int b = blockIdx.x;
  __shared__ __align__(16) float sD[D * DP];
  for (int k = threadIdx.x; k < D * DP; k += 32)
    sD[k] = k % DP < D ? Dm[r * DD + k / DP * D + k % DP] : 0.f;
  __syncthreads();
  const int NL = 2 * B, T1 = T - 1;
  const int lane = r * B + b;
  const int j = threadIdx.x;
  const bool vec = j == D;           // the lane of the vector column
  const int jc = j < D ? j : D - 1;  // the column a lane reads (clamped)
  const float* a = A + r * DD;
  const float* c = C + r * DD;

  // lane j < D: column j of A_r, C_r and D_r^T (row j of D_r) and of the
  // carried J; lane D: the carried h in cj
  float Ac[D], Cc[D], Dr[D], cj[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const int lo = i > jc ? i * D + jc : jc * D + i;
    Ac[i] = a[lo];
    Cc[i] = c[lo];
    Dr[i] = sD[jc * DP + i];
    cj[i] = vec ? h0[i * NL + lane] : J0[lo * NL + lane];
  }

  // the node evidence of steps t+1 ... t+Q in flight while step t
  // computes: lane j's entry (clamped) of jd and n2 of the step's frame,
  // the loop unrolled by Q so that every slot index is a constant. (The
  // loads are unconditional, the step clamped to T-2: a load under a
  // condition leaves its slot's register to merge two values, and the
  // move that merges them waits for the load at once.)
  float njv[Q], nnv[Q];
  auto load = [&](int t, int u) {
    t = t < T1 ? t : T1 - 1;
    const int frame = r == 0 ? t + 1 : T - 1 - t;
    njv[u] = jd[(frame * D + jc) * B + b];
    nnv[u] = n2[(frame * D + jc) * B + b];
  };
#pragma unroll
  for (int u = 0; u < Q; ++u) load(u, u);
  // the chain's ln, on the vector lane, summed in double: a float sum of
  // T-1 terms would round at the sum's magnitude every step
  double acc = 0.0;

#pragma unroll 1
  for (int t0 = 0; t0 < T1; t0 += Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int t = t0 + u;
      if (t >= T1) break;
      const float jv = njv[u];
      float nv[D];
#pragma unroll
      for (int i = 0; i < D; ++i) nv[i] = __shfl_sync(kAll, nnv[u], i);
      load(t + Q, u);

      float m[D], x[D], v[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        m[i] = cj[i] + Ac[i] + (r == 1 && i == j ? jv : 0.f);
        v[i] = cj[i] + (r == 1 ? nv[i] : 0.f);
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

      // y = D_r X, column j of it on lane j
      float y[D], q = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        y[i] = row_dot<D, DP>(sD + i * DP, x);
        q += v[i] * x[i];
      }
      acc += 0.5f * D * kLog2Pi - 0.5f * warp_log_sum(pj) + 0.5f * q;
#pragma unroll
      for (int i = 0; i < D; ++i)
        cj[i] = vec ? y[i] + (r == 0 ? nv[i] : 0.f)
                    : Cc[i] - y[i] + (r == 0 && i == j ? jv : 0.f);

      if (j < D) {
        // column j's lower part, and its mirror into row j
        float* Jt = Jout + (size_t)t * DD * NL + lane;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          if (i >= j) Jt[(i * D + j) * NL] = cj[i];
          if (i > j) Jt[(j * D + i) * NL] = cj[i];
        }
      } else if (vec) {
        float* ht = hout + (size_t)t * D * NL + lane;
#pragma unroll
        for (int i = 0; i < D; ++i) ht[i * NL] = cj[i];
      }
    }
  }
  if (vec) ln[lane] = (float)acc;
}

// One thread per (step t, sequence b), b fastest. Inputs: P3 (d, d), Jf
// (T-1, d*d, B), hf (T-1, d, B), eps (T-1, d, S*B). Outputs: W (T-1, d*d,
// B), the inverse of Jc = Jf_t - 2 P3 (whose lower triangle is factored)
// in Jf's layout, and c (T-1, d, S*B), per sample s of sequence b (lane
// s*B + b) c = L^-T (L^-1 hf_t + eps_t) = W hf_t + L^-T eps_t.
template <int D>
__global__ void __launch_bounds__(kPassThreads)
sampler_fwd_factor_kernel(int B, int S, int T1, const float* __restrict__ P3,
                          const float* __restrict__ Jf,
                          const float* __restrict__ hf,
                          const float* __restrict__ eps,
                          float* __restrict__ W, float* __restrict__ c) {
  constexpr int DD = D * D;
  __shared__ float s2P3[DD];
  for (int k = threadIdx.x; k < DD; k += blockDim.x) s2P3[k] = 2.f * P3[k];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= T1 * B) return;
  const int t = idx / B;
  const int b = idx - t * B;
  const int SB = S * B;
  float L[D][D], rd[D], hv[D], y[D];
  factor_jc<D>(Jf + (size_t)t * DD * B + b, s2P3, B, L, rd);
#pragma unroll
  for (int i = 0; i < D; ++i) hv[i] = hf[((size_t)t * D + i) * B + b];
  solve_lower<D>(L, rd, hv, y);
  for (int s = 0; s < S; ++s) {
    const size_t at = (size_t)t * D * SB + s * B + b;
    float z[D], cv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) z[i] = y[i] + eps[at + (size_t)i * SB];
    solve_upper<D>(L, rd, z, cv);
#pragma unroll
    for (int i = 0; i < D; ++i) c[at + (size_t)i * SB] = cv[i];
  }
  store_inverse<D>(L, rd, W + (size_t)t * DD * B + b, B);
}

// One block of D threads per chain (sample s, sequence b), lane s*B + b,
// thread i owning row i, walking t = T-2 ... 0 from the terminal sample:
// x_t = c_t + W_t (P2^T x_{t+1}). Inputs: W and c from
// sampler_fwd_factor_kernel, P2 (d, d), xT (d, S*B). Output x (T-1, d,
// S*B).
template <int D>
__global__ void __launch_bounds__(32)
sampler_fwd_chain_kernel(int B, int SB, int T1, const float* __restrict__ W,
                         const float* __restrict__ c,
                         const float* __restrict__ P2,
                         const float* __restrict__ xT,
                         float* __restrict__ x) {
  constexpr int Q = kSamplerRing;
  __shared__ __align__(16) float sx[D];
  __shared__ __align__(16) float sy[D];
  const unsigned mask = chain_mask<D>();
  const int lane = blockIdx.x;
  const int i = threadIdx.x;
  const int b = lane % B;
  float p2[D];  // column i of P2
#pragma unroll
  for (int k = 0; k < D; ++k) p2[k] = P2[k * D + i];
  // steps t-1 ... t-Q in flight while step t computes: a ring of Q
  // register slots (row i of W_t and c_t[i]), the loop unrolled by Q so
  // that every slot index is a constant; the loads unconditional, the step
  // clamped to 0
  float nW[Q][D], nc[Q];
  auto load = [&](int t, int u) {
    t = t > 0 ? t : 0;
#pragma unroll
    for (int k = 0; k < D; ++k)
      nW[u][k] = W[((size_t)t * D * D + i * D + k) * B + b];
    nc[u] = c[((size_t)t * D + i) * SB + lane];
  };
#pragma unroll
  for (int u = 0; u < Q; ++u) load(T1 - 1 - u, u);
  float xi = xT[i * SB + lane];
  for (int t0 = T1 - 1; t0 >= 0; t0 -= Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int t = t0 - u;
      if (t < 0) break;
      float Wr[D];
#pragma unroll
      for (int k = 0; k < D; ++k) Wr[k] = nW[u][k];
      const float ci = nc[u];
      sx[i] = xi;  // x_{t+1}
      load(t - Q, u);
      __syncwarp(mask);
      // (P2^T x_{t+1})_i, in two partial sums to halve the dependent adds
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < D; k += 2) {
        s0 += p2[k] * sx[k];
        if (k + 1 < D) s1 += p2[k + 1] * sx[k + 1];
      }
      sy[i] = s0 + s1;
      __syncwarp(mask);
      s0 = ci;
      s1 = 0.f;
#pragma unroll
      for (int k = 0; k < D; k += 2) {
        s0 += Wr[k] * sy[k];
        if (k + 1 < D) s1 += Wr[k + 1] * sy[k + 1];
      }
      xi = s0 + s1;
      x[((size_t)t * D + i) * SB + lane] = xi;
      // (the next step's x write waits for no barrier: every thread is
      // past this step's second barrier, so done reading sx; and sy is
      // rewritten only after the next first barrier)
    }
  }
}

template <int D>
int launch_filter(int B, int T, const float* J0, const float* h0,
                  const float* A, const float* C, const float* Dm,
                  const float* jd, const float* n2, float* J, float* h,
                  float* ln, cudaStream_t stream) {
  filter_fwd_kernel<D><<<dim3(B, 2), 32, 0, stream>>>(B, T, J0, h0, A, C, Dm,
                                                      jd, n2, J, h, ln);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_factor(int B, int S, int T1, const float* P3,
                          const float* Jf, const float* hf, const float* eps,
                          float* W, float* c, cudaStream_t stream) {
  const int n = T1 * B;
  sampler_fwd_factor_kernel<D>
      <<<(n + kPassThreads - 1) / kPassThreads, kPassThreads, 0, stream>>>(
          B, S, T1, P3, Jf, hf, eps, W, c);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler_chain(int B, int SB, int T1, const float* W,
                         const float* c, const float* P2, const float* xT,
                         float* x, cudaStream_t stream) {
  sampler_fwd_chain_kernel<D><<<SB, D, 0, stream>>>(B, SB, T1, W, c, P2, xT,
                                                    x);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sampler(int B, int S, int T1, const float* P2, const float* P3,
                   const float* Jf, const float* hf, const float* eps,
                   const float* xT, float* W, float* c, float* x,
                   cudaStream_t stream) {
  const int err = launch_sampler_factor<D>(B, S, T1, P3, Jf, hf, eps, W, c,
                                           stream);
  if (err != 0) return err;
  return launch_sampler_chain<D>(B, S * B, T1, W, c, P2, xT, x, stream);
}

}  // namespace

#define SVAE_DIMS(CASE) CASE(2) CASE(3) CASE(4) CASE(8) CASE(10) CASE(16)

// Plain C entries for ctypes. Each returns cudaGetLastError() after its
// launches (0 on success); an unsupported d returns cudaErrorInvalidValue.
// T is the chain's T (T-1 steps). svae_sampler_fwd_f32 runs both of the
// sampler's passes (W (T-1, d*d, B) and c (T-1, d, S*B) are its scratch);
// the other two run one pass each.
extern "C" int svae_filter_fwd_f32(int d, int B, int T, const float* J0,
                                   const float* h0, const float* A,
                                   const float* C, const float* Dm,
                                   const float* jd, const float* n2,
                                   float* J, float* h, float* ln,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                    \
  case DIM:                                                               \
    return launch_filter<DIM>(B, T, J0, h0, A, C, Dm, jd, n2, J, h, ln, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_sampler_fwd_f32(int d, int B, int S, int T,
                                    const float* P2, const float* P3,
                                    const float* Jf, const float* hf,
                                    const float* eps, const float* xT,
                                    float* W, float* c, float* x,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM)                                                      \
  case DIM:                                                                 \
    return launch_sampler<DIM>(B, S, T - 1, P2, P3, Jf, hf, eps, xT, W, c, \
                               x, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_sampler_fwd_factor_f32(int d, int B, int S, int T,
                                           const float* P3, const float* Jf,
                                           const float* hf, const float* eps,
                                           float* W, float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_sampler_factor<DIM>(B, S, T - 1, P3, Jf, hf, eps, W, c, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}

extern "C" int svae_sampler_fwd_chain_f32(int d, int B, int S, int T,
                                          const float* W, const float* c,
                                          const float* P2, const float* xT,
                                          float* x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SVAE_CASE(DIM) \
  case DIM:            \
    return launch_sampler_chain<DIM>(B, S * B, T - 1, W, c, P2, xT, x, s);
  switch (d) {
    SVAE_DIMS(SVAE_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SVAE_CASE
}
#undef SVAE_DIMS
