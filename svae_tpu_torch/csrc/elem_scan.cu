// Hopper kernel of the chain-element prefix scan (the forward of
// ops/chunked.py's ElemScan), the within-chunk and chunk-boundary passes of
// the chunked parallel-in-time LDS E-step.
//
// elem_scan_kernel<D> replaces svae_tpu/ops/pallas_chunked.py:_scan_fwd_kernel.
//
// Each of N lanes scans L Gaussian chain elements e = (J11, J12, J22, h1,
// h2, c): out[0] = leaves[0], out[j] = combine(out[j-1], leaves[j]), where
// combine marginalizes the variable the two blocks share. With
// M = sym(J22a + J11b), v = h2a + h1b and X = M^-1 [J12a^T | J12b | v] =
// [Xa | Xb | xv]:
//   J11 = sym(J11a - J12a Xa),  J12 = -J12a Xb,  J22 = sym(J22b - J12b^T Xb),
//   h1 = h1a - J12a xv,  h2 = h2b - J12b^T xv,
//   c = ca + cb + d/2 log 2pi - 1/2 log|M| + 1/2 v . xv,
// the combine of svae_tpu/ops/pallas_chunked.py:_combine_rows.
//
// What bounds it on an H100. Each lane is a serial chain of L combines,
// and the chunked E-step runs few lanes (B*C = 512 within the chunks at
// the config-2 and long-T shapes, B across them): far fewer chains than
// the card holds threads. The bytes (each combine reads one element and
// writes one, 321 floats at d=10) are far below what the card moves in that
// time: the latency of one chain's combine bounds the kernel. The
// one-thread-per-lane kernel this replaces ran a combine's factor, its 2d
// triangular solves and three products on one thread (about 265 live
// floats at d=10, 1,988 bytes spilled): 30 us a combine.
//
// What the design does about it. M depends on the carry, so the
// factorization cannot leave the chain (bpairs.cu's bidir_fwd case, not
// the sampler's). Each chain runs on one warp, one chain a block, and a
// combine is a Gauss-Jordan elimination over the warp's lanes: lane k < d
// holds column k of M, of J12a^T and of J12b, lane d holds v in all three
// (its first column eliminates as a right-hand side too), and d rounds,
// each broadcasting the pivot column by shuffles, leave X on the lanes:
// column k of Xa and Xb on lane k, xv on lane d. The pivots are those of
// LDL^T (M is symmetric, so no row is exchanged): log|M| is one logf a
// lane and a butterfly sum (warp_log_sum), off the chain, and a
// non-positive pivot gives a NaN reciprocal, which poisons the lane's
// element and every later one. The part of a combine that feeds the next M
// is the filter recursion (J22 and h2 are bidir_fwd's J' and h'); J11, J12
// and h1 ride along as extra columns of the same elimination and extra
// products, which add work but no rounds. The products are one a column
// and lane: J12a Xa, J12a Xb and J12b^T Xb (lane d: J12a xv and J12b^T
// xv), each a row of J12a or of J12b^T from a shared tile read as
// broadcasts (row_dot). The carry stays in registers on the lanes that next
// read it: lane k keeps column k of J11 and J22, lane d h1, h2 and the
// running constant (in double). J12 comes out by columns and is next read
// by rows, so it goes through a shared tile, which is also the next
// combine's J12a tile; J11 and J22 go through tiles of their own, so that
// each lane reads its row beside its column and writes sym() exactly (the
// same sum on both sides, the outputs bitwise symmetric). These tiles are
// double-buffered by the combine's parity, with one warp barrier a combine.
// The coming leaf is loaded a combine ahead, unconditionally (the index
// clamped): lane k reads column k of J11b, J12b and J22b and row k of J11b
// (for sym(J11b)), lane d h1b, h2b and cb. Elements keep the lane
// innermost, (L, R, N), as the adjoint (elem_scan_adj.cu) reads them. d+1
// lanes of a warp hold a combine, so one kernel serves every built d up to
// 31; one column of the tile a lane (3d+1 lanes, so d <= 10) ran no faster
// at d=10 (PERF.md §6). The caller pads time with decoupled unit-Gaussian
// steps, so the algebra needs no masks.

#include "estep_common.cuh"

namespace {

// The rows of one element: J11, J12, J22 (row-major d x d each), h1, h2
// (d each), c.
template <int D>
struct Elem {
  static constexpr int DD = D * D, R = 3 * DD + 2 * D + 1;
  static constexpr int J12 = DD, J22 = 2 * DD, H1 = 3 * DD, H2 = H1 + D,
                       C = H2 + D;
  static constexpr int DP = (D + 3) & ~3;  // product tiles' row stride
  static constexpr int SP = D + 1;         // transpose tiles' row stride
};

// The tiles of one chain: J12a (row-major) and J12b^T (row i = column i of
// J12b) for the products, and J11a - J12a Xa and J22b - J12b^T Xb by
// columns for the transposes, each in two buffers (the combine's parity).
// A and Bt lie first, so that one loop zeroes their padding.
template <int D>
struct ScanShared {
  using E = Elem<D>;
  float A[2][D * E::DP], Bt[2][D * E::DP], Q11[2][D * E::SP],
      Q22[2][D * E::SP];
};

// One warp per lane (chain), one chain a block. Layouts: leaves, out
// (L, R, N) with R = 3d^2 + 2d + 1 rows per element.
template <int D>
__global__ void __launch_bounds__(32)
elem_scan_kernel(int L, int N, const float* __restrict__ leaves,
                 float* __restrict__ out) {
  static_assert(D + 1 <= 32, "a combine's columns must fit one warp");
  using E = Elem<D>;
  constexpr int DP = E::DP, SP = E::SP;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(16) ScanShared<D> sh;
  const int lane = blockIdx.x;
  if (lane >= N) return;  // the whole warp
  const int j = threadIdx.x;
  const bool vec = j == D;           // the lane of the vector column
  const int jc = j < D ? j : D - 1;  // the column a lane reads (clamped)
  const size_t step = (size_t)E::R * N;
  const float* lf = leaves + lane;
  float* of = out + lane;

  for (int r = j; r < E::R; r += 32) of[(size_t)r * N] = lf[(size_t)r * N];
  if (L < 2) return;
  float* zero = &sh.A[0][0];
  for (int k = j; k < 4 * D * DP; k += 32) zero[k] = 0.f;  // the padding
  __syncwarp();  // before the rows land on the zeros

  // a lane's streams of an element, entry i at base + i * stride (rows of
  // N): lane k < d column k of J11 (p11), row k of J11 (r11), column k of
  // J12 and J22; lane d h1 (both J11 slots), h2 (the J22 slot)
  const int p11 = vec ? E::H1 : jc, s11 = vec ? 1 : D;
  const int r11 = vec ? E::H1 : jc * D;
  const int p12 = E::J12 + jc, p22 = vec ? E::H2 : E::J22 + jc;
  const int s22 = vec ? 1 : D;
  auto at = [&](int t, int base, int i, int stride) {
    return lf[(size_t)t * step + (size_t)(base + i * stride) * N];
  };

  // the carry: lane k < d column k of J11a (ca1) and of sym(J22a) (ca2);
  // lane d h1a (ca1), h2a (ca2) and the constant (acc)
  float ca1[D], ca2[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    ca1[i] = at(0, p11, i, s11);
    const float rowk = vec ? at(0, p22, i, s22) : at(0, E::J22 + jc * D, i, 1);
    ca2[i] = 0.5f * (at(0, p22, i, s22) + rowk);
  }
  double acc = lf[(size_t)E::C * N];
  if (j < D) {
#pragma unroll
    for (int i = 0; i < D; ++i) sh.A[1][jc * DP + i] = at(0, E::J12 + jc * D, i, 1);
  }

  // the coming leaf, a combine ahead (unconditional loads, the step
  // clamped to L-1)
  float n11[D], n11r[D], n12[D], n22[D], ncb;
  auto load = [&](int t) {
    t = t < L ? t : L - 1;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      n11[i] = at(t, p11, i, s11);
      n11r[i] = at(t, r11, i, 1);
      n12[i] = at(t, p12, i, D);
      n22[i] = at(t, p22, i, s22);
    }
    ncb = at(t, E::C, 0, 0);
  };
  load(1);
  if (j < D) {
#pragma unroll
    for (int i = 0; i < D; ++i) sh.Bt[1][jc * DP + i] = n12[i];
  }
  __syncwarp();

#pragma unroll 1
  for (int t = 1; t < L; ++t) {
    const int p = t & 1;
    float m[D], xa[D], xb[D], v[D], b22[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      // column k of M = sym(J22a + J11b) (lane d: v = h2a + h1b)
      m[i] = ca2[i] + 0.5f * (n11[i] + n11r[i]);
      v[i] = m[i];
      xa[i] = vec ? m[i] : sh.A[p][jc * DP + i];  // row k of J12a
      xb[i] = vec ? m[i] : n12[i];                // column k of J12b
      b22[i] = n22[i];
    }
    const float cb = ncb;
    load(t + 1);

    float pj = 1.f;  // this lane's pivot
#pragma unroll
    for (int k = 0; k < D; ++k) {
      // the pivot column, from lane k
      float col[D];
#pragma unroll
      for (int i = 0; i < D; ++i) col[i] = __shfl_sync(kAll, m[i], k);
      const float pk = col[k];
      if (j == k) pj = pk;
      const float rp = pk > 0.f ? __fdividef(1.f, pk) : nan_f();
      const float mk = m[k] * rp, ak = xa[k] * rp, bk = xb[k] * rp;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if (i == k) continue;
        m[i] -= col[i] * mk;
        xa[i] -= col[i] * ak;
        xb[i] -= col[i] * bk;
      }
      m[k] = mk;
      xa[k] = ak;
      xb[k] = bk;
    }

    // column k of J12a Xa, J12a Xb and J12b^T Xb on lane k (lane d: J12a
    // xv, J12b^T xv), rows of the tiles as broadcasts
    float y1[D], y2[D], y3[D], q = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y1[i] = row_dot<D, DP>(sh.A[p] + i * DP, xa);
      y2[i] = row_dot<D, DP>(sh.A[p] + i * DP, xb);
      y3[i] = row_dot<D, DP>(sh.Bt[p] + i * DP, xb);
      q += v[i] * xa[i];
    }
    const float lsum = warp_log_sum(pj);
    // lane k: columns of J11a - J12a Xa and J22b - J12b^T Xb into the
    // transpose tiles, column k of J12' into the next combine's J12a tile,
    // column k of the coming J12b into its J12b^T tile; lane d: h1', h2'
#pragma unroll
    for (int i = 0; i < D; ++i) {
      ca1[i] -= y1[i];
      b22[i] -= y3[i];
    }
    if (j < D) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        sh.Q11[p][i * SP + jc] = ca1[i];
        sh.Q22[p][i * SP + jc] = b22[i];
        sh.A[p ^ 1][i * DP + jc] = -y2[i];
        sh.Bt[p ^ 1][jc * DP + i] = n12[i];
      }
    }
    __syncwarp();

    float* o = of + (size_t)t * step;
    if (j < D) {
      // sym(): the row beside the column, the same sum on both sides
#pragma unroll
      for (int i = 0; i < D; ++i) {
        ca1[i] = 0.5f * (ca1[i] + sh.Q11[p][jc * SP + i]);
        ca2[i] = 0.5f * (b22[i] + sh.Q22[p][jc * SP + i]);
        o[(size_t)(i * D + jc) * N] = ca1[i];
        o[(size_t)(E::J12 + i * D + jc) * N] = -y2[i];
        o[(size_t)(E::J22 + i * D + jc) * N] = ca2[i];
      }
    } else if (vec) {
      acc += (double)(cb + 0.5f * D * kLog2Pi - 0.5f * lsum + 0.5f * q);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        ca2[i] = b22[i];
        o[(size_t)(E::H1 + i) * N] = ca1[i];
        o[(size_t)(E::H2 + i) * N] = ca2[i];
      }
      o[(size_t)E::C * N] = (float)acc;
    }
  }
}

template <int D>
int launch_scan(int L, int N, const float* leaves, float* out,
                cudaStream_t stream) {
  elem_scan_kernel<D><<<N, 32, 0, stream>>>(L, N, leaves, out);
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
