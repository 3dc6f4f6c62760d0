"""What the shared-pair filters' kernels read (svae_tpu_torch/ops/
kalman_fwd.py: filter_shared / backward_shared, csrc/kalman_fwd.cu), in
float64 on the CPU, with no JAX.

The kernel route hands each C entry the wrapper's arguments as
``filter_inputs`` / ``backward_inputs`` assemble them: the pair rows P1,
P2, P3 (T-1, d*d) and pc (T-1,), shared by the batch, and the per-lane
node streams N1 (T-1, d*d, B), N2 (T-1, d, B). The kernels run bidir_fwd's
Gauss-Jordan step (csrc/filter_chain.cuh) on operands that their reader
forms from those: A from a pair row's lower triangle (the backward adds
N1's lower triangle), C from a pair row in full (the forward adds N1 in
full), D = P2_t (the backward: P2_t^T), e and f from N2, the backward
walking t = T-2 ... 0. ``_shared_row_chain`` forms the same operands in
Python and runs the same elimination (no pivoting; the pivots' logs give
ln), and must give ``filter_shared_plain`` / ``backward_shared_plain``
(bpairs' Cholesky twins on the rows broadcast over the lanes) at rtol 1e-8
/ atol 1e-10: both sides are float64 and round differently. The kernels
themselves are held to the plain versions on a card by
tests/test_torch_kernels.py."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import kalman_fwd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (d, T, perturbed) at B=5 sequences: the two smallest built latent sizes,
# one step (T=2) and a short chain, and the pair rows' and node blocks'
# upper triangles perturbed (A is read from its lower triangle, C in full)
CASES = [(d, T, asym) for d in (2, 3) for T in (2, 7)
         for asym in (False, True)]


def _problem(d, T, asym, seed):
    """``(init, pairs, nodes)`` in float64 at B=5 (chip_smoke.kfwd_problem,
    the config-2 expected pairs varied in time), with the upper triangles
    of P1, P3 and N1 perturbed if ``asym``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    init, (P1, P2, P3, Pc), (N1, N2), _ = chip_smoke.kfwd_problem(
        dict(B=5, T=T, d=d, S=1), seed, device="cpu")
    if asym:
        g = torch.Generator().manual_seed(seed + 7)
        upper = torch.triu(torch.ones(d, d, dtype=N1.dtype), 1)
        perturb = lambda X: X + 0.3 * upper * torch.randn(
            X.shape, generator=g, dtype=X.dtype)
        P1, P3, N1 = perturb(P1), perturb(P3), perturb(N1)
    return init, (P1, P2, P3, Pc), (N1, N2)


def _sym_lower(X):
    """The symmetric matrix of X's lower triangle (last two axes)."""
    return X.tril() + X.tril(-1).mT


def _reader(args, s, backward):
    """Step s's operands as csrc/kalman_fwd.cu's reader forms them from the
    C entry's arguments: the row r it reads and writes, A, C (B, d, d), D
    (d, d), e, f (B, d) and pc."""
    if backward:
        P1, P2, P3, N1, N2 = args
        PA, PC, Pc = P1, P3, None
    else:
        P1, P2, P3, Pc, N1, N2 = args[2:]
        PA, PC = P3, P1
    T1, dd, B = N1.shape
    d = N2.shape[1]
    r = T1 - 1 - s if backward else s
    mat = lambda row: row.reshape(d, d)
    n1 = N1[r].T.reshape(B, d, d)           # lane b's node block
    n2 = N2[r].T                            # (B, d)
    zero = torch.zeros_like(n2)
    A = -2.0 * (_sym_lower(mat(PA[r])) + (_sym_lower(n1) if backward else 0))
    C = -2.0 * (mat(PC[r]) + (0 if backward else n1))
    D = mat(P2[r]).T if backward else mat(P2[r])
    return (r, A, C, D, zero if backward else n2, n2 if backward else zero,
            0.0 if backward else Pc[r])


def _gauss_jordan(M, R):
    """X = M^-1 R by elimination without pivoting, and the pivots: M (B, d,
    d), R (B, d, m). A non-positive pivot gives NaN, as the kernels'."""
    M, R = M.clone(), R.clone()
    d = M.shape[-1]
    pivots = []
    for k in range(d):
        p = M[:, k, k]
        pivots.append(p)
        rp = torch.where(p > 0, 1.0 / p, torch.full_like(p, math.nan))
        mk, rk = M[:, k] * rp[:, None], R[:, k] * rp[:, None]
        col = M[:, :, k].clone()
        M = M - col[:, :, None] * mk[:, None, :]
        R = R - col[:, :, None] * rk[:, None, :]
        M[:, k], R[:, k] = mk, rk
    return R, torch.stack(pivots, -1)


def _shared_row_chain(args, backward):
    """The kernels' recursion on the C entry's arguments: per step M = J +
    A, v = h + f, [X_D | X_v] = M^-1 [D^T | v], J' = C - D X_D (written in
    full; the carry takes C's lower triangle), h' = D X_v + e, ln += d/2 log
    2pi - 1/2 sum log p_k + 1/2 v . X_v + pc. Returns the outputs in the
    C entry's layout: J (T-1, d*d, B), h (T-1, d, B) and, forward, ln (B,)."""
    N1, N2 = args[-2:]
    T1, dd, B = N1.shape
    d = N2.shape[1]
    if backward:
        J, h = N1.new_zeros(B, d, d), N1.new_zeros(B, d)
    else:
        J, h = _sym_lower(args[0].T.reshape(B, d, d)), args[1].T
    ln = N1.new_zeros(B)
    Jout, hout = torch.empty_like(N1), torch.empty_like(N2)
    for s in range(T1):
        r, A, C, D, e, f, pc = _reader(args, s, backward)
        v = h + f
        X, piv = _gauss_jordan(J + A, torch.cat(
            [D.T.expand(B, d, d), v[..., None]], -1))
        DX = D @ X[..., :d]
        ln = ln + (0.5 * d * math.log(2 * math.pi)
                   - 0.5 * torch.log(piv).sum(-1)
                   + 0.5 * (v * X[..., d]).sum(-1) + pc)
        Jout[r] = (C - DX).reshape(B, dd).T
        h = (D @ X[..., d:])[..., 0] + e
        hout[r] = h.T
        J = _sym_lower(C) - DX
    return (Jout, hout) if backward else (Jout, hout, ln)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("d,T,asym", CASES)
def test_shared_row_chain_gives_the_plain_filters(d, T, asym, backward):
    init, pairs, nodes = _problem(d, T, asym, seed=d + T + asym)
    if backward:
        args = kalman_fwd.backward_inputs(pairs, nodes)
        want = kalman_fwd.backward_shared_plain(*args)
    else:
        args = kalman_fwd.filter_inputs(init, pairs, nodes)
        want = kalman_fwd.filter_shared_plain(*args)
    got = _shared_row_chain(args, backward)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["filter_shared", "backward_shared"])
def test_shared_filter_wrappers_reject_what_the_kernels_do_not_take(name):
    """Shapes, then the latent size, dtype and contiguity, then the device:
    meta tensors reach every check without a card."""
    fn = getattr(kalman_fwd, name)
    inputs = (kalman_fwd.filter_inputs if name == "filter_shared"
              else lambda i, p, n: kalman_fwd.backward_inputs(p, n))
    meta = lambda xs, dt=torch.float32: [
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs]
    args = inputs(*_problem(3, 7, False, seed=1))
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*meta(args))
    with pytest.raises(TypeError, match="float32"):
        fn(*meta(args, torch.float64))
    strided = meta(args)
    strided[-2] = strided[-2].mT.contiguous().mT
    with pytest.raises(ValueError, match="contiguous"):
        fn(*strided)
    for k in range(len(args) - 1):  # every input but the last, N2, one row
        bad = meta(args)              # longer than the rest
        bad[k] = torch.empty((bad[k].shape[0] + 1, *bad[k].shape[1:]),
                             device="meta")
        with pytest.raises(ValueError, match="inconsistent shapes"):
            fn(*bad)
    # a latent size with no kernel
    with pytest.raises(ValueError, match="d=5"):
        fn(*meta(inputs(*_problem(5, 4, False, seed=5))))
