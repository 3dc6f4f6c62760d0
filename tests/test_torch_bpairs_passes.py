"""The passes of the port's per-sequence sampler adjoint
(svae_tpu_torch/ops/bpairs.py: sampler_bp_adj_factor / sampler_bp_adj_chain
/ sampler_bp_adj_dJc), in float64 on the CPU.

Each pass has a plain version of its own, which the wrappers run on CPU
tensors; composed, they must give the plain adjoint ``sampler_bp_adj_plain``
(torch's vector-Jacobian product of the forward twin, which
tests/test_torch_ragged.py holds to the JAX package) at rtol 1e-8 / atol
1e-10: both sides are float64, and the passes' explicit inverse rounds
differently from autograd through the factor. The kernels themselves are
held to these plain versions on a card by tests/test_torch_kernels.py."""

import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import bpairs, estep
from svae_tpu_torch.utils import smallchol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (d, S, T) at B=5 sequences (not a multiple of a warp's 32 lanes): the two
# smallest built latent sizes, one and two samples a sequence, one step
# (T=2, the shortest chain) and a short ragged chain
CASES = [(d, S, T) for d in (2, 3) for S in (1, 2) for T in (2, 7)]


def _problem(d, S, T, seed):
    """``sampler_bp_adj``'s float64 arguments on a ragged batch of B=5
    (chip_smoke.bpairs_problem)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.bpairs_problem(dict(B=5, T=T, d=d, S=S), seed,
                                     device="cpu")[1]


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("d,S,T", CASES)
def test_sampler_bp_adj_passes_compose_to_plain(d, S, T):
    P2, P3, Jf, hf, eps, xT, x, dx = samp = _problem(d, S, T, seed=d + T + S)
    T1, dd, B = Jf.shape
    W = bpairs.sampler_bp_adj_factor(P3, Jf)
    assert W.shape == (T1, dd, B)
    bbar, dxT = bpairs.sampler_bp_adj_chain(W, P2, dx)
    assert bbar.shape == (T1, d, S * B)
    got = bpairs.sampler_bp_adj_dJc(P2, P3, Jf, hf, eps, xT, x, bbar)
    _close(got + (dxT,), bpairs.sampler_bp_adj_plain(*samp))


def test_factor_pass_inverts_each_step_precision():
    d = 3
    P2, P3, Jf = _problem(d, 2, 7, seed=1)[:3]
    W = bpairs.sampler_bp_adj_factor(P3, Jf)
    mats = lambda X: X.permute(0, 2, 1).reshape(-1, d, d)
    Jc = mats(Jf) - 2.0 * mats(P3)
    eye = torch.eye(d, dtype=torch.float64).expand_as(Jc)
    np.testing.assert_allclose((mats(W) @ Jc).numpy(), eye.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(mats(W).numpy(), mats(W).mT.numpy(),
                               atol=1e-12)


def test_dJc_pass_algebra_matches_plain():
    """The dJc kernel's algebra: with w = L^-1 b and u = L^T bbar,
    bbar mu^T = L^-T u w^T L^-1, so the S samples' dJc sum to L^-T Z L^-1,
    Z = sum_s sym(P_s - u_s w_s^T), one product with L^-1 for the sequence
    (csrc/sampler_bp_adj.cu) against the per-lane ``estep.sampler_dJc``."""
    g = torch.Generator().manual_seed(3)
    d, S, n = 4, 3, 6
    A = torch.randn((n, d, d), generator=g, dtype=torch.float64)
    L = smallchol.chol(A @ A.mT + d * torch.eye(d, dtype=torch.float64))
    b, bbar, eps = (torch.randn((S, n, d), generator=g, dtype=torch.float64)
                    for _ in range(3))
    want = estep.sampler_dJc(L, smallchol.cho_solve(L, b), bbar, eps).sum(0)
    w = smallchol.solve_lower(L, b)
    u = (L.mT @ bbar[..., None])[..., 0]
    outer = lambda a, c: a[..., :, None] * c[..., None, :]
    P = -torch.tril(outer(eps, u))
    P = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
    Z = P - outer(u, w)
    Z = (0.5 * (Z + Z.mT)).sum(0)
    Linv = torch.linalg.inv(L)
    np.testing.assert_allclose((Linv.mT @ Z @ Linv).numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_sampler_bp_adj_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    P2, P3, Jf, hf, eps, xT, x, dx = _problem(3, 2, 7, seed=2)
    W = bpairs.sampler_bp_adj_factor(P3, Jf)
    bbar = bpairs.sampler_bp_adj_chain(W, P2, dx)[0]
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [
        (bpairs.sampler_bp_adj_factor, (P3, Jf)),
        (bpairs.sampler_bp_adj_chain, (W, P2, dx)),
        (bpairs.sampler_bp_adj_dJc, (P2, P3, Jf, hf, eps, xT, x, bbar)),
        (bpairs.sampler_bp_adj, (P2, P3, Jf, hf, eps, xT, x, dx)),
    ]
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*meta(args))
        with pytest.raises(TypeError, match="float32"):
            fn(*meta(args, torch.float64))
        bad = list(meta(args))
        shape = bad[0].shape
        bad[0] = torch.empty((shape[0] + 1, *shape[1:]), device="meta")
        with pytest.raises(ValueError, match="inconsistent shapes"):
            fn(*bad)
    d5 = torch.empty((6, 25, 5), device="meta")
    with pytest.raises(ValueError, match="d=5"):
        bpairs.sampler_bp_adj_factor(d5, d5)
