"""The passes of the port's per-sequence forward sampler
(svae_tpu_torch/ops/bpairs.py: sampler_bp_fwd_factor / sampler_bp_fwd_chain),
in float64 on the CPU.

Each pass has a plain version of its own, which the wrappers run on CPU
tensors; composed, they must give ``sampler_bp_fwd_plain`` (the one-step
recursion, which tests/test_torch_ragged.py holds to the JAX package's
kernel) at rtol 1e-8 / atol 1e-10: both sides are float64, and the passes'
explicit inverse rounds differently from the recursion's triangular
solves. The kernels themselves are held to these plain versions on a card
by tests/test_torch_kernels.py."""

import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import bpairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (d, S, T) at B=5 sequences (not a multiple of a warp's 32 lanes): the two
# smallest built latent sizes, one and two samples a sequence, one step
# (T=2, the shortest chain) and a short ragged chain
CASES = [(d, S, T) for d in (2, 3) for S in (1, 2) for T in (2, 7)]


def _problem(d, S, T, seed):
    """``sampler_bp_fwd``'s float64 arguments (P2, P3, Jf, hf, eps, xT) on
    a ragged batch of B=5 (chip_smoke.bpairs_problem)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.bpairs_problem(dict(B=5, T=T, d=d, S=S), seed,
                                     device="cpu")[1][:6]


@pytest.mark.parametrize("d,S,T", CASES)
def test_sampler_bp_fwd_passes_compose_to_plain(d, S, T):
    P2, P3, Jf, hf, eps, xT = sin = _problem(d, S, T, seed=d + T + S)
    T1, dd, B = Jf.shape
    Q, c = bpairs.sampler_bp_fwd_factor(P2, P3, Jf, hf, eps)
    assert Q.shape == (T1, dd, B) and c.shape == (T1, d, S * B)
    assert Q.is_contiguous() and c.is_contiguous()
    got = bpairs.sampler_bp_fwd_chain(Q, c, xT)
    np.testing.assert_allclose(got.numpy(),
                               bpairs.sampler_bp_fwd_plain(*sin).numpy(),
                               rtol=RTOL, atol=ATOL)
    # and the wrapper, which composes them on a card, runs the recursion
    # on the CPU
    np.testing.assert_allclose(bpairs.sampler_bp_fwd(*sin).numpy(),
                               got.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [2, 3])
def test_factor_pass_inverts_each_step_precision(d):
    """Q_t = Jc_t^-1 P2_t^T and, per sample, Jc_t c_t = hf_t + L_t eps_t,
    with Jc_t = Jf_t - 2 P3_t and L_t its Cholesky factor."""
    S = 2
    P2, P3, Jf, hf, eps, xT = _problem(d, S, 7, seed=d)
    Q, c = bpairs.sampler_bp_fwd_factor(P2, P3, Jf, hf, eps)
    mats = lambda X: X.permute(0, 2, 1).reshape(-1, d, d)
    Jc = mats(Jf) - 2.0 * mats(P3)
    np.testing.assert_allclose((Jc @ mats(Q)).numpy(),
                               mats(P2).mT.numpy(), rtol=RTOL, atol=ATOL)
    T1, _, B = Jf.shape
    L = torch.linalg.cholesky(Jc).reshape(T1, B, d, d)
    vecs = lambda X: X.permute(0, 2, 1)[..., None]       # (T1, lanes, d, 1)
    for s in range(S):
        lanes = slice(s * B, (s + 1) * B)
        got = Jc.reshape(T1, B, d, d) @ vecs(c[:, :, lanes])
        want = vecs(hf) + L @ vecs(eps[:, :, lanes])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_sampler_bp_fwd_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    P2, P3, Jf, hf, eps, xT = _problem(3, 2, 7, seed=2)
    Q, c = bpairs.sampler_bp_fwd_factor(P2, P3, Jf, hf, eps)
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [(bpairs.sampler_bp_fwd_factor, (P2, P3, Jf, hf, eps)),
             (bpairs.sampler_bp_fwd_chain, (Q, c, xT)),
             (bpairs.sampler_bp_fwd, (P2, P3, Jf, hf, eps, xT))]
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*meta(args))
        with pytest.raises(TypeError, match="float32"):
            fn(*meta(args, torch.float64))
        strided = list(meta(args))
        strided[1] = strided[1].mT.contiguous().mT
        with pytest.raises(ValueError, match="contiguous"):
            fn(*strided)
        bad = list(meta(args))
        shape = bad[0].shape
        bad[0] = torch.empty((shape[0] + 1, *shape[1:]), device="meta")
        with pytest.raises(ValueError, match="inconsistent shapes"):
            fn(*bad)
    # a latent size with no kernel
    P2, P3, Jf, hf, eps, xT = _problem(5, 1, 4, seed=5)
    with pytest.raises(ValueError, match="d=5"):
        bpairs.sampler_bp_fwd_factor(*meta((P2, P3, Jf, hf, eps)))
    Q, c = bpairs.sampler_bp_fwd_factor(P2, P3, Jf, hf, eps)
    with pytest.raises(ValueError, match="d=5"):
        bpairs.sampler_bp_fwd_chain(*meta((Q, c, xT)))
