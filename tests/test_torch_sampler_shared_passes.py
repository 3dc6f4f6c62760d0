"""The passes of the port's shared-pair sampler
(svae_tpu_torch/ops/kalman_fwd.py: sampler_shared_factor, then
bpairs.sampler_bp_fwd_chain), in float64 on the CPU.

The factor pass has a plain version of its own, which the wrapper runs on
CPU tensors; composed with the per-sequence sampler's chain pass, it must
give ``sampler_shared_plain`` (the one-step recursion, which
tests/test_torch_kalman_fwd.py holds to the JAX package's kernel) at rtol
1e-8 / atol 1e-10: both sides are float64, and the passes' explicit
solves round differently from the recursion's. The kernels themselves are
held to these plain versions on a card by tests/test_torch_kernels.py."""

import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import bpairs, kalman_fwd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (d, S, T) at B=5 sequences (not a multiple of a warp's 32 lanes): the two
# smallest built latent sizes, one and two samples a sequence, one step
# (T=2, the shortest chain) and a short chain
CASES = [(d, S, T) for d in (2, 3) for S in (1, 2) for T in (2, 7)]


def _problem(d, S, T, seed):
    """``sampler_shared``'s float64 arguments (P2, P3, Jf, hf, eps, xT) on
    chip_smoke.kfwd_problem's pairs (the config-2 expected pairs varied in
    time) at B=5, the messages from the plain forward filter."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke._kfwd_sampler_problem(
        chip_smoke.kfwd_problem(dict(B=5, T=T, d=d, S=S), seed,
                                device="cpu"), "cpu")


@pytest.mark.parametrize("d,S,T", CASES)
def test_sampler_shared_passes_compose_to_plain(d, S, T):
    P2, P3, Jf, hf, eps, xT = sin = _problem(d, S, T, seed=d + T + S)
    T1, dd, B = Jf.shape
    assert P2.shape == P3.shape == (T1, dd)
    Q, c = kalman_fwd.sampler_shared_factor(P2, P3, Jf, hf, eps)
    assert Q.shape == (T1, dd, B) and c.shape == (T1, d, S * B)
    assert Q.is_contiguous() and c.is_contiguous()
    got = bpairs.sampler_bp_fwd_chain_plain(Q, c, xT)
    np.testing.assert_allclose(got.numpy(),
                               kalman_fwd.sampler_shared_plain(*sin).numpy(),
                               rtol=RTOL, atol=ATOL)
    # and the wrapper, which composes them on a card, runs the recursion on
    # the CPU
    np.testing.assert_allclose(kalman_fwd.sampler_shared(*sin).numpy(),
                               got.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [2, 3])
def test_factor_pass_on_shared_rows_is_the_per_sequence_one(d):
    """The shared rows read at stride 1 give what the per-sequence factor
    pass gives on the rows expanded over the batch, to the last bit."""
    P2, P3, Jf, hf, eps, _ = _problem(d, 2, 7, seed=d)
    B = Jf.shape[2]
    lanes = lambda X: X[..., None].expand(X.shape + (B,)).contiguous()
    got = kalman_fwd.sampler_shared_factor(P2, P3, Jf, hf, eps)
    want = bpairs.sampler_bp_fwd_factor(lanes(P2), lanes(P3), Jf, hf, eps)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d", [2, 3])
def test_factor_pass_solves_each_step_precision_against_P2(d):
    """Jc_t Q_t P2_t^-T = I where P2_t is invertible, Jc_t = Jf_t - 2 P3_t
    of each sequence."""
    P2, P3, Jf, hf, eps, _ = _problem(d, 1, 7, seed=d + 1)
    Q, _ = kalman_fwd.sampler_shared_factor(P2, P3, Jf, hf, eps)
    T1, _, B = Jf.shape
    rows = lambda X: X.reshape(T1, 1, d, d)
    P2m = rows(P2)
    assert float(torch.linalg.svdvals(P2m).min()) > 1e-3
    mats = lambda X: X.permute(0, 2, 1).reshape(T1, B, d, d)
    Jc = mats(Jf) - 2.0 * rows(P3)
    eye = torch.eye(d, dtype=Q.dtype).expand(T1, B, d, d)
    got = Jc @ mats(Q) @ torch.linalg.inv(P2m.mT)
    np.testing.assert_allclose(got.numpy(), eye.numpy(), rtol=RTOL,
                               atol=1e-9)


def test_sampler_shared_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    P2, P3, Jf, hf, eps, xT = _problem(3, 2, 7, seed=2)
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [(kalman_fwd.sampler_shared_factor, (P2, P3, Jf, hf, eps)),
             (kalman_fwd.sampler_shared, (P2, P3, Jf, hf, eps, xT))]
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*meta(args))
        with pytest.raises(TypeError, match="float32"):
            fn(*meta(args, torch.float64))
        strided = list(meta(args))
        strided[2] = strided[2].mT.contiguous().mT
        with pytest.raises(ValueError, match="contiguous"):
            fn(*strided)
        for k in (0, 3):
            bad = list(meta(args))
            shape = bad[k].shape
            bad[k] = torch.empty((shape[0] + 1, *shape[1:]), device="meta")
            with pytest.raises(ValueError, match="inconsistent shapes"):
                fn(*bad)
    # the S*B noise lanes must be a multiple of the B sequences
    bad = list(meta((P2, P3, Jf, hf, eps)))
    bad[4] = torch.empty(eps.shape[:2] + (eps.shape[2] + 1,), device="meta")
    with pytest.raises(ValueError, match="inconsistent shapes"):
        kalman_fwd.sampler_shared_factor(*bad)
    # a latent size with no kernel
    P2, P3, Jf, hf, eps, xT = _problem(5, 1, 4, seed=5)
    with pytest.raises(ValueError, match="d=5"):
        kalman_fwd.sampler_shared_factor(*meta((P2, P3, Jf, hf, eps)))
    with pytest.raises(ValueError, match="d=5"):
        kalman_fwd.sampler_shared(*meta((P2, P3, Jf, hf, eps, xT)))
