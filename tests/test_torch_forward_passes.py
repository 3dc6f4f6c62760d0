"""The passes of the port's forward sampler (svae_tpu_torch/ops/estep.py:
sampler_fwd_factor / sampler_fwd_chain), in float64 on the CPU.

Each pass has a plain version of its own, which the wrappers run on CPU
tensors; composed, they must give ``sampler_fwd_plain`` (the one-step
recursion, which tests/test_torch_estep.py holds to the JAX package's
kernel) at rtol 1e-8 / atol 1e-10: both sides are float64, and the passes'
explicit inverse rounds differently from the recursion's triangular
solves. The kernels themselves are held to these plain versions on a card
by tests/test_torch_kernels.py."""

import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import estep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (d, T): the two smallest built latent sizes at a short chain, and one
# step (T=2, the shortest chain the filter takes)
CASES = [(2, 7), (3, 7), (3, 2)]


def _sampler_problem(d, T, seed, S=2, B=3):
    """The sampler's float64 inputs (P2, P3, Jf, hf, eps, xT) on the forward
    filter's messages of a random problem."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    _, samp = chip_smoke.adjoint_problem(dict(B=B, T=T, d=d, S=S), seed,
                                         device="cpu")
    return samp[:6]


@pytest.mark.parametrize("d,T", CASES)
def test_sampler_fwd_passes_compose_to_plain(d, T):
    P2, P3, Jf, hf, eps, xT = sin = _sampler_problem(d, T, seed=d + T)
    W, c = estep.sampler_fwd_factor(P3, Jf, hf, eps)
    got = estep.sampler_fwd_chain(W, c, P2, xT)
    np.testing.assert_allclose(got.numpy(),
                               estep.sampler_fwd_plain(*sin).numpy(),
                               rtol=RTOL, atol=ATOL)
    # and the wrapper, which composes them on a card, runs the recursion
    # on the CPU
    np.testing.assert_allclose(estep.sampler_fwd(*sin).numpy(), got.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d,T", CASES)
def test_sampler_fwd_factor_inverts_the_step_precisions(d, T):
    P2, P3, Jf, hf, eps, xT = _sampler_problem(d, T, seed=2 * d + T)
    W, c = estep.sampler_fwd_factor(P3, Jf, hf, eps)
    lanes = lambda X: X.permute(0, 2, 1).reshape(-1, d, d)
    Jc = lanes(Jf) - 2.0 * P3
    np.testing.assert_allclose(lanes(W).numpy(),
                               torch.linalg.inv(Jc).numpy(), rtol=RTOL,
                               atol=ATOL)
    # c = W hf + L^-T eps per sample: the samples' noise read at its lane
    B = Jf.shape[2]
    S = eps.shape[2] // B
    Wl = lanes(W).reshape(T - 1, B, d, d)
    L = torch.linalg.cholesky(Jc).reshape(T - 1, B, d, d)
    for s in range(S):
        e = eps[:, :, s * B:(s + 1) * B].permute(0, 2, 1)[..., None]
        want = (Wl @ hf.permute(0, 2, 1)[..., None]
                + torch.linalg.solve_triangular(L.mT, e, upper=True))
        np.testing.assert_allclose(
            c[:, :, s * B:(s + 1) * B].permute(0, 2, 1).numpy(),
            want[..., 0].numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d,T", CASES)
def test_sampler_fwd_pass_shapes(d, T):
    S, B = 3, 2
    P2, P3, Jf, hf, eps, xT = _sampler_problem(d, T, seed=3, S=S, B=B)
    W, c = estep.sampler_fwd_factor(P3, Jf, hf, eps)
    assert W.shape == (T - 1, d * d, B) and c.shape == (T - 1, d, S * B)
    assert W.is_contiguous() and c.is_contiguous()
    x = estep.sampler_fwd_chain(W, c, P2, xT)
    assert x.shape == (T - 1, d, S * B)
    # W is the adjoint's own: the same function as sampler_adj_factor's
    np.testing.assert_allclose(W.numpy(),
                               estep.sampler_adj_factor(P3, Jf).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_sampler_fwd_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    P2, P3, Jf, hf, eps, xT = _sampler_problem(3, 5, seed=4)
    W, c = estep.sampler_fwd_factor(P3, Jf, hf, eps)
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [(estep.sampler_fwd_factor, (P3, Jf, hf, eps)),
             (estep.sampler_fwd_chain, (W, c, P2, xT)),
             (estep.sampler_fwd, (P2, P3, Jf, hf, eps, xT))]
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
        shape = bad[1].shape
        bad[1] = torch.empty((shape[0] + 1, *shape[1:]), device="meta")
        with pytest.raises(ValueError, match="inconsistent shapes"):
            fn(*bad)
    # a latent size with no kernel
    P2, P3, Jf, hf, eps, xT = _sampler_problem(5, 4, seed=5)
    with pytest.raises(ValueError, match="d=5"):
        estep.sampler_fwd_factor(*meta((P3, Jf, hf, eps)))
