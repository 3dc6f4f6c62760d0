"""The passes of the port's two stationary adjoints (svae_tpu_torch/ops/
estep.py: filter_adj_factor / filter_adj_chain and sampler_adj_factor /
sampler_adj_chain / sampler_adj_dJc), in float64 on the CPU.

Each pass has a plain version of its own, which the wrappers run on CPU
tensors; composed, they must give the plain adjoints (``filter_adj_plain``
and ``sampler_adj_plain``, torch's vector-Jacobian products of the forward
twins, which tests/test_torch_adjoints.py holds to the JAX package) at
rtol 1e-8 / atol 1e-10: both sides are float64, and the passes' explicit
inverses round differently from autograd through the factor. The kernels
themselves are held to these plain versions on a card by
tests/test_torch_kernels.py."""

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


def _problem(d, T, seed):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.adjoint_problem(dict(B=3, T=T, d=d, S=2), seed,
                                      device="cpu")


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("d,T", CASES)
def test_filter_adj_passes_compose_to_plain(d, T):
    filt, _ = _problem(d, T, seed=d + T)
    B = filt[5].shape[2]
    fac = estep.filter_adj_factor(*filt[:9])
    assert fac.shape == (T - 1, 2 * d * d + d, 2 * B)
    dnode, dJ0, dh0, dpar = estep.filter_adj_chain(fac, *filt[9:])
    # frame 0 reaches the filter only through J0 / h0
    assert not dnode[:, :, 0].any()
    got = estep._filter_adj_outputs(dnode, dJ0, dh0, dpar, d, B)
    _close(got, estep.filter_adj_plain(*filt))


@pytest.mark.parametrize("d,T", CASES)
def test_sampler_adj_passes_compose_to_plain(d, T):
    _, samp = _problem(d, T, seed=d + T)
    P2, P3, Jf, hf, eps, xT, x, dx = samp
    B = Jf.shape[2]
    W = estep.sampler_adj_factor(P3, Jf)
    assert W.shape == (T - 1, d * d, B)
    dhf, dxT, dP2 = estep.sampler_adj_chain(W, P2, xT, x, dx)
    dJc = estep.sampler_adj_dJc(P2, P3, Jf, hf, eps, xT, x, dhf)
    got = estep._sampler_adj_outputs(dJc, dhf, dxT, dP2, B)
    _close(got, estep.sampler_adj_plain(*samp))


def test_factor_passes_invert_the_step_precisions():
    filt, samp = _problem(3, 5, seed=1)
    d = 3
    fac = estep.filter_adj_factor(*filt[:9])
    W = fac[:, :d * d].permute(0, 2, 1).reshape(-1, d, d)
    P3, Jf = samp[1], samp[2]
    lanes = lambda X: X.permute(0, 2, 1).reshape(-1, d, d)
    Wc = lanes(estep.sampler_adj_factor(P3, Jf))
    Jc = lanes(Jf) - 2.0 * P3
    eye = torch.eye(d, dtype=torch.float64)
    np.testing.assert_allclose((Wc @ Jc).numpy(),
                               eye.expand_as(Jc).numpy(), atol=1e-10)
    # W is symmetric and positive definite
    np.testing.assert_allclose(W.numpy(), W.mT.numpy(), atol=1e-12)
    assert bool((torch.linalg.eigvalsh(W) > 0).all())


def test_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    filt, samp = _problem(3, 5, seed=2)
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    fac = estep.filter_adj_factor(*filt[:9])
    W = estep.sampler_adj_factor(samp[1], samp[2])
    dhf = estep.sampler_adj_chain(W, samp[0], *samp[5:])[0]
    calls = [
        (estep.filter_adj_factor, filt[:9]),
        (estep.filter_adj_chain, (fac, *filt[9:])),
        (estep.sampler_adj_factor, (samp[1], samp[2])),
        (estep.sampler_adj_chain, (W, samp[0], *samp[5:])),
        (estep.sampler_adj_dJc, (*samp[:7], dhf)),
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
