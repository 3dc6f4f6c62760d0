"""The passes of the port's element-scan and bidirectional-filter adjoints
(svae_tpu_torch/ops/chunked.py: elem_scan_adj_factor / elem_scan_adj_chain;
ops/bpairs.py: bidir_adj_factor / bidir_adj_chain), in float64 on the
CPU.

Each pass has a plain version of its own, which the wrappers run on CPU
tensors; composed, they must give the plain adjoints (``elem_scan_adj_plain``
and ``bidir_adj_plain``, torch's vector-Jacobian products of the forward
twins, which tests/test_torch_chunked.py and tests/test_torch_ragged.py
hold to the JAX package) at rtol 1e-8 / atol 1e-10: both sides are
float64, and the passes' explicit inverses round differently from autograd
through the factor. The kernels themselves are held to these plain
versions on a card by tests/test_torch_kernels.py."""

import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import bpairs, chunked

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (d, T, C): the two smallest built latent sizes at a short chain folded
# into chunks, and one combine a lane (L = 2)
ELEM_CASES = [(2, 10, 3), (3, 10, 3), (3, 3, 1)]
# (d, T): a short chain, and one step (T=2, the shortest the filter takes)
BIDIR_CASES = [(2, 7), (3, 7), (3, 2)]


def _smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _elem_problem(d, T, C, seed):
    """float64 leaves (L, R, N), their prefixes and random cotangents."""
    leaves = _smoke().elem_problem(dict(B=3, T=T, d=d, C=C), seed,
                                   device="cpu")
    pref = chunked.elem_scan_plain(leaves)
    g = torch.Generator().manual_seed(seed + 1)
    douts = torch.randn(pref.shape, generator=g, dtype=torch.float64)
    return leaves, pref, douts


def _bidir_problem(d, T, seed):
    """``bidir_adj``'s float64 arguments on a ragged batch, the
    log-normalizer cotangent zero on the backward lanes (as the E-step
    leaves it) and not on the forward ones."""
    filt = list(_smoke().bpairs_problem(dict(B=3, T=T, d=d, S=1), seed,
                                        device="cpu")[0])
    dln = filt[12].clone()
    dln[dln.shape[0] // 2:] = 0.0
    filt[12] = dln
    return filt


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("d,T,C", ELEM_CASES)
def test_elem_scan_adj_passes_compose_to_plain(d, T, C):
    leaves, pref, douts = _elem_problem(d, T, C, seed=d + T)
    L, R, N = leaves.shape
    fac = chunked.elem_scan_adj_factor(leaves, pref)
    assert fac.shape == (L - 1, 3 * d * d + d, N)
    got = chunked.elem_scan_adj_chain(fac, douts)
    _close((got,), (chunked.elem_scan_adj_plain(leaves, pref, douts),))


def test_elem_scan_adj_chain_passes_one_step_through():
    """A one-step chain (L = 1) has no combine: the factor pass is empty
    and the chain hands the cotangent back as it came."""
    leaves, pref, douts = _elem_problem(2, 2, 1, seed=3)
    assert leaves.shape[0] == 1
    fac = chunked.elem_scan_adj_factor(leaves, pref)
    assert fac.shape[0] == 0
    _close((chunked.elem_scan_adj_chain(fac, douts),), (douts,))


@pytest.mark.parametrize("d,T", BIDIR_CASES)
def test_bidir_adj_passes_compose_to_plain(d, T):
    filt = _bidir_problem(d, T, seed=d + T)
    lam = filt[12]
    assert bool((lam[:lam.shape[0] // 2] != 0).all())
    assert not lam[lam.shape[0] // 2:].any()
    T1, dd, NL = filt[2].shape
    fac = bpairs.bidir_adj_factor(*filt[:10])
    assert fac.shape == (T1, 2 * dd + d, NL)
    got = bpairs.bidir_adj_chain(fac, *filt[10:])
    _close(got + (lam.expand(T1, NL),), bpairs.bidir_adj_plain(*filt))


def test_factor_passes_invert_the_step_precisions():
    d = 3
    leaves, pref, _ = _elem_problem(d, 10, 3, seed=1)
    fac = chunked.elem_scan_adj_factor(leaves, pref)
    lanes = lambda X: X.permute(0, 2, 1).reshape(-1, d, d)
    W = lanes(fac[:, 2 * d * d:3 * d * d])
    _, _, J22a, _, _, _ = chunked._unpack(pref[:-1], d)
    J11b = chunked._unpack(leaves[1:], d)[0]
    M = (J22a + J11b).permute(1, 0, 2, 3).reshape(-1, d, d)
    eye = torch.eye(d, dtype=torch.float64)
    np.testing.assert_allclose((W @ M).numpy(), eye.expand_as(M).numpy(),
                               atol=1e-10)
    filt = _bidir_problem(d, 7, seed=1)
    fac = bpairs.bidir_adj_factor(*filt[:10])
    Wb = lanes(fac[:, :d * d])
    Jpre = torch.cat([filt[0][None], filt[8][:-1]])
    Mb = lanes(Jpre + filt[2])
    np.testing.assert_allclose((Wb @ Mb).numpy(), eye.expand_as(Mb).numpy(),
                               atol=1e-10)
    # both are symmetric and positive definite
    for X in (W, Wb):
        np.testing.assert_allclose(X.numpy(), X.mT.numpy(), atol=1e-12)
        assert bool((torch.linalg.eigvalsh(X) > 0).all())


def test_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    leaves, pref, douts = _elem_problem(3, 10, 3, seed=2)
    efac = chunked.elem_scan_adj_factor(leaves, pref)
    filt = _bidir_problem(3, 7, seed=2)
    bfac = bpairs.bidir_adj_factor(*filt[:10])
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [
        (chunked.elem_scan_adj_factor, (leaves, pref)),
        (chunked.elem_scan_adj_chain, (efac, douts)),
        (bpairs.bidir_adj_factor, filt[:10]),
        (bpairs.bidir_adj_chain, (bfac, *filt[10:])),
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
