"""The passes of the port's HMM adjoints (svae_tpu_torch/ops/hmm_fb.py:
the streamed hmm_fb_adj_weights / hmm_fb_adj_chain / hmm_fb_adj_dM, and
the stationary hmm_fb_stat_adj_weights / hmm_fb_adj_chain /
hmm_fb_stat_adj_sums), in float64 on the CPU.

Each pass has a plain version of its own, which the wrappers run on CPU
tensors; composed, they must give the plain adjoint ``hmm_fb_adj_plain``
or ``hmm_fb_stat_adj_plain`` (torch's vector-Jacobian products of the
forward twins, which tests/test_torch_hmm.py holds to the JAX package's
Pallas kernels) at rtol 1e-8 / atol 1e-10. The kernels themselves are held to these plain versions
on a card by tests/test_torch_kernels.py."""

import os
import sys

import numpy as np
import pytest
import torch

from svae_tpu_torch.ops import hmm_fb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-8, 1e-10
# (K, T) at B=5 sequences (10 chains: no multiple of the chains a warp
# holds at any K): the built state counts up to 4 (K=3 leaves a lane of its
# segment idle), one step (T=2, the shortest chain) and a short chain
CASES = [(K, T) for K in (1, 2, 3, 4) for T in (2, 7)]


def _adj_args(li, lt, lo, seed):
    """``hmm_fb_adj``'s arguments on an HMM problem: the packed inputs, the
    plain forward's messages and cotangents drawn from ``seed``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    a0, M = chip_smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_fwd"]
    alpha, beta = hmm_fb.hmm_fb_fwd_plain(a0, M)
    g = torch.Generator().manual_seed(seed)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype)
    return a0, M, alpha, beta, cot(alpha), cot(beta)


def _problem(K, T, seed, case="stationary"):
    """float64 arguments of ``hmm_fb_adj`` on chip_smoke.hmm_problem's
    problem at B=5."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    li, lt, lo, _ = chip_smoke.hmm_problem(dict(B=5, T=T, K=K), seed,
                                           device="cpu", case=case)
    return _adj_args(li, lt, lo, seed)


def _stat_problem(K, T, seed, case="stationary"):
    """float64 arguments of ``hmm_fb_stat_adj`` (a0, LT, lo, alpha, beta,
    dalpha, dbeta) on chip_smoke.hmm_problem's stationary problem at B=5:
    the plain stationary forward's messages, cotangents from ``seed``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    li, lt, lo, _ = chip_smoke.hmm_problem(dict(B=5, T=T, K=K), seed,
                                           device="cpu", case=case)
    args = chip_smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_stat_fwd"]
    alpha, beta = hmm_fb.hmm_fb_stat_fwd_plain(*args)
    g = torch.Generator().manual_seed(seed)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype)
    return (*args, alpha, beta, cot(alpha), cot(beta))


def _stat_passes(a0, LT, lo, alpha, beta, dalpha, dbeta):
    W, V = hmm_fb.hmm_fb_stat_adj_weights(a0, LT, lo, alpha, beta)
    g, h, da0 = hmm_fb.hmm_fb_adj_chain(W, V, dalpha, dbeta)
    dlo, dLT = hmm_fb.hmm_fb_stat_adj_sums(W, V, g, h)
    return (W, V, g, h), (da0, dLT, dlo)


def _sharp(dtype):
    """tests/test_torch_hmm.py's sharp problem: near-deterministic
    transitions and evidence 40 N(0, 1), K=3, B=2, T=12."""
    rng = np.random.default_rng(2)
    K = 3
    li = np.log(np.full(K, 1.0 / K))
    lt = np.log(0.999 * np.eye(K) + 1e-3)
    lo = 40.0 * rng.standard_normal((2, 12, K))
    return _adj_args(*(torch.as_tensor(x, dtype=dtype) for x in (li, lt, lo)),
                     seed=4)


def _passes(a0, M, alpha, beta, dalpha, dbeta):
    W, V = hmm_fb.hmm_fb_adj_weights(a0, M, alpha, beta)
    g, h, da0 = hmm_fb.hmm_fb_adj_chain(W, V, dalpha, dbeta)
    return (W, V, g, h), (da0, hmm_fb.hmm_fb_adj_dM(W, V, g, h))


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("K,T", CASES)
def test_hmm_fb_adj_passes_compose_to_plain(K, T):
    args = _problem(K, T, seed=K + T)
    T1, B = T - 1, 5
    (W, V, g, h), got = _passes(*args)
    assert W.shape == V.shape == (T1, K * K, B)
    assert g.shape == h.shape == (T1, K, B)
    _close(got, hmm_fb.hmm_fb_adj_plain(*args))


@pytest.mark.parametrize("case", ["ragged", "forced"])
def test_hmm_fb_adj_passes_compose_on_hazards(case):
    """Time-varying transitions with uniform pad rows, and a near-forbidden
    switch (log-probability -100) that the observations force."""
    args = _problem(4, 9, seed=1, case=case)
    _close(_passes(*args)[1], hmm_fb.hmm_fb_adj_plain(*args))


def test_weights_are_the_chains_transition_posteriors():
    """Each alpha weight column and each beta weight row is a distribution
    over the other end of the transition: sum_i w_ij = 1 and sum_j v_ij =
    1, every weight in [0, 1]."""
    K, T, B = 3, 7, 5
    a0, M, alpha, beta = _problem(K, T, seed=3)[:4]
    W, V = (x.reshape(T - 1, K, K, B)
            for x in hmm_fb.hmm_fb_adj_weights(a0, M, alpha, beta))
    ones = torch.ones((T - 1, K, B), dtype=torch.float64)
    np.testing.assert_allclose(W.sum(1).numpy(), ones.numpy(), rtol=1e-12)
    np.testing.assert_allclose(V.sum(2).numpy(), ones.numpy(), rtol=1e-12)
    assert bool(((W >= 0) & (W <= 1) & (V >= 0) & (V <= 1)).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharp_messages_keep_the_weights_bounded(dtype):
    """The sharp problem: every weight finite and in [0, 1], every pass's
    output finite, in float32 too; in float64 the passes compose to the
    plain adjoint."""
    args = _sharp(dtype)
    (W, V, g, h), got = _passes(*args)
    for x in (W, V):
        assert bool(torch.isfinite(x).all())
        assert bool(((x >= 0) & (x <= 1)).all())
    assert all(bool(torch.isfinite(x).all()) for x in (g, h, *got))
    if dtype == torch.float64:
        _close(got, hmm_fb.hmm_fb_adj_plain(*args))


def test_hmm_fb_adj_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    a0, M, alpha, beta, dalpha, dbeta = _problem(3, 7, seed=2)
    (W, V, g, h), _ = _passes(a0, M, alpha, beta, dalpha, dbeta)
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [
        (hmm_fb.hmm_fb_adj_weights, (a0, M, alpha, beta)),
        (hmm_fb.hmm_fb_adj_chain, (W, V, dalpha, dbeta)),
        (hmm_fb.hmm_fb_adj_dM, (W, V, g, h)),
        (hmm_fb.hmm_fb_adj, (a0, M, alpha, beta, dalpha, dbeta)),
    ]
    for fn, args in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*meta(args))
        with pytest.raises(TypeError, match="float32"):
            fn(*meta(args, torch.float64))
        bad = list(meta(args))
        shape = bad[1].shape
        bad[1] = torch.empty((shape[0] + 1, *shape[1:]), device="meta")
        with pytest.raises(ValueError, match="inconsistent shapes"):
            fn(*bad)
    W5 = torch.empty((6, 25, 5), device="meta")
    v5 = torch.empty((6, 5, 5), device="meta")
    with pytest.raises(ValueError, match="K=5"):
        hmm_fb.hmm_fb_adj_chain(W5, W5, v5, v5)


@pytest.mark.parametrize("K,T", CASES)
def test_hmm_fb_stat_adj_passes_compose_to_plain(K, T):
    args = _stat_problem(K, T, seed=K + T)
    T1, B = T - 1, 5
    (W, V, g, h), got = _stat_passes(*args)
    assert W.shape == V.shape == (T1, K * K, B)
    assert g.shape == h.shape == (T1, K, B)
    assert got[1].shape == (K, K) and got[2].shape == (T1, K, B)
    _close(got, hmm_fb.hmm_fb_stat_adj_plain(*args))
    # and the wrapper, which composes them on a card, runs the plain
    # adjoint on the CPU
    _close(hmm_fb.hmm_fb_stat_adj(*args), got)


def test_hmm_fb_stat_adj_passes_compose_on_a_forced_switch():
    """A near-forbidden switch (log-probability -100) that the
    observations force, on a stationary chain."""
    args = _stat_problem(4, 9, seed=1, case="forced")
    _close(_stat_passes(*args)[1], hmm_fb.hmm_fb_stat_adj_plain(*args))


@pytest.mark.parametrize("K", [1, 3])
def test_stationary_weights_are_the_streamed_weights_on_LT_plus_lo(K):
    """The stationary weight pass forms M_t(i, j) = LT(i, j) + lo_t(j) as
    it reads and gives the streamed pass's weights on that M, to the last
    bit; and the sums pass's dlo and dLT are the streamed dM summed."""
    a0, LT, lo, alpha, beta, dalpha, dbeta = _stat_problem(K, 7, seed=K)
    T1, _, B = lo.shape
    M = (LT[None, :, :, None] + lo[:, None]).reshape(T1, K * K, B)
    got = hmm_fb.hmm_fb_stat_adj_weights(a0, LT, lo, alpha, beta)
    want = hmm_fb.hmm_fb_adj_weights(a0, M, alpha, beta)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    g, h, _ = hmm_fb.hmm_fb_adj_chain(*want, dalpha, dbeta)
    dlo, dLT = hmm_fb.hmm_fb_stat_adj_sums(*want, g, h)
    dM = hmm_fb.hmm_fb_adj_dM(*want, g, h).reshape(T1, K, K, B)
    _close((dLT, dlo), (dM.sum((0, 3)), dM.sum(1)))


def test_hmm_fb_stat_adj_pass_wrappers_reject_what_the_kernels_do_not_take():
    """Shapes, then dtype and contiguity, then the device: meta tensors
    reach every check without a card."""
    args = _stat_problem(3, 7, seed=2)
    (W, V, g, h), _ = _stat_passes(*args)
    meta = lambda xs, dt=torch.float32: tuple(
        torch.empty(x.shape, dtype=dt, device="meta") for x in xs)
    calls = [(hmm_fb.hmm_fb_stat_adj_weights, args[:5]),
             (hmm_fb.hmm_fb_stat_adj_sums, (W, V, g, h)),
             (hmm_fb.hmm_fb_stat_adj, args)]
    for fn, a in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*meta(a))
        with pytest.raises(TypeError, match="float32"):
            fn(*meta(a, torch.float64))
        strided = list(meta(a))
        strided[2] = strided[2].mT.contiguous().mT
        with pytest.raises(ValueError, match="contiguous"):
            fn(*strided)
        bad = list(meta(a))
        shape = bad[2].shape
        bad[2] = torch.empty((shape[0] + 1, *shape[1:]), device="meta")
        with pytest.raises(ValueError, match="inconsistent shapes"):
            fn(*bad)
    # a stationary matrix that is not (K, K)
    bad = list(meta(args[:5]))
    bad[1] = torch.empty((3, 4), device="meta")
    with pytest.raises(ValueError, match="inconsistent shapes"):
        hmm_fb.hmm_fb_stat_adj_weights(*bad)
    # a state count with no kernel
    W5 = torch.empty((6, 25, 5), device="meta")
    v5 = torch.empty((6, 5, 5), device="meta")
    with pytest.raises(ValueError, match="K=5"):
        hmm_fb.hmm_fb_stat_adj_sums(W5, W5, v5, v5)
    with pytest.raises(ValueError, match="K=5"):
        hmm_fb.hmm_fb_stat_adj_weights(
            torch.empty((5, 5), device="meta"),
            torch.empty((5, 5), device="meta"), v5, v5, v5)
