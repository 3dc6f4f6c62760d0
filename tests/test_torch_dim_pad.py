"""Exact padding of a latent size to the built kernel instance that serves
it (``estep.kernel_dim``), in float64 on the CPU: for every recursion the
card runs, pad -> plain version at d' -> unpad equals the plain version at
d, in values, in the corrected log-normalizer and in the gradients of every
real input. No JAX: the plain versions are held against the JAX package at
every d by the other ``test_torch_*`` files."""

import numpy as np
import pytest
import torch

from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.models import lds
from svae_tpu_torch.ops import bpairs, chunked, estep, kalman, kalman_fwd

DIMS = (1, 5, 11, 17, 31)
B, T, S = 2, 4, 2
RTOL = 1e-10


def _problem(d, seed):
    """Expected potentials of random global params and recognizer-like
    diagonal evidence, float64: ``(init, mats, (jd, h), eps)``."""
    g = torch.Generator().manual_seed(seed)
    glob = lds.init_pgm_param(d, g, dtype=torch.float64, device="cpu")
    (I1, I2), Ic = niw.expected_gaussian_natparam(glob[0])
    mats = mniw.expected_pair_potential(glob[1])
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))
    jd = torch.logaddexp(t(B, T, d), torch.zeros(())) + 0.5
    return (I1, I2, Ic), mats, (jd, t(B, T, d)), t(S, B, T, d)


def _assert_padded_equals(padding, twin, args, seed):
    """pad -> twin at kernel_dim(d) -> unpad against the twin at d: the
    outputs, and the gradients of every input against random cotangents."""
    args = tuple(a.detach().requires_grad_() for a in args)
    d = padding.dim(args)
    dp = estep.kernel_dim(d)
    assert dp > d
    want = twin(*args)
    got = padding.unpad(twin(*padding.pad(args, d, dp)), d, dp)
    want, got = ((w,) if torch.is_tensor(w) else w for w in (want, got))
    gen = torch.Generator().manual_seed(seed)
    cots = [torch.randn(w.shape, generator=gen, dtype=w.dtype) for w in want]
    for w, o in zip(want, got):
        assert o.shape == w.shape
        torch.testing.assert_close(o, w, rtol=RTOL, atol=RTOL)
    used = [a for a in args if a.dtype.is_floating_point]
    gw = torch.autograd.grad(want, used, cots, retain_graph=True,
                             allow_unused=True)
    gg = torch.autograd.grad(got, used, cots, allow_unused=True)
    for a, x, y in zip(used, gw, gg):
        x = torch.zeros_like(a) if x is None else x
        y = torch.zeros_like(a) if y is None else y
        torch.testing.assert_close(y, x, rtol=RTOL, atol=RTOL)


def test_padded_per_step_recursions_equal_unpadded():
    """The stationary filter and sampler (estep), the per-sequence-pairs
    filter and sampler (bpairs) and the shared-pair filters and sampler
    (kalman_fwd), at every d of DIMS (none has an instance of its own)."""
    for d in DIMS:
        _per_step_recursions(d)


def _per_step_recursions(d):
    init, mats, (jd, h), eps = _problem(d, d)
    fin = estep.filter_inputs(init, mats, (jd, h))
    _assert_padded_equals(estep.FILTER_PADDING, estep.filter_fwd_plain, fin,
                          1)
    J, hh, _ = estep.filter_fwd_plain(*fin)
    Jf = torch.cat([fin[0][None, :, :B], J[:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], hh[:, :, :B]])
    sin = estep.sampler_inputs(mats, Jf, hf, eps)[0]
    _assert_padded_equals(estep.SAMPLER_PADDING, estep.sampler_fwd_plain,
                          sin, 2)

    pairs, nodes = lds._chain(mats, (jd, h))
    bin_ = bpairs.bidir_inputs(init, pairs, nodes)
    _assert_padded_equals(bpairs.BIDIR_PADDING, bpairs.bidir_fwd_plain,
                          bin_, 3)
    J, hh, _ = bpairs.bidir_fwd_plain(*bin_)
    Jf, hf = bpairs.messages(bin_, J, hh)[:2]
    sin = bpairs.sampler_inputs(pairs, Jf, hf, eps)[0]
    _assert_padded_equals(bpairs.SAMPLER_PADDING,
                          bpairs.sampler_bp_fwd_plain, sin, 4)

    # shared pairs varied in time, as chip_smoke.kfwd_problem varies them
    r = torch.linspace(0.9, 1.1, T - 1, dtype=torch.float64)[:, None, None]
    kpairs = (r * pairs[0], r * pairs[1], r * pairs[2], pairs[3].clone())
    kin = kalman_fwd.filter_inputs(init, kpairs, nodes)
    _assert_padded_equals(kalman_fwd.FILTER_PADDING,
                          kalman_fwd.filter_shared_plain, kin, 5)
    _assert_padded_equals(kalman_fwd.BACKWARD_PADDING,
                          kalman_fwd.backward_shared_plain,
                          kalman_fwd.backward_inputs(kpairs, nodes), 6)
    J, hh, _ = kalman_fwd.filter_shared_plain(*kin)
    Jf, hf = bpairs._alpha(kin[0], kin[1], J, hh)
    sin = kalman_fwd.sampler_inputs(kpairs, Jf, hf, eps)[0]
    _assert_padded_equals(kalman_fwd.SAMPLER_PADDING,
                          kalman_fwd.sampler_shared_plain, sin, 7)


def test_padded_element_scan_equals_unpadded():
    """The chunked E-step's element scan (chunked.elem_scan_plain) on
    packed leaves folded onto the lanes, pad leaves included, at every d of
    DIMS: the fields, the constant c and the leaves' gradients."""
    for d in DIMS:
        init, mats, nodes, _ = _problem(d, 10 + d)
        pairs, nodes = lds._chain(mats, nodes)
        fold, _, L = chunked._fold(kalman.build_leaves(init, pairs, nodes),
                                   2)
        _assert_padded_equals(chunked.LEAF_PADDING, chunked.elem_scan_plain,
                              (chunked._pack(fold, L),), 8)


def test_kernel_dim_serves_every_d_up_to_32():
    """Every d from 1 to 32 has a built instance at or above it, the least
    such; d = 33 raises, naming d."""
    for d in range(1, 33):
        k = estep.kernel_dim(d)
        assert k in estep.KERNEL_DIMS and k >= d
        assert not [x for x in estep.KERNEL_DIMS if d <= x < k]
    assert estep.kernel_dim(32) == 32
    with pytest.raises(ValueError, match="d=33"):
        estep.kernel_dim(33)


def test_card_route_runs_the_built_instance():
    """Off the CPU (``meta`` tensors stand in for a card's) a recursion at
    an unbuilt d reaches its kernel at kernel_dim(d) and comes back at d; a
    built d reaches it unpadded."""
    seen = []

    def kernel(J0, h0, A, C, D, jd, n2):
        seen.append(h0.shape[0])
        T, dp, NL = jd.shape[0], h0.shape[0], h0.shape[1]
        return (torch.empty((T - 1, dp * dp, NL), device="meta"),
                torch.empty((T - 1, dp, NL), device="meta"),
                torch.empty((NL,), device="meta"))

    for d, dp in ((17, 24), (25, 32), (16, 16), (1, 2)):
        meta = lambda *s: torch.empty(s, device="meta")
        args = (meta(d * d, 2 * B), meta(d, 2 * B), meta(2, d, d),
                meta(2, d, d), meta(2, d, d), meta(T, d, B), meta(T, d, B))
        J, h, ln = estep._forward(kernel, None, None, args,
                                  padding=estep.FILTER_PADDING)
        assert seen[-1] == dp
        assert (J.shape, h.shape, ln.shape) == ((T - 1, d * d, 2 * B),
                                                (T - 1, d, 2 * B), (2 * B,))
