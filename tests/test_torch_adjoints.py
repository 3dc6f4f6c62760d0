"""Parity of the port's E-step adjoints (svae_tpu_torch/ops/estep.py) with
svae_tpu/ops/pallas_estep.py, in float64 on the CPU.

The plain adjoints (``filter_adj_plain``, ``sampler_adj_plain``: autograd
through the forward twins) are held to the Pallas adjoint kernels
``_filter_adj_kernel`` and ``_sampler_adj_kernel`` in interpret mode, each
run once per module; the output mapping that the CUDA wrappers apply to
their kernels' per-lane outputs is held to the same references; and the
E-step's gradients are held to ``jax.grad`` through the Pallas primitives.
Tolerance rtol 1e-8 / atol 1e-10: both sides are float64. No comparison
here needs symmetrizing: the Pallas adjoint symmetrizes M-bar and the
Cholesky cotangent itself, and torch's Cholesky backward returns the same
symmetric cotangent. The kernels themselves are checked on a card by
tests/test_torch_kernels.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.models import lds as jax_lds
from svae_tpu.ops import pallas_estep

from svae_tpu_torch.ops import estep

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, T, d, S = 3, 7, 3, 2
T1 = T - 1


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _lane_sum(x):
    """Per-lane (d*d, 2B) parameter cotangents -> (2, d, d) per direction."""
    return np.asarray(x).reshape(d * d, 2, B).sum(-1).T.reshape(2, d, d)


def _to_frames(x):
    """Stream-layout (T-1, d, 2B) node cotangents -> (2, T, d, B): per
    direction, frame order (forward row t is frame t+1, backward row t is
    frame T-1-t; frame 0 gets none)."""
    x = np.asarray(x)
    out = np.zeros((2, T, d, B))
    out[0, 1:] = x[:, :, :B]
    out[1, 1:] = x[::-1, :, B:]
    return out


@pytest.fixture(scope="module")
def problem():
    """One small chain problem with random cotangents; the JAX references
    (interpret mode) are computed here once."""
    rng = np.random.default_rng(1)
    glob = jax_lds.init_pgm_param(jax.random.key(1), d, dtype=jnp.float64)
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    mats = jax_mniw.expected_pair_potential(glob[1])
    E1, E2, E3, _ = (np.asarray(m) for m in mats)
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))
    eps = rng.standard_normal((S, B, T, d))

    # the filter in the port's layout, and its outputs from the twin
    init = tuple(_t(x) for x in (I1, I2, Ic))
    fin = estep.filter_inputs(init, tuple(_t(m) for m in mats),
                              (_t(jd), _t(h)))
    J, hh, ln = estep.filter_fwd_plain(*fin)
    dJ, dh = rng.standard_normal(J.shape), rng.standard_normal(hh.shape)
    dln = rng.standard_normal(ln.shape)
    filt = (*fin, J, hh, _t(dJ), _t(dh), _t(dln))

    # ... and in the Pallas kernel's: per-lane whole operands, node streams
    # with the backward half flipped, the pre-step messages
    J0, h0, A, C, D, jdT, hT = (x.numpy() for x in fin)
    lanes = lambda M: np.repeat(M.reshape(2, d * d).T, B, axis=1)
    stream = lambda x: np.concatenate([x[1:], x[::-1][:T - 1]], axis=-1)
    wfwd = (np.arange(2 * B) < B).astype(np.float64)[None]
    Jpre = np.concatenate([J0[None], J.numpy()[:-1]])
    hpre = np.concatenate([h0[None], hh.numpy()[:-1]])
    filt_ref = pallas_estep._filter_adj_call(
        *(jnp.asarray(x) for x in (lanes(D), wfwd, Jpre, hpre, lanes(A),
                                   stream(jdT), stream(hT), dJ, dh,
                                   dln[None])),
        d=d, U=1, interpret=True)

    # the sampler on the forward messages, with fresh noise and cotangent
    Jf = torch.cat([fin[0][None, :, :B], J[:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], hh[:, :, :B]])
    sin, _ = estep.sampler_inputs(tuple(_t(m) for m in mats), Jf, hf,
                                  _t(eps))
    x = estep.sampler_fwd_plain(*sin)
    dx = rng.standard_normal(x.shape)
    samp = (*sin, x, _t(dx))
    P2, P3, Jf1, hf1, _, xT = (a.numpy() for a in sin)
    tile = lambda a: np.concatenate([a] * S, axis=-1)
    whole = lambda M: np.broadcast_to(M.reshape(d * d, 1), (d * d, S * B))
    xnext = np.concatenate([x.numpy()[1:], xT[None]])
    samp_ref = pallas_estep._sampler_adj_call(
        *(jnp.asarray(a) for a in (whole(P2), whole(P3), tile(Jf1),
                                   tile(hf1), x.numpy(), xnext, dx)),
        d=d, U=1, interpret=True)

    # whole E-step gradients: jax.grad through the Pallas primitives
    w = [rng.standard_normal(s) for s in
         [(S, B, T, d), (d, d), (d,), (d, d), (d, d), (d, d)]] + [2.0]
    jinit, jmats = (I1, I2, Ic), tuple(mats)

    def loss_jax(init, mats, jd, h):
        s, (niw_s, mniw_s), kl = pallas_estep.lds_estep_stationary(
            init, mats, (jd, h), None, S, block_b=8, interpret=True,
            eps=eps)
        return _score(jnp, s, niw_s, mniw_s, kl, w)

    # without XLA's backend optimizations, which change no float64 value
    args = (jinit, jmats, jnp.asarray(jd), jnp.asarray(h))
    grads_ref = jax.jit(jax.grad(loss_jax, argnums=(0, 1, 2, 3))).lower(
        *args).compile({"xla_backend_optimization_level": 0})(*args)
    return dict(filt=filt, filt_ref=filt_ref, samp=samp, samp_ref=samp_ref,
                init=init, mats=tuple(_t(m) for m in mats), jd=_t(jd),
                h=_t(h), eps=_t(eps), w=w, grads_ref=grads_ref)


def _score(xp, samples, niw_s, mniw_s, kl, w):
    """A scalar that weighs every output of the E-step: the samples, the
    NIW (E[x1 x1^T], E[x1]) and MNIW sums, and the local KL."""
    parts = (samples, niw_s[0], niw_s[1], mniw_s[0], mniw_s[1], mniw_s[2])
    return sum((xp.asarray(wi) * p).sum() for wi, p in zip(w, parts)) + \
        w[-1] * kl


def test_filter_adj_plain_matches_pallas_kernel(problem):
    dJ0, dh0, dA, dC, dD, djd, dn2 = estep.filter_adj_plain(*problem["filt"])
    djd_r, dn2_r, dA_r, dC_r, dD_r, dJ0_r, dh0_r = problem["filt_ref"]
    _close(dJ0, dJ0_r)
    _close(dh0, dh0_r)
    for port, ref in ((dA, dA_r), (dC, dC_r), (dD, dD_r)):
        _close(port, _lane_sum(ref))
    _close(djd, _to_frames(djd_r).sum(0))
    _close(dn2, _to_frames(dn2_r).sum(0))


@pytest.mark.parametrize("device,plain,grad_mode,requires_grad,want", [
    ("cpu", False, True, True, "twin"),
    ("meta", True, True, True, "twin"),
    ("meta", False, True, True, "function"),
    ("meta", False, False, True, "kernel"),
    ("meta", False, True, False, "kernel"),
])
def test_forward_route(device, plain, grad_mode, requires_grad, want):
    """A forward recursion runs its twin on the CPU or with ``plain``; off
    the CPU (``meta`` stands in for a card) it runs its autograd Function
    only where a gradient can be taken, and else the kernel directly."""
    x = torch.zeros(2, device=device, requires_grad=requires_grad)
    function = types.SimpleNamespace(apply=lambda *a: "function")
    with torch.set_grad_enabled(grad_mode):
        got = estep._forward(lambda *a: "kernel", lambda *a: "twin",
                             function, (x, x.detach()), plain)
    assert got == want


def test_sampler_adj_plain_matches_pallas_kernel(problem):
    dP2, dP3, dJf, dhf, dxT = estep.sampler_adj_plain(*problem["samp"])
    dJc_r, dhf_r, dxT_r, dP2_r = (np.asarray(a) for a in problem["samp_ref"])
    per_seq = lambda a: a.reshape(a.shape[0], a.shape[1], S, B).sum(2)
    _close(dJf, per_seq(dJc_r))
    _close(dhf, per_seq(dhf_r))
    _close(dxT, dxT_r)
    _close(dP2, dP2_r.sum(1).reshape(d, d))
    _close(dP3, -2.0 * dJc_r.sum((0, 2)).reshape(d, d))


@pytest.mark.parametrize("kernel", ["filter", "sampler"])
def test_wrapper_output_mapping_on_pallas_lane_outputs(problem, kernel):
    """The CUDA wrappers' mapping of per-lane kernel outputs (direction
    sum, lane sums, S-sum, dP3 = -2 sum dJc), applied to the Pallas
    adjoint's per-lane outputs, gives the plain adjoint."""
    if kernel == "filter":
        djd_r, dn2_r, dA_r, dC_r, dD_r, dJ0_r, dh0_r = problem["filt_ref"]
        dnode = _t(np.stack([_to_frames(djd_r), _to_frames(dn2_r)]))
        dpar = _t(np.stack([dA_r, dC_r, dD_r]))
        got = estep._filter_adj_outputs(dnode, _t(dJ0_r), _t(dh0_r), dpar,
                                        d, B)
        want = estep.filter_adj_plain(*problem["filt"])
    else:
        got = estep._sampler_adj_outputs(
            *(_t(a) for a in problem["samp_ref"]), B)
        want = estep.sampler_adj_plain(*problem["samp"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b.numpy())


def _requires_grad(tree):
    return tuple(x.detach().clone().requires_grad_() for x in tree)


def test_estep_grads_match_jax(problem):
    """Gradients of a scalar of (samples, statistics, local KL) with
    respect to (init, pair matrices, jd, h): the port on the CPU (torch's
    autograd through the twins) against jax.grad through the Pallas
    primitives, whose backward runs both adjoint kernels."""
    init, mats = _requires_grad(problem["init"]), _requires_grad(
        problem["mats"])
    jd, h = _requires_grad((problem["jd"], problem["h"]))
    s, (niw_s, mniw_s), kl = estep.lds_estep_stationary(
        init, mats, (jd, h), None, S, eps=problem["eps"])
    loss = _score(torch, s, niw_s, mniw_s, kl, problem["w"])
    got = torch.autograd.grad(loss, (*init, *mats, jd, h))
    want = jax.tree.leaves(problem["grads_ref"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("fn", ["filter", "sampler"])
def test_functions_backward_matches_twin_autograd(problem, fn):
    """FilterFwd / SamplerFwd wire the adjoints onto the forward's inputs:
    on the CPU their forward runs the twin and their backward the plain
    adjoint, and their gradients equal torch's autograd of the twin."""
    if fn == "filter":
        fwd_in, cots = problem["filt"][:7], problem["filt"][9:]
        apply, twin = estep.FilterFwd.apply, estep.filter_fwd_plain
    else:
        fwd_in, cots = problem["samp"][:6], problem["samp"][7:]
        apply, twin = estep.SamplerFwd.apply, estep.sampler_fwd_plain
    grads = []
    for f in (apply, twin):
        ins = _requires_grad(fwd_in)
        out = f(*ins)
        out = out if isinstance(out, tuple) else (out,)
        loss = sum((o * c).sum() for o, c in zip(out, cots))
        grads.append(torch.autograd.grad(loss, ins, allow_unused=True))
    for i, (a, b) in enumerate(zip(*grads)):
        if fn == "sampler" and i == 4:      # the noise: no cotangent
            assert a is None
        else:
            _close(a, b.numpy())


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _adj_args(kernel, dt=torch.float32):
    dd, NL, SB = d * d, 2 * B, S * B
    if kernel == "filter_adj":
        shapes = [(dd, NL), (d, NL), (2, d, d), (2, d, d), (2, d, d),
                  (T, d, B), (T, d, B), (T1, dd, NL), (T1, d, NL),
                  (T1, dd, NL), (T1, d, NL), (NL,)]
    else:
        shapes = [(d, d), (d, d), (T1, dd, B), (T1, d, B), (T1, d, SB),
                  (d, SB), (T1, d, SB), (T1, d, SB)]
    return [_meta(s, dt) for s in shapes]


@pytest.mark.parametrize("kernel", ["filter_adj", "sampler_adj"])
def test_adjoint_wrappers_reject_what_the_kernels_do_not_take(kernel):
    """Off the CPU a wrapper launches its kernel or raises; on tensors that
    are neither CPU nor CUDA (``meta``) its checks run without a card."""
    wrapper = getattr(estep, kernel)
    with pytest.raises(TypeError, match="float32"):
        wrapper(*_adj_args(kernel, torch.float64))
    args = _adj_args(kernel)
    bad = list(args)
    bad[-1] = _meta((1, 2))
    with pytest.raises(ValueError, match="inconsistent shapes"):
        wrapper(*bad)
    strided = list(args)
    strided[2] = args[2].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*strided)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    mixed = list(args)
    mixed[2] = torch.empty(args[2].shape)           # one CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*mixed)
    assert wrapper.launches == 0
