"""Parity of the port's ragged-batch path (svae_tpu_torch/ops/bpairs.py,
models/lds.py ``lengths=``, train/ ``ragged=`` and ``run_loader``,
data/loader.py and data/masking.py) with the JAX package, in float64 on
the CPU.

* The forward twins and plain adjoints of the four bpairs kernels are held
  to the Pallas kernels ``pallas_bidir._bidir_fwd_kernel`` /
  ``_bidir_adj_kernel`` and ``pallas_vjp._sampler_fwd_kernel`` /
  ``_sampler_adj_kernel``, called directly in interpret mode (U=1) on the
  same inputs and random cotangents.
* ``run_inference(lengths=)`` and ``posterior_moments(lengths=)`` are held
  to the JAX package's vmapped scan path (``backend="xla"``).
* Samples and one ragged ``make_gradfun(ragged=True)`` step are held to the
  JAX package's Pallas composition (``_ragged_pairs`` -> ``fb_pass`` ->
  ``_smoother_assembly`` -> ``lds_sample``, interpret mode) under the same
  noise.
* The loader's batches and lengths, ``pad_batch``, ``nan_mask`` and
  ``run_loader``'s callback cadence and history are held to the JAX
  package's.

Every JAX reference is computed once, in a module fixture. Tolerance rtol
1e-8 / atol 1e-10 (both sides float64) unless a test says otherwise."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.data import loader as jax_loader
from svae_tpu.data import masking as jax_masking
from svae_tpu.data import synthetic as jax_synthetic
from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.models import lds as jax_lds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.ops import pallas_bidir, pallas_vjp
from svae_tpu.train import elbo as jax_elbo
from svae_tpu.train import loop as jax_loop

from svae_tpu_torch import convert
from svae_tpu_torch.data import loader, masking
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.ops import bpairs
from svae_tpu_torch.train import elbo, loop
from svae_tpu_torch.utils.pytree import tree_leaves

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, T, d, S = 3, 7, 3, 2
T1 = T - 1
LENGTHS = np.array([7, 4, 2])
D_OBS, N = 6, 40
F64 = dict(dtype=torch.float64, device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=rtol, atol=atol)


def _jax_run_inference(prior, glob, pots, key, num_samples, lengths=None):
    """lds.run_inference(backend="pallas", lengths=) spelled out, with the
    Pallas kernels in interpret mode and ``key`` carrying the noise."""
    J_diag, h = pots
    Bn, Tn = h.shape[:2]
    J_diag, h = jax_lds.mask_potentials(
        (J_diag, h), jax_lds._evidence_mask(None, lengths, Bn, Tn, h.dtype))
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    mats = jax_mniw.expected_pair_potential(glob[1])
    pairs = jax_lds._ragged_pairs(
        tuple(jnp.broadcast_to(p, (Tn - 1,) + p.shape) for p in mats),
        lengths, Tn, h.dtype)
    N1 = -0.5 * jnp.vectorize(jnp.diag, signature="(d)->(d,d)")(J_diag)
    init, nodes = (I1, I2, Ic), (N1, h)
    logZ, Jf, hf, Jb, hb = pallas_vjp.fb_pass(init, pairs, nodes, block_b=8,
                                              interpret=True)
    Ex, ExxT, Exnxt = pallas_vjp._smoother_assembly(pairs, nodes, Jf, hf, Jb,
                                                    hb)
    samples = pallas_vjp.lds_sample(init, pairs, nodes, None, num_samples,
                                    block_b=8, interpret=True,
                                    filtered=(Jf, hf), eps=key)
    # the statistics of lds._batched_inference_pallas with valid weights
    valid = jax_lds._length_mask(lengths, Bn, Tn, h.dtype)
    local_kl = jnp.sum(N1 * ExxT) + jnp.sum(h * Ex) - jnp.sum(logZ)
    cnt = jnp.asarray(Bn, h.dtype)
    w = valid[:, 1:, None, None]
    stats = ((jnp.sum(ExxT[:, 0], 0), jnp.sum(Ex[:, 0], 0), cnt, cnt),
             (jnp.sum(w * ExxT[:, 1:], (0, 1)),
              jnp.sum(w * jnp.swapaxes(Exnxt, -1, -2), (0, 1)),
              jnp.sum(w * ExxT[:, :-1], (0, 1)), jnp.sum(valid) - cnt))
    return samples, stats, jax_lds.prior_kl(glob, prior), local_kl


JAX_PARTS = (_jax_run_inference, jax_recognition.mlp_recognize,
             jax_decoders.mlp_loglike)


@pytest.fixture(scope="module")
def model():
    """A small ragged problem in both packages, and the JAX references of
    the model-level tests (the XLA scan path, the Pallas composition's
    samples and one ragged gradient step)."""
    k = jax.random.split(jax.random.key(11), 4)
    prior = jax_lds.init_pgm_param(k[0], d, dtype=jnp.float64)
    glob = jax_lds.init_pgm_param(k[1], d, dtype=jnp.float64)
    rp = jax_recognition.init_mlp_recognize(k[2], D_OBS, (8,), d,
                                            dtype=jnp.float64)
    dp = jax_decoders.init_mlp_decode(k[3], d, (8,), D_OBS, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))          # pad frames: garbage
    mask = (rng.random((B, T)) > 0.3).astype(np.float64)
    eps = rng.standard_normal((S, B, T, d))
    y = jax_synthetic.make_dot_data(seed=3, num_seqs=B, T=T,
                                    image_width=D_OBS).astype(np.float64)
    gradfun = jax_elbo.make_gradfun(*JAX_PARTS, prior, N, num_samples=S,
                                    ragged=True)

    @jax.jit     # one compile: eager dispatch of these takes 3-4x longer
    def references(jd, h, mask, eps, y):
        pots = (jd, h)
        return dict(
            xla=jax_lds.run_inference(prior, glob, pots, jax.random.key(2),
                                      S, backend="xla", lengths=LENGTHS,
                                      mask=mask),
            moments=jax_lds.posterior_moments(glob, pots, lengths=LENGTHS,
                                              backend="xla"),
            pallas=_jax_run_inference(prior, glob, pots, eps, S,
                                      lengths=LENGTHS),
            grad_out=gradfun(glob, (rp, dp), (y, LENGTHS), eps))

    natparam = functools.partial(convert.natparam, **F64)
    return dict(prior=natparam(_np(prior)), glob=natparam(_np(glob)),
                nets=(convert.recognizer(_np(rp), **F64),
                      convert.decoder(_np(dp), **F64)),
                jd=jd, h=h, mask=mask, eps=eps, y=y,
                **references(jd, h, mask, eps, y))


def _pots(m):
    return torch.from_numpy(m["jd"]), torch.from_numpy(m["h"])


# --------------------------------------------------------------------------
# (a) the twins and plain adjoints against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kernels():
    """The four kernels' inputs in the port's layout (from the twins, with
    random cotangents) and the Pallas kernels' outputs on the same inputs,
    each called directly in interpret mode with U=1."""
    rng = np.random.default_rng(8)
    glob = jax_lds.init_pgm_param(jax.random.key(3), d, dtype=jnp.float64)
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    mats = tuple(_t(m) for m in jax_mniw.expected_pair_potential(glob[1]))
    jd = _t(np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4)
    h = _t(rng.standard_normal((B, T, d)))
    jd, h, _ = lds._prepare((jd, h), None, torch.from_numpy(LENGTHS))
    pairs, nodes = lds._chain(mats, (jd, h), torch.from_numpy(LENGTHS))
    init = tuple(_t(x) for x in (I1, I2, Ic))

    fin = bpairs.bidir_inputs(init, pairs, nodes)
    J, hh, ln = bpairs.bidir_fwd_plain(*fin)
    cot = lambda x: _t(rng.standard_normal(x.shape))
    filt = (*fin, J, hh, cot(J), cot(hh), cot(ln))
    Jf, hf = bpairs.messages(fin, J, hh)[:2]
    sin, _ = bpairs.sampler_inputs(pairs, Jf, hf,
                                   _t(rng.standard_normal((S, B, T, d))))
    x = bpairs.sampler_bp_fwd_plain(*sin)
    samp = (*sin, x, cot(x))

    j = lambda *xs: tuple(jnp.asarray(a.numpy()) for a in xs)
    J0, h0, A, C, D, E, F, Pc = fin
    fwd_ref = pallas_bidir._bidir_fwd_call(*j(J0, h0, A, C, D, E, F,
                                              Pc[:, None]),
                                           d=d, U=1, interpret=True)
    Jpre = torch.cat([J0[None], J[:-1]])
    hpre = torch.cat([h0[None], hh[:-1]])
    adj_ref = pallas_bidir._bidir_adj_call(
        *j(D, Jpre + A, hpre + F, filt[10], filt[11], filt[12][None]),
        d=d, U=1, interpret=True)
    # the Pallas sampler takes the per-sequence blocks per lane, S-tiled
    tile = lambda a: a.repeat(1, 1, S)
    P2, P3, Jft, hft, epsf, xT = sin
    samp_fwd_ref = pallas_vjp._sampler_fwd_call(
        *j(tile(P2), tile(P3), tile(Jft), tile(hft), epsf, xT), d=d, U=1,
        interpret=True)
    xnext = torch.cat([x[1:], xT[None]])
    samp_adj_ref = pallas_vjp._sampler_adj_call(
        *j(tile(P2), tile(P3), tile(Jft), tile(hft), x, xnext, samp[7]),
        d=d, U=1, interpret=True)
    return dict(filt=filt, samp=samp, fwd_ref=fwd_ref, adj_ref=adj_ref,
                samp_fwd_ref=samp_fwd_ref, samp_adj_ref=samp_adj_ref)


def test_bidir_twin_matches_pallas_kernel(kernels):
    J, h, ln = bpairs.bidir_fwd_plain(*kernels["filt"][:8])
    J_r, h_r, ln_r = kernels["fwd_ref"]
    _close((J, h, ln), (J_r, h_r, ln_r[0]))


def test_bidir_adj_plain_matches_pallas_kernel(kernels):
    dJ0, dh0, dA, dC, dD, dE, dF, dPc = bpairs.bidir_adj_plain(
        *kernels["filt"])
    dC_r, de_r, df_r, dD_r, dA_r, dJ0_r, dh0_r = kernels["adj_ref"]
    _close((dJ0, dh0, dA, dC, dD, dE, dF),
           (dJ0_r, dh0_r, dA_r, dC_r, dD_r, de_r, df_r))
    _close(dPc, np.broadcast_to(kernels["filt"][12].numpy(), dPc.shape))


def test_sampler_twin_matches_pallas_kernel(kernels):
    _close(bpairs.sampler_bp_fwd_plain(*kernels["samp"][:6]),
           kernels["samp_fwd_ref"])


@pytest.mark.parametrize("route", ["plain", "kernel_outputs"])
def test_sampler_adj_matches_pallas_kernel(kernels, route):
    """The plain adjoint, and the three passes the CUDA route runs (their
    plain versions, to which the kernels are held on a card: the factor
    pass's W, the chain's per-lane b-bar, which is the Pallas adjoint's
    per-lane dhf, and the dJc pass's sum over the samples of a sequence,
    dP3 = -2 sum dJc), against the Pallas adjoint's per-lane outputs
    summed over the samples."""
    dJc_r, dhf_r, dP2_r, dxT_r = (np.asarray(a)
                                  for a in kernels["samp_adj_ref"])
    fold = lambda a: a.reshape(a.shape[0], a.shape[1], S, B).sum(2)
    want = (fold(dP2_r), -2.0 * fold(dJc_r), fold(dJc_r), fold(dhf_r), dxT_r)
    if route == "plain":
        got = bpairs.sampler_bp_adj_plain(*kernels["samp"])
    else:
        P2, P3, Jf, hf, eps, xT, x, dx = kernels["samp"]
        bbar, dxT = bpairs.sampler_bp_adj_chain(
            bpairs.sampler_bp_adj_factor(P3, Jf), P2, dx)
        _close(bbar, dhf_r)
        got = bpairs.sampler_bp_adj_dJc(P2, P3, Jf, hf, eps, xT, x,
                                        bbar) + (dxT,)
    _close(got, want)


def _requires_grad(tree):
    return tuple(x.detach().clone().requires_grad_() for x in tree)


@pytest.mark.parametrize("fn", ["bidir", "sampler"])
def test_functions_backward_matches_twin_autograd(kernels, fn):
    """BidirFwd / SamplerBp wire the adjoints onto the forward's inputs: on
    the CPU their backward runs the plain adjoint, and their gradients
    equal torch's autograd of the twin."""
    if fn == "bidir":
        fwd_in, cots = kernels["filt"][:8], kernels["filt"][10:]
        apply, twin = bpairs.BidirFwd.apply, bpairs.bidir_fwd_plain
    else:
        fwd_in, cots = kernels["samp"][:6], kernels["samp"][7:]
        apply, twin = bpairs.SamplerBp.apply, bpairs.sampler_bp_fwd_plain
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


def _meta(shape, dt=torch.float32):
    return torch.empty(shape, dtype=dt, device="meta")


def _kernel_args(kernel, dt=torch.float32):
    dd, NL, SB = d * d, 2 * B, S * B
    bidir = [(dd, NL), (d, NL)] + [(T1, dd, NL)] * 3 + [(T1, d, NL)] * 2 + \
        [(T1, NL)]
    samp = [(T1, dd, B)] * 3 + [(T1, d, B), (T1, d, SB), (d, SB)]
    shapes = {"bidir_fwd": bidir,
              "bidir_adj": bidir + [(T1, dd, NL), (T1, d, NL)] * 2 + [(NL,)],
              "sampler_bp_fwd": samp,
              "sampler_bp_adj": samp + [(T1, d, SB)] * 2}[kernel]
    return [_meta(s, dt) for s in shapes]


@pytest.mark.parametrize("kernel", ["bidir_fwd", "bidir_adj",
                                    "sampler_bp_fwd", "sampler_bp_adj"])
def test_wrappers_reject_what_the_kernels_do_not_take(kernel):
    """Off the CPU a wrapper launches its kernel or raises; on tensors that
    are neither CPU nor CUDA (``meta``) its checks run without a card."""
    wrapper = getattr(bpairs, kernel)
    with pytest.raises(TypeError, match="float32"):
        wrapper(*_kernel_args(kernel, torch.float64))
    args = _kernel_args(kernel)
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
    assert wrapper.launches == 0


# --------------------------------------------------------------------------
# (b) the model against the JAX scan path; (c) against its Pallas path
# --------------------------------------------------------------------------


def test_run_inference_lengths_matches_jax_scan_path(model):
    """Statistics, global and local KL of a ragged batch with an evidence
    mask inside the real frames."""
    samples, stats, gkl, lkl = lds.run_inference(
        model["prior"], model["glob"], _pots(model),
        torch.Generator().manual_seed(0), S,
        mask=torch.from_numpy(model["mask"]),
        lengths=torch.from_numpy(LENGTHS))
    s_r, stats_r, gkl_r, lkl_r = model["xla"]
    assert samples.shape == s_r.shape
    _close((stats, gkl, lkl), (stats_r, gkl_r, lkl_r))


def test_posterior_moments_lengths_matches_jax_scan_path(model):
    """Moments of every frame, pad frames included (the dummy chain)."""
    out = lds.posterior_moments(model["glob"], _pots(model),
                                lengths=torch.from_numpy(LENGTHS))
    _close(out, model["moments"])


def test_samples_match_jax_pallas_composition(model):
    """Samples, statistics and local KL under a shared noise against the
    JAX package's per-sequence-pairs Pallas path."""
    samples, stats, gkl, lkl = lds.run_inference(
        model["prior"], model["glob"], _pots(model), None, S,
        lengths=torch.from_numpy(LENGTHS), eps=torch.from_numpy(model["eps"]))
    _close((samples, stats, gkl, lkl), model["pallas"])


def test_ragged_gradfun_matches_jax(model):
    """ELBO, natural gradient, net gradients and terms of one ragged step
    against jax.grad through the Pallas composition (adjoint kernels in
    interpret mode); pad frames drop out of the decoder term."""
    gradfun = elbo.make_gradfun(
        functools.partial(lds.run_inference,
                          eps=torch.from_numpy(model["eps"])),
        recognition.mlp_recognize, decoders.mlp_loglike, model["prior"], N,
        num_samples=S, ragged=True)
    value, natgrad, net_grads, terms = gradfun(
        model["glob"], model["nets"],
        (torch.from_numpy(model["y"]), torch.from_numpy(LENGTHS)), None)
    v_r, nat_r, grads_r, terms_r = model["grad_out"]
    _close((value, natgrad, net_grads), (v_r, nat_r, grads_r))
    assert sorted(terms) == sorted(terms_r)
    for k in terms_r:
        _close(terms[k], terms_r[k])


# --------------------------------------------------------------------------
# (d) the padded-batch theorem; (g) lengths need a batch
# --------------------------------------------------------------------------


def test_padded_batch_matches_unpadded_sequences(model):
    """A padded batch with lengths= gives the summed statistics and local
    KL of its sequences run alone, and counts only real transitions."""
    jd, h = _pots(model)
    prior, glob = model["prior"], model["glob"]
    alone = [lds.run_inference(prior, glob, (jd[i:i + 1, :n],
                                             h[i:i + 1, :n]),
                               torch.Generator().manual_seed(i), 1)
             for i, n in enumerate(LENGTHS)]
    _, stats, _, lkl = lds.run_inference(
        prior, glob, (jd, h), torch.Generator().manual_seed(9), 1,
        lengths=torch.from_numpy(LENGTHS))
    want = [sum(leaves) for leaves in
            zip(*(tree_leaves(o[1]) for o in alone))]
    tol = dict(rtol=1e-9, atol=1e-9)
    _close(stats, want, **tol)
    _close(lkl, sum(float(o[3]) for o in alone), **tol)
    assert float(stats[1][3]) == (LENGTHS - 1).sum()
    assert float(stats[0][2]) == B


def test_lengths_require_batched_potentials(model):
    pots = tuple(x[0] for x in _pots(model))
    with pytest.raises(ValueError, match="batched"):
        lds.run_inference(model["prior"], model["glob"], pots, None, S,
                          lengths=torch.tensor([T]))
    with pytest.raises(ValueError, match="batched"):
        lds.posterior_moments(model["glob"], pots, lengths=torch.tensor([T]))


# --------------------------------------------------------------------------
# (e) the loader and masking helpers; (f) run_loader
# --------------------------------------------------------------------------


def _corpus(seed=0, n=23, lo=3, hi=30):
    rng = np.random.RandomState(seed)
    return [rng.randn(int(rng.randint(lo, hi)), 4).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("group_by_shape", [False, True])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (5, 3)])
def test_ragged_epoch_batches_match_jax(seed, epoch, group_by_shape):
    seqs = _corpus(seed)
    kw = dict(seed=seed, epoch=epoch, pad_multiple=8,
              group_by_shape=group_by_shape)
    got = list(loader.ragged_epoch_batches(seqs, 4, **kw))
    want = list(jax_loader.ragged_epoch_batches(seqs, 4, **kw))
    assert len(got) == len(want) == 6          # the tail batch of 3 kept
    for (b, n), (b_r, n_r) in zip(got, want):
        np.testing.assert_array_equal(b, b_r)
        np.testing.assert_array_equal(n, n_r)
        assert b.shape[1] % 8 == 0
    dense = np.stack([s[:3] for s in seqs])
    for a, a_r in zip(loader.epoch_batches(dense, 5, seed, epoch),
                      jax_loader.epoch_batches(dense, 5, seed, epoch)):
        np.testing.assert_array_equal(a, a_r)


def test_pad_batch_and_nan_mask_match_jax():
    seqs = _corpus(1, n=3)
    for kw in ({}, {"T": 32, "dtype": np.float64}):
        got, want = masking.pad_batch(seqs, **kw), \
            jax_masking.pad_batch(seqs, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(ValueError, match="longer"):
        masking.pad_batch(seqs, T=2)
    x = np.random.default_rng(0).standard_normal((2, 5, 3))
    x[0, 1, 2], x[1, 4, 0] = np.nan, np.inf
    for a, b in zip(masking.nan_mask(torch.from_numpy(x)),
                    jax_masking.nan_mask(jnp.asarray(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_make_loader_prefetches_the_same_batches():
    """make_loader on a ragged corpus yields the NumPy epoch as tensors on
    the requested device, in order, with two batches in flight."""
    seqs = _corpus(2)
    got = list(loader.make_loader(seqs, 4, seed=2, device="cpu")(1))
    want = list(loader.ragged_epoch_batches(seqs, 4, seed=2, epoch=1))
    assert len(got) == len(want)
    for (b, n), (b_r, n_r) in zip(got, want):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), b_r)
        np.testing.assert_array_equal(n.numpy(), n_r)
    dense = loader.make_loader(np.zeros((10, 2)), 3, device="cpu")(0)
    assert [tuple(b.shape) for b in dense] == [(3, 2)] * 3


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_run_loader_cadence_matches_jax(steps_per_dispatch):
    """run_loader fires its callback on the JAX package's cadence, group
    boundaries included, and returns the same ELBO history, on the same
    bucketed epochs of a ragged corpus."""
    seqs = _corpus(3)
    kw = dict(seed=4, pad_multiple=16, group_by_shape=True)
    fired, fired_j = [], []
    _, _, _, history, _ = loop.run_loader(
        lambda p, n, s, b, g: (p, n, s, b[0].sum(), {"x": 0.0}), (), (), (),
        loader.make_loader(seqs, 4, device="cpu", **kw), None, num_epochs=2,
        callback_every=3, steps_per_dispatch=steps_per_dispatch,
        callback=lambda i, e, *_: fired.append((i, e)))
    _, _, _, history_j, _ = jax_loop.run_loader(
        lambda p, n, s, b, k: (p, n, s, jnp.sum(b[0]), {"x": 0.0}), (), (),
        (), jax_loader.make_loader(seqs, 4, prefetch=0, **kw),
        jax.random.key(0), num_epochs=2, callback_every=3,
        steps_per_dispatch=steps_per_dispatch, donate_groups=False,
        callback=lambda i, e, *_: fired_j.append((i, e)))
    assert len(history) == 12
    np.testing.assert_allclose(history, history_j, rtol=1e-6)
    assert [i for i, _ in fired] == [i for i, _ in fired_j]
    np.testing.assert_allclose([e for _, e in fired],
                               [e for _, e in fired_j], rtol=1e-6)


def test_run_loader_trains_on_ragged_batches():
    """A ragged train step through run_loader: finite history, one step
    per batch, and the same trajectory whatever steps_per_dispatch."""
    g = torch.Generator().manual_seed(0)
    prior, glob = (lds.init_pgm_param(d, g, **F64) for _ in range(2))
    nets = (recognition.init_mlp_recognize(4, (8,), d, g, **F64),
            decoders.init_mlp_decode(d, (8,), 4, g, **F64))
    seqs = [s.astype(np.float64) for s in _corpus(4, n=9, lo=3, hi=12)]
    init, step = loop.make_train_step(
        lds.run_inference, recognition.mlp_recognize, decoders.mlp_loglike,
        prior, len(seqs), num_samples=1, ragged=True)
    get = loader.make_loader(seqs, 3, seed=1, device="cpu", pad_multiple=4)
    histories = []
    for k in (1, 2):
        nets_k = copy.deepcopy(nets)
        out = loop.run_loader(step, glob, nets_k, init(glob, nets_k), get,
                              torch.Generator().manual_seed(3), num_epochs=2,
                              steps_per_dispatch=k)
        histories.append(out[3])
        assert out[2].step == 6
    assert len(histories[0]) == 6 and np.isfinite(histories[0]).all()
    assert histories[0] == histories[1]


# --------------------------------------------------------------------------
# (h) the JAX package's interleaved layout (kernels #10, #6, #8, #11)
# --------------------------------------------------------------------------


def test_fb_pass_matches_interleaved_layout():
    """``bpairs.fb_pass`` against ``pallas_vjp.fb_pass(bidir=False)``, the
    interleaved layout that the JAX package picks itself when B mod
    block_b lies outside [1, block_b / 2] (B=5 of block_b=8 here): values,
    and the gradients of a random-weighted sum of every output with
    respect to the initial, pair and node potentials, which run that
    layout's adjoint kernels ``_filter_adj_kernel`` and
    ``_backward_adj_kernel`` in interpret mode, and, with
    ``fused_adj=True``, its fused mixed-direction adjoint ``_fb_adj_kernel``
    instead. On the card both layouts are the bpairs kernels' lanes, and
    ``bidir_adj`` runs both directions' adjoints in one launch."""
    Bi, Ti, di = 5, 4, 2
    rng = np.random.default_rng(12)
    glob = jax_lds.init_pgm_param(jax.random.key(13), di, dtype=jnp.float64)
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    mats = tuple(jnp.broadcast_to(m, (Ti - 1,) + m.shape)
                 for m in jax_mniw.expected_pair_potential(glob[1]))
    lengths = np.array([4, 3, 2, 4, 1])
    jd = np.logaddexp(rng.standard_normal((Bi, Ti, di)), 0.0) + 0.4
    h = rng.standard_normal((Bi, Ti, di))
    pairs = jax_lds._ragged_pairs(mats, lengths, Ti, jnp.float64)
    N1 = -0.5 * jnp.vectorize(jnp.diag, signature="(d)->(d,d)")(jd)
    leaves = (I1, I2, Ic) + tuple(pairs) + (N1, jnp.asarray(h))
    assert not (-(-2 * Bi // 8) < 2 * (-(-Bi // 8)))  # the JAX default

    def fb(lib, xs, fused_adj=False):
        init, prs, nds = xs[:3], xs[3:7], xs[7:]
        if lib is jnp:
            return pallas_vjp.fb_pass(init, prs, nds, block_b=8,
                                      interpret=True, bidir=False,
                                      fused_adj=fused_adj)
        return bpairs.fb_pass(init, prs, nds)

    weights = [rng.standard_normal(s) for s in
               [(Bi,), (Bi, Ti, di, di), (Bi, Ti, di), (Bi, Ti, di, di),
                (Bi, Ti, di)]]

    def loss(lib, xs, fused_adj=False):
        to = jnp.asarray if lib is jnp else _t
        return sum((to(w) * o).sum()
                   for w, o in zip(weights, fb(lib, xs, fused_adj)))

    ref_out, ref_grads, fused_grads = jax.jit(lambda xs: (
        fb(jnp, xs), jax.grad(lambda ys: loss(jnp, ys))(xs),
        jax.grad(lambda ys: loss(jnp, ys, fused_adj=True))(xs)))(leaves)
    ins = [_t(x).requires_grad_() for x in leaves]
    out = fb(torch, ins)
    grads = torch.autograd.grad(loss(torch, ins), ins)
    _close(out, ref_out)
    _close(grads, ref_grads)
    _close(grads, fused_grads)
