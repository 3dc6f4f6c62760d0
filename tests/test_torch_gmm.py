"""Parity of the port's GMM-SVAE (svae_tpu_torch/models/gmm.py, with
expfam/gaussian.py, expfam/categorical.py and data/synthetic.py's
make_pinwheel, rand_lds and lds_rollout) with the JAX package, in float64
on the CPU.

Every ``gmm`` function is held to the JAX package's at rtol 1e-8 / atol
1e-10 (both sides float64, the same algebra): the mean-field's values,
the values of ``run_inference`` and its truncated gradient with respect to
the potentials and every global leaf, and one ``make_gradfun`` step (ELBO,
natural gradient, net gradients, terms); the Gaussian and categorical
families too, and the data copies are equal to the JAX package's arrays.
The JAX side takes its sampling noise from a key; the port is given the
same draws. The JAX references are one XLA program, compiled once in a
module fixture. The problem is small: K=4 components, d=2, B=6 points.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.data import synthetic as jax_synthetic
from svae_tpu.expfam import categorical as jax_categorical
from svae_tpu.expfam import dirichlet as jax_dirichlet
from svae_tpu.expfam import gaussian as jax_gaussian
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.models import gmm as jax_gmm
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.train import elbo as jax_elbo

from svae_tpu_torch import convert
from svae_tpu_torch.data import synthetic
from svae_tpu_torch.expfam import categorical, dirichlet, gaussian, niw
from svae_tpu_torch.models import gmm
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import elbo
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map

torch.set_num_threads(1)
K, d, B, S = 4, 2, 6, 2
SWEEPS, DIFF = 8, 2
N = 60
F64 = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-8, atol=1e-10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(port, ref):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), **TOL)


def _probe(rng, shapes):
    """Fixed random weights for a scalar probe of several outputs."""
    return [rng.standard_normal(s) for s in shapes]


def _inf_scalar(out, w):
    """A scalar of run_inference's samples, statistics and KLs."""
    samples, (dstats, niw_stats), gkl, lkl = out
    leaves = (samples, dstats) + tuple(niw_stats)
    return sum((a * b).sum() for a, b in zip(leaves, w)) + gkl + lkl


def _net(rng, sizes):
    """A JAX-layout Gaussian MLP ``(hidden ((W, b), ...), (head_1,
    head_2))`` with random float64 weights."""
    layer = lambda m, n: (0.5 * rng.standard_normal((m, n)),
                          0.1 * rng.standard_normal(n))
    return (tuple(layer(m, n) for m, n in zip(sizes[:-2], sizes[1:-1])),
            (layer(*sizes[-2:]), layer(*sizes[-2:])))


def _gmm_globals(rng, scale):
    """Random GMM global natparams in float64 NumPy: the JAX package's
    init formula on a NumPy draw of the means."""
    nu = (d + 10.0) * np.ones(K)
    return (np.zeros(K), tuple(np.asarray(a) for a in jax_niw.standard_to_natural(
        np.broadcast_to(nu[0] * np.eye(d), (K, d, d)),
        scale * rng.standard_normal((K, d)), 10.0 * np.ones(K), nu)))


def _gaussians(rng):
    """Two batches (B, d) of Gaussians in natural form."""
    G = rng.standard_normal((2, B, d, d))
    Lam = np.linalg.inv(G @ np.swapaxes(G, -1, -2) + 0.5 * np.eye(d))
    mu = rng.standard_normal((2, B, d))
    return mu[0], np.linalg.inv(Lam[0]), [
        (-0.5 * L, (L @ m[..., None])[..., 0]) for L, m in zip(Lam, mu)]


@pytest.fixture(scope="module")
def model():
    """A small GMM problem in both packages, and every JAX reference of
    this file, compiled as one XLA program. The parameters are drawn
    with NumPy (an eager JAX init costs seconds of dispatch)."""
    rng = np.random.default_rng(32)
    prior, glob = _gmm_globals(rng, 1.0), _gmm_globals(rng, 2.0)
    glob = (np.array([0.5, 1.0, 2.0, 0.0]), glob[1])
    rp, dp = _net(rng, (2, 8, d)), _net(rng, (d, 8, 2))
    key = jax.random.key(31)
    jd = np.logaddexp(rng.standard_normal((B, d)), 0.0) + 0.3
    h = rng.standard_normal((B, d))
    y = synthetic.make_pinwheel(seed=3, num_classes=3,
                                num_per_class=2).astype(np.float64)
    r0 = rng.dirichlet(np.ones(K), size=B)
    w_inf = _probe(rng, [(S, B, d), (K,), (K, d, d), (K, d), (K,), (K,)])
    mu, Sig, (q, p) = _gaussians(rng)
    eta = rng.standard_normal((3, 5))
    run = functools.partial(jax_gmm.run_inference,
                            num_meanfield_iters=SWEEPS)
    gradfun = jax_elbo.make_gradfun(run, jax_recognition.mlp_recognize,
                                    jax_decoders.mlp_loglike, prior, N,
                                    num_samples=S)
    lmf = lambda g, p, it, nd: jax_gmm.local_meanfield(
        g, p, num_iters=it, num_diff_iters=nd)

    def references(glob, pots, y, r0, q, p, eta):
        jd, h = pots
        out = dict(expectedstats=jax_gmm.pgm_expectedstats(glob),
                   prior_kl=jax_gmm.prior_kl(glob, prior),
                   eps=jax.random.normal(key, (S, B, d), jnp.float64),
                   grad=gradfun(glob, (rp, dp), y, key))
        gg = jax_niw.expected_gaussian_natparam(glob[1])
        out["q_x"] = jax_gmm._gaussian_meanfield(
            gg, jax_gaussian.pack_dense(jd, h), r0)
        stats = jax_gaussian.expectedstats(out["q_x"])
        out["logits"] = jax_gmm._label_logits(
            jax_dirichlet.expectedstats(glob[0]), gg, stats)
        out["global_stats"] = jax_gmm._global_stats(r0, stats)
        out["lmf"] = lmf(glob, pots, SWEEPS, DIFF)
        # run_inference's values and its gradient with respect to every
        # global leaf and the potentials, from one trace: the cotangents
        # are the probe's weights (1 on the KLs)
        out["inference"], vjp = jax.vjp(
            lambda g, pp: run(prior, g, pp, key, S), glob, pots)
        one = jnp.ones(())
        out["grad_inf"] = vjp((w_inf[0], (w_inf[1], tuple(w_inf[2:])),
                               one, one))
        # the exponential families
        out["gaussian"] = dict(
            standard_to_natural=jax_gaussian.standard_to_natural(mu, Sig),
            natural_to_standard=jax_gaussian.natural_to_standard(q),
            info_params=jax_gaussian.info_params(q),
            from_info=jax_gaussian.from_info(*jax_gaussian.info_params(q)),
            logZ=jax_gaussian.logZ(q),
            expectedstats=jax_gaussian.expectedstats(q),
            kl=jax_gaussian.kl(q, p),
            pack_dense=jax_gaussian.pack_dense(jnp.abs(mu) + 0.1, mu[::-1]),
            samples=jax_gaussian.natural_sample(q, key, S))
        probs = jax.nn.softmax(eta, axis=-1)
        out["categorical"] = {
            name: getattr(jax_categorical, name)(
                probs if name == "standard_to_natural" else eta)
            for name in ("standard_to_natural", "natural_to_standard",
                         "logZ", "expectedstats")}
        out["probs"] = probs
        return out

    natparam = functools.partial(convert.natparam, **F64)
    args = (glob, (jd, h), y, r0, q, p, eta)
    # XLA's backend optimizations cost a third of the compile and change
    # no float64 value this file compares
    refs = jax.tree.map(np.asarray, jax.jit(references).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args))
    return dict(prior=natparam(prior), glob=natparam(glob),
                nets=(convert.recognizer(rp, **F64),
                      convert.decoder(dp, **F64)),
                jd=jd, h=h, y=y, r0=r0, w_inf=w_inf, mu=mu,
                Sig=Sig, q=q, p=p, eta=eta, **refs)


def _pots(m, grad=False):
    return tuple(torch.tensor(m[k], requires_grad=grad) for k in ("jd", "h"))


# --------------------------------------------------------------------------
# the model's functions
# --------------------------------------------------------------------------


def test_init_defaults_to_the_card():
    """gmm.init_pgm_param places its tensors on "cuda" unless asked for
    the CPU, even with a CPU generator; that raises where there is no
    card."""
    g = torch.Generator().manual_seed(0)
    devices = {t.device.type for t in
               tree_leaves(gmm.init_pgm_param(K, d, g, device="cpu"))}
    assert devices == {"cpu"}
    if torch.cuda.is_available():
        devices = {t.device.type for t in
                   tree_leaves(gmm.init_pgm_param(K, d, g))}
        assert devices == {"cuda"}
    else:
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            gmm.init_pgm_param(K, d, g)


def test_init_pgm_param_matches_jax_on_the_same_means():
    """The port's init is the JAX package's formula on the same draw of
    the means, m = random_scale * N(0, I) from the generator."""
    ours = gmm.init_pgm_param(K, d, torch.Generator().manual_seed(4),
                              alpha=2.0, niw_conc=5.0, random_scale=1.5,
                              **F64)
    m = 1.5 * torch.randn((K, d), generator=torch.Generator().manual_seed(4),
                          dtype=torch.float64).numpy()
    nu = (d + 5.0) * np.ones(K)
    ref = (jax_dirichlet.standard_to_natural(2.0 * jnp.ones(K)),
           jax_niw.standard_to_natural(
               np.broadcast_to((d + 5.0) * np.eye(d), (K, d, d)), m,
               5.0 * np.ones(K), nu))
    _close(ours, ref)


def test_pgm_expectedstats_and_prior_kl_match_jax(model):
    _close(gmm.pgm_expectedstats(model["glob"]), model["expectedstats"])
    _close(gmm.prior_kl(model["glob"], model["prior"]), model["prior_kl"])


def test_sweep_parts_match_jax(model):
    """_gaussian_meanfield, _label_logits and _global_stats at one label
    field."""
    glob = model["glob"]
    gg = niw.expected_gaussian_natparam(glob[1])
    r0 = torch.from_numpy(model["r0"])
    q_x = gmm._gaussian_meanfield(gg, gaussian.pack_dense(*_pots(model)), r0)
    _close(q_x, model["q_x"])
    stats = gaussian.expectedstats(q_x)
    _close(gmm._label_logits(dirichlet.expectedstats(glob[0]), gg, stats),
           model["logits"])
    _close(gmm._global_stats(r0, stats), model["global_stats"])


@pytest.mark.parametrize("num_diff_iters", [DIFF, 0])
def test_local_meanfield_matches_jax(model, num_diff_iters):
    """The values do not depend on how many sweeps carry the graph: both
    splits give the JAX package's."""
    out = gmm.local_meanfield(model["glob"], _pots(model), num_iters=SWEEPS,
                              num_diff_iters=num_diff_iters)
    _close(out, model["lmf"])


def test_run_inference_matches_jax(model):
    """Samples (under the JAX draw), statistics and both KLs; one
    finiteness check."""
    out = gmm.run_inference(model["prior"], model["glob"], _pots(model),
                            None, S, num_meanfield_iters=SWEEPS,
                            eps=torch.from_numpy(model["eps"]))
    _close(out, model["inference"])


def test_truncated_gradient_matches_jax(model):
    """The gradient of a probe of run_inference's samples, statistics and
    KLs with respect to every global natparam leaf and the potentials
    against JAX's: it runs back through the sampler and through
    local_meanfield's final pass and its last DIFF sweeps only (the warm
    sweeps carry no graph, as JAX's stop_gradient)."""
    glob = tree_map(lambda a: a.clone().requires_grad_(True), model["glob"])
    pots = _pots(model, grad=True)
    out = gmm.run_inference(model["prior"], glob, pots, None, S,
                            num_meanfield_iters=SWEEPS,
                            eps=torch.from_numpy(model["eps"]))
    w = [torch.from_numpy(a) for a in model["w_inf"]]
    _close(torch.autograd.grad(_inf_scalar(out, w),
                               tree_leaves(glob) + list(pots)),
           model["grad_inf"])


def test_classify_matches_jax(model):
    """The responsibilities: the JAX package's classify is the label field
    of its local_meanfield at the same sweeps, held here to that."""
    probs = gmm.classify(model["glob"], _pots(model), SWEEPS)
    _close(probs, model["lmf"][0])
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-12)


def test_gradfun_matches_jax(model):
    """ELBO, natural gradient, net gradients and terms of one SVI step on
    pinwheel points through the port's unchanged train/elbo.py."""
    run = functools.partial(gmm.run_inference, num_meanfield_iters=SWEEPS,
                            eps=torch.from_numpy(model["eps"]))
    gradfun = elbo.make_gradfun(run, recognition.mlp_recognize,
                                decoders.mlp_loglike, model["prior"], N,
                                num_samples=S)
    value, natgrad, net_grads, terms = gradfun(
        model["glob"], model["nets"], torch.from_numpy(model["y"]), None)
    v_r, nat_r, grads_r, terms_r = model["grad"]
    _close((value, natgrad, net_grads), (v_r, nat_r, grads_r))
    assert sorted(terms) == sorted(terms_r)
    _close([terms[k] for k in sorted(terms)],
           [terms_r[k] for k in sorted(terms_r)])


# --------------------------------------------------------------------------
# the exponential families
# --------------------------------------------------------------------------


def test_gaussian_matches_jax(model):
    ref = model["gaussian"]
    q, p = _t(model["q"]), _t(model["p"])
    mu = torch.from_numpy(model["mu"])
    ours = dict(
        standard_to_natural=gaussian.standard_to_natural(
            mu, torch.from_numpy(model["Sig"])),
        natural_to_standard=gaussian.natural_to_standard(q),
        info_params=gaussian.info_params(q),
        from_info=gaussian.from_info(*gaussian.info_params(q)),
        logZ=gaussian.logZ(q), expectedstats=gaussian.expectedstats(q),
        kl=gaussian.kl(q, p),
        pack_dense=gaussian.pack_dense(mu.abs() + 0.1, mu.flip(0)))
    for name, value in ours.items():
        _close(value, ref[name])


@pytest.mark.parametrize("num_samples", [S, (1, S), ()])
def test_natural_sample_matches_jax(model, num_samples):
    """The samples of the JAX package's draw of S, ``normal(key, (S,) +
    mu.shape)`` (the draw of run_inference's noise: mu is (B, d) here too,
    so the reference compiles one draw), under its noise; a sample shape
    (1, S) and no sample axis under the noise's reshapes."""
    eps = torch.from_numpy(model["eps"])
    ref = model["gaussian"]["samples"]
    if num_samples == ():
        eps, ref = eps[0], ref[0]
    elif num_samples != S:
        eps, ref = eps[None], ref[None]
    _close(gaussian.natural_sample(_t(model["q"]), None, num_samples,
                                   eps=eps), ref)


def test_expectedstats_is_the_gradient_of_logZ(model):
    q = tree_map(lambda a: a.requires_grad_(True), _t(model["q"]))
    grads = torch.autograd.grad(gaussian.logZ(q).sum(), q)
    _close(grads, model["gaussian"]["expectedstats"])


def test_categorical_matches_jax(model):
    for name, ref in model["categorical"].items():
        arg = model["probs"] if name == "standard_to_natural" else model["eta"]
        _close(getattr(categorical, name)(torch.from_numpy(arg)), ref)


# --------------------------------------------------------------------------
# the data copies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(seed=1, num_classes=3,
                                               num_per_class=7, rate=0.4)])
def test_make_pinwheel_matches_jax_package(kw):
    np.testing.assert_array_equal(synthetic.make_pinwheel(**kw),
                                  jax_synthetic.make_pinwheel(**kw))


def test_rand_lds_and_rollout_match_jax_package():
    for ours, ref in zip(synthetic.rand_lds(seed=5, d=3),
                         jax_synthetic.rand_lds(seed=5, d=3)):
        np.testing.assert_array_equal(ours, ref)
    A, Q, mu0, S0 = jax_synthetic.rand_lds(seed=6, d=2, eigmax=0.8,
                                           q_scale=0.2)
    np.testing.assert_array_equal(
        synthetic.lds_rollout(A, Q, mu0, S0, 9, seed=7, num_seqs=3),
        jax_synthetic.lds_rollout(A, Q, mu0, S0, 9, seed=7, num_seqs=3))
