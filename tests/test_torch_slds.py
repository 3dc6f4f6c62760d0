"""Parity of the port's SLDS-SVAE (svae_tpu_torch/models/slds.py, with
expfam/dirichlet.py and data/synthetic.py's make_switching_dot_data) with
the JAX package, in float64 on the CPU.

* ``run_inference`` (its statistics, samples, global and local KL, with
  ``mask=`` and ``lengths=``) and one ``make_gradfun`` step (without) are
  held to the JAX package's vmapped scan path (``backend="xla"``), whose
  sampling noise the port is given: tolerances are the tiers at which the
  JAX package holds its own two backends to each other
  (tests/test_slds.py: values rtol 1e-8, statistics and samples 1e-6,
  gradients 1e-5).
* Samples, statistics and local KL of a ragged, masked batch are held to
  the JAX package's Pallas backend (interpret mode, no gradient), the
  same algebra, at rtol 1e-8.
* ``most_likely_states`` against the vmapped JAX decode: the same paths.
* The padded-batch theorem, K=1 against the LDS, the Dirichlet family,
  the conversion of a JAX-initialised SLDS global tree and the switching
  dot data.

Every JAX reference is computed once, under one ``jax.jit``, in a module
fixture. The model is small: B=2, T=6, K=3, d=2, 3 mean-field sweeps, the
last differentiated."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.expfam import dirichlet as jax_dirichlet
from svae_tpu.models import slds as jax_slds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.train import elbo as jax_elbo

from svae_tpu_torch import convert
from svae_tpu_torch.data.synthetic import make_switching_dot_data
from svae_tpu_torch.expfam import dirichlet
from svae_tpu_torch.models import lds, slds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import elbo
from svae_tpu_torch.utils.pytree import tree_leaves

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))

torch.set_num_threads(1)
K, d, B, T, S = 3, 2, 2, 6, 2
SWEEPS, DIFF = 3, 1
LENGTHS = np.array([6, 4])
D_OBS, N = 5, 20
F64 = dict(dtype=torch.float64, device="cpu")
VALUE = dict(rtol=1e-8, atol=1e-10)      # the same algebra; XLA values
STATS = dict(rtol=1e-6, atol=1e-9)       # XLA path: statistics, samples
GRADS = dict(rtol=1e-5, atol=1e-8)       # XLA path: gradients


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, tol=VALUE):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), **tol)


@pytest.fixture(scope="module")
def model():
    """A small SLDS problem in both packages, and the JAX references."""
    k = jax.random.split(jax.random.key(21), 4)
    prior = jax_slds.init_pgm_param(k[0], K, d, dtype=jnp.float64)
    glob = jax_slds.init_pgm_param(k[1], K, d, dtype=jnp.float64)
    rp = jax_recognition.init_mlp_recognize(k[2], D_OBS, (8,), d,
                                            dtype=jnp.float64)
    dp = jax_decoders.init_mlp_decode(k[3], d, (8,), D_OBS,
                                      dtype=jnp.float64)
    rng = np.random.default_rng(22)
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))
    mask = (rng.random((B, T)) > 0.3).astype(np.float64)
    y = make_switching_dot_data(3, B, T, D_OBS).astype(np.float64)
    key = jax.random.key(23)
    run = functools.partial(jax_slds.run_inference,
                            num_meanfield_iters=SWEEPS,
                            num_diff_iters=DIFF)
    gradfun = jax_elbo.make_gradfun(
        functools.partial(run, backend="xla"), jax_recognition.mlp_recognize,
        jax_decoders.mlp_loglike, prior, N, num_samples=S)

    def references(jd, h, mask, y):
        pots = (jd, h)
        out = dict(xla=run(prior, glob, pots, key, S, backend="xla",
                           mask=mask, lengths=LENGTHS),
                   prior_kl=jax_slds.prior_kl(glob, prior),
                   expectedstats=jax_slds.pgm_expectedstats(glob))
        out["pallas"] = run(prior, glob, pots, key, S, backend="pallas",
                            interpret=True, mask=mask, lengths=LENGTHS)
        out["grad"] = gradfun(glob, (rp, dp), y, key)
        out["map"] = jax.vmap(lambda J, hh, m: jax_slds.most_likely_states(
            glob, (J, hh), num_meanfield_iters=SWEEPS, mask=m))(jd, h, mask)
        # the noise each path draws from ``key``: the XLA path one key per
        # sequence, the Pallas path one draw for the batch
        out["eps_xla"] = jnp.moveaxis(jax.vmap(
            lambda kb: jax.random.normal(kb, (S, T, d), jnp.float64))(
                jax.random.split(key, B)), 0, 1)
        out["eps_pallas"] = jax.random.normal(key, (S, B, T, d),
                                              jnp.float64)
        return out

    natparam = functools.partial(convert.natparam, **F64)
    return dict(jax_glob=glob,
                prior=natparam(_np(prior)), glob=natparam(_np(glob)),
                nets=(convert.recognizer(_np(rp), **F64),
                      convert.decoder(_np(dp), **F64)),
                jd=jd, h=h, mask=mask, y=y,
                **jax.jit(references).lower(jd, h, mask, y).compile(
                    {"xla_backend_optimization_level": 0})(jd, h, mask, y))


def _pots(m):
    return torch.from_numpy(m["jd"]), torch.from_numpy(m["h"])


def _run(m, eps, **kw):
    return slds.run_inference(m["prior"], m["glob"], _pots(m), None, S,
                              num_meanfield_iters=SWEEPS,
                              num_diff_iters=DIFF, eps=_t(eps), **kw)


# --------------------------------------------------------------------------
# the model against the JAX scan path and Pallas backend
# --------------------------------------------------------------------------


def test_run_inference_matches_jax_scan_path(model):
    """Samples (under the XLA path's own noise), statistics, global and
    local KL of a ragged batch with an evidence mask inside its real
    frames. (Without mask and lengths, run_inference is held to the same
    path by test_gradfun_matches_jax, whose ELBO and natural gradient
    carry its samples, statistics and KLs: a reference of its own would
    cost 5 s of JAX compile.)"""
    samples, stats, gkl, lkl = _run(
        model, model["eps_xla"], mask=torch.from_numpy(model["mask"]),
        lengths=torch.from_numpy(LENGTHS))
    s_r, stats_r, gkl_r, lkl_r = model["xla"]
    _close((gkl, lkl), (gkl_r, lkl_r))
    _close((samples, stats), (s_r, stats_r), STATS)


def test_run_inference_matches_jax_pallas_backend(model):
    """A ragged, masked batch against the JAX package's Pallas backend
    under its noise: the same algebra, every recursion on the other
    side a Pallas kernel in interpret mode."""
    out = _run(model, model["eps_pallas"], mask=torch.from_numpy(
        model["mask"]), lengths=torch.from_numpy(LENGTHS))
    _close(out, model["pallas"])


def test_gradfun_matches_jax(model):
    """ELBO, natural gradient, net gradients and terms of one SVI step
    against jax.grad through the JAX package's scan path, under its
    noise."""
    gradfun = elbo.make_gradfun(
        functools.partial(slds.run_inference, num_meanfield_iters=SWEEPS,
                          num_diff_iters=DIFF, eps=_t(model["eps_xla"])),
        recognition.mlp_recognize, decoders.mlp_loglike, model["prior"], N,
        num_samples=S)
    value, natgrad, net_grads, terms = gradfun(
        model["glob"], model["nets"], torch.from_numpy(model["y"]), None)
    v_r, nat_r, grads_r, terms_r = model["grad"]
    _close(value, v_r)
    _close(natgrad, nat_r, STATS)
    _close(net_grads, grads_r, GRADS)
    assert sorted(terms) == sorted(terms_r)
    for k in terms_r:
        _close(terms[k], terms_r[k], GRADS if k == "net_grad_norm" else VALUE)


def test_most_likely_states_matches_jax(model):
    """The MAP paths of a masked batch equal the vmapped JAX decode's; an
    unbatched input decodes as a batch of one."""
    mask = torch.from_numpy(model["mask"])
    paths = slds.most_likely_states(model["glob"], _pots(model),
                                    num_meanfield_iters=SWEEPS, mask=mask)
    assert paths.dtype == torch.int32
    np.testing.assert_array_equal(paths.numpy(), np.asarray(model["map"]))
    one = slds.most_likely_states(model["glob"],
                                  tuple(x[0] for x in _pots(model)),
                                  num_meanfield_iters=SWEEPS, mask=mask[0])
    np.testing.assert_array_equal(one.numpy(), paths[0].numpy())


# --------------------------------------------------------------------------
# the padded-batch theorem; K=1; options
# --------------------------------------------------------------------------


def test_padded_batch_matches_unpadded_sequences(model):
    """A padded batch with lengths= gives the summed statistics and local
    KL of its sequences run alone, and counts only real transitions in
    the Dirichlet and MNIW statistics (tests/test_masking.py's theorem)."""
    jd, h = _pots(model)
    prior, glob = model["prior"], model["glob"]
    run = functools.partial(slds.run_inference, num_meanfield_iters=SWEEPS)
    alone = [run(prior, glob, (jd[i:i + 1, :n], h[i:i + 1, :n]),
                 torch.Generator().manual_seed(i), 1)
             for i, n in enumerate(LENGTHS)]
    _, stats, _, lkl = run(prior, glob, (jd, h),
                           torch.Generator().manual_seed(9), 1,
                           lengths=torch.from_numpy(LENGTHS))
    want = [sum(leaves) for leaves in
            zip(*(tree_leaves(o[1]) for o in alone))]
    tol = dict(rtol=1e-9, atol=1e-9)
    _close(stats, want, tol)
    _close(lkl, sum(float(o[3]) for o in alone), tol)
    assert float(stats[1].sum()) == pytest.approx((LENGTHS - 1).sum())
    assert float(stats[3][3].sum()) == pytest.approx((LENGTHS - 1).sum())


def test_one_state_slds_is_the_lds(model):
    """With K=1 the discrete chain is certain, so an SLDS gives the LDS's
    samples, statistics and local KL (tests/test_slds.py's oracle, here
    the port's SLDS against the port's stationary LDS path)."""
    g = torch.Generator().manual_seed(3)
    glob = slds.init_pgm_param(1, d, g, **F64)
    lds_glob = (glob[2], tuple(x[0] for x in glob[3]))
    eps = torch.randn((S, B, T, d), generator=g, dtype=torch.float64)
    s1, st1, _, kl1 = slds.run_inference(glob, glob, _pots(model), None, S,
                                         num_meanfield_iters=SWEEPS, eps=eps)
    s2, st2, _, kl2 = lds.run_inference(lds_glob, lds_glob, _pots(model),
                                        None, S, eps=eps)
    _close((s1, kl1), (s2.numpy(), kl2.numpy()))
    _close((st1[2], tuple(x[0] for x in st1[3])),
           [x.numpy() for x in tree_leaves(st2)])


def test_run_inference_options(model):
    """An unbatched (T, d) input runs as a batch of one; lengths= needs a
    batch; parallel= takes False, True or a chunk count and raises on
    anything else (tests/test_torch_slds_parallel.py holds its routes to
    the JAX package)."""
    eps = _t(model["eps_xla"])[:, :1]
    pots = tuple(x[:1] for x in _pots(model))
    run = functools.partial(slds.run_inference, model["prior"],
                            model["glob"], num_meanfield_iters=SWEEPS)
    s1, st1, g1, k1 = run(tuple(x[0] for x in pots), None, S, eps=eps)
    s2, st2, g2, k2 = run(pots, None, S, eps=eps)
    assert s1.shape == (S, T, d)
    _close((s1, st1, g1, k1), (s2[:, 0].numpy(),
                               *(x.numpy() for x in tree_leaves(st2)),
                               g2.numpy(), k2.numpy()), dict(rtol=0, atol=0))
    with pytest.raises(ValueError, match="batched"):
        run(tuple(x[0] for x in pots), None, S, lengths=torch.tensor([T]))
    for bad in (-1, 1.5, None):
        with pytest.raises(ValueError, match="parallel"):
            run(pots, None, S, parallel=bad)


# --------------------------------------------------------------------------
# the Dirichlet family, the conversion of the globals, the data
# --------------------------------------------------------------------------


def test_dirichlet_matches_jax():
    """Both parameter maps, logZ and expectedstats against the JAX
    package's on one (K,) and one (K, K) natural parameter, and
    expectedstats equal to the autograd of logZ."""
    rng = np.random.default_rng(30)
    for shape in [(K,), (K, K)]:
        eta = rng.random(shape) * 3.0 - 0.5
        nat = _t(eta).requires_grad_()
        (grad,) = torch.autograd.grad(dirichlet.logZ(nat), [nat])
        _close((dirichlet.standard_to_natural(_t(eta)),
                dirichlet.natural_to_standard(_t(eta)), dirichlet.logZ(nat),
                dirichlet.expectedstats(_t(eta)), grad),
               (jax_dirichlet.standard_to_natural(eta),
                jax_dirichlet.natural_to_standard(eta),
                jax_dirichlet.logZ(eta), jax_dirichlet.expectedstats(eta),
                jax_dirichlet.expectedstats(eta)))


def test_converted_globals_give_the_same_prior_kl(model):
    """A JAX-initialised SLDS global tree (init_dir, trans_dir, NIW, MNIW
    with a leading K axis) converts leaf for leaf and gives the same
    prior KL and expected statistics."""
    assert [tuple(x.shape) for x in tree_leaves(model["glob"])] == \
        [x.shape for x in jax.tree.leaves(model["jax_glob"])]
    _close(slds.prior_kl(model["glob"], model["prior"]), model["prior_kl"])
    _close(slds.pgm_expectedstats(model["glob"]), model["expectedstats"])


def test_switching_dot_data_matches_the_example():
    import slds_synth
    got, states = make_switching_dot_data(5, 3, 40, 16, return_states=True)
    want, want_states = slds_synth.make_switching_dot_data(
        5, 3, 40, 16, return_states=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(states, want_states)
    assert got.dtype == np.float32 and states.dtype == np.int32
