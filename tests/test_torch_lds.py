"""Parity of the port's LDS model (svae_tpu_torch/models/lds.py) and the
inference slice as a whole with the JAX package, in float64 on the CPU.

``run_inference`` and ``posterior_moments`` are held to the JAX package's
vmapped scan path (``backend="xla"``): an implementation independent of
the packed E-step. Its samples come from JAX's generator, so only the
statistics and KLs are compared there; samples under a shared noise are
compared through the slice test, which composes recognize -> E-step ->
decode -> ELBO as svae_tpu/train/elbo.py does. Tolerance rtol 1e-8 /
atol 1e-10 (both sides float64). Every JAX reference comes from one XLA
program, compiled once in a module fixture."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.data import synthetic as jax_synthetic
from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.models import lds as jax_lds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.ops import pallas_estep

from svae_tpu_torch import convert
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import elbo
from svae_tpu_torch.utils.pytree import tree_leaves

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, T, d, S = 4, 8, 3, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=RTOL, atol=ATOL)


INPUTS = {
    "batched": lambda m: (m["jd"], m["h"], None),
    "masked": lambda m: (m["jd"], m["h"], m["mask"]),
    "single": lambda m: (m["jd"][1], m["h"][1], m["mask"][1]),
}
MOMENT_CASES = ("masked", "single")
D_OBS, N = 6, 40


@pytest.fixture(scope="module")
def model():
    """The JAX package's globals and nets, evidence, a mask, data and
    noise, and every JAX reference of this module, from one XLA program
    compiled once without XLA's backend optimizations (which change no
    float64 value): ``prior_kl``, ``run_inference`` and
    ``posterior_moments`` on the scan path for each case, and the slice's
    ELBO composition."""
    rng = np.random.default_rng(0)
    m = dict(jd=np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4,
             h=rng.standard_normal((B, T, d)),
             mask=(rng.random((B, T)) > 0.3).astype(np.float64),
             y=jax_synthetic.make_dot_data(
                 seed=0, num_seqs=B, T=T,
                 image_width=D_OBS).astype(np.float64),
             eps=np.random.default_rng(4).standard_normal((S, B, T, d)))

    def references(m):
        k1, k2 = jax.random.split(jax.random.key(0))
        prior = jax_lds.init_pgm_param(k1, d, dtype=jnp.float64)
        glob = jax_lds.init_pgm_param(k2, d, dtype=jnp.float64)
        out = dict(prior=prior, glob=glob,
                   prior_kl=jax_lds.prior_kl(glob, prior))
        for case, inputs in INPUTS.items():
            jd, h, mask = inputs(m)
            out[f"run_inference_{case}"] = jax_lds.run_inference(
                prior, glob, (jd, h), jax.random.key(1), S, backend="xla",
                mask=mask)
            if case in MOMENT_CASES:
                out[f"posterior_moments_{case}"] = (
                    jax_lds.posterior_moments(glob, (jd, h), mask=mask,
                                              backend="xla"))
        out["slice"] = _slice_reference(glob, prior, m["y"], m["eps"])
        return out

    refs = jax.jit(references).lower(m).compile(
        {"xla_backend_optimization_level": 0})(m)
    to_t = functools.partial(convert.natparam, dtype=torch.float64,
                             device="cpu")
    return dict(m, refs=refs, prior=to_t(_np(refs["prior"])),
                glob=to_t(_np(refs["glob"])))


def _slice_reference(glob, prior, y, eps):
    """svae_tpu/train/elbo.py:95-107 with run_inference(backend="pallas")
    spelled out, the Pallas kernels in interpret mode: the nets, the ELBO,
    the statistics and the terms."""
    k1, k2 = jax.random.split(jax.random.key(3))
    rp = jax_recognition.init_mlp_recognize(k1, D_OBS, (8,), d,
                                            dtype=jnp.float64)
    dp = jax_decoders.init_mlp_decode(k2, d, (8,), D_OBS, dtype=jnp.float64)
    pots = jax_recognition.mlp_recognize(rp, y)
    (I1, I2), Ic = jax_niw.expected_gaussian_natparam(glob[0])
    mats = jax_mniw.expected_pair_potential(glob[1])
    samples, stats_r, lkl = pallas_estep.lds_estep_stationary(
        (I1, I2, Ic), mats, pots, None, S, block_b=8, interpret=True,
        eps=eps)
    gkl = jax_lds.prior_kl(glob, prior)
    ll = jax_decoders.mlp_loglike(dp, samples, y)
    elbo_r = ((N / B) * (ll - lkl) - gkl) / N
    return dict(nets=(rp, dp), elbo=elbo_r, stats=stats_r,
                terms={"loglike": ll / B, "local_kl": lkl / B,
                       "global_kl": gkl / N})


def test_prior_kl_matches_jax(model):
    _close(lds.prior_kl(model["glob"], model["prior"]),
           model["refs"]["prior_kl"])


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_run_inference_matches_jax_scan_path(model, case):
    jd, h, mask = INPUTS[case](model)
    samples, stats, gkl, lkl = lds.run_inference(
        model["prior"], model["glob"], (torch.from_numpy(jd),
                                        torch.from_numpy(h)),
        torch.Generator().manual_seed(0), S,
        mask=None if mask is None else torch.from_numpy(mask))
    s_r, stats_r, gkl_r, lkl_r = model["refs"][f"run_inference_{case}"]
    assert samples.shape == s_r.shape
    assert bool(torch.isfinite(samples).all())
    _close(stats, stats_r)
    _close(gkl, gkl_r)
    _close(lkl, lkl_r)


@pytest.mark.parametrize("case", MOMENT_CASES)
def test_posterior_moments_match_jax_scan_path(model, case):
    jd, h, mask = INPUTS[case](model)
    out = lds.posterior_moments(
        model["glob"], (torch.from_numpy(jd), torch.from_numpy(h)),
        mask=torch.from_numpy(mask))
    _close(out, model["refs"][f"posterior_moments_{case}"])


@pytest.mark.parametrize("entry", ["run_inference", "posterior_moments"])
def test_failed_factor_raises(model, entry):
    """Evidence of negative precision makes the filter's Cholesky factor
    fail; the entry raises instead of returning NaN."""
    pots = (torch.full((B, T, d), -50.0, dtype=torch.float64),
            torch.from_numpy(model["h"]))
    call = {
        "run_inference": lambda: lds.run_inference(
            model["prior"], model["glob"], pots,
            torch.Generator().manual_seed(0), S),
        "posterior_moments": lambda: lds.posterior_moments(model["glob"],
                                                           pots),
    }[entry]
    with pytest.raises(FloatingPointError, match="Cholesky"):
        call()


def test_init_pgm_param_is_seeded_and_valid():
    make = lambda seed: lds.init_pgm_param(
        d, torch.Generator().manual_seed(seed), dtype=torch.float64,
        device="cpu")
    a, b, c = make(0), make(0), make(1)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.allclose(a[1][1], c[1][1])
    kl = lds.prior_kl(a, c)
    assert float(kl) > 0.0 and abs(float(lds.prior_kl(a, b))) < 1e-9


def test_slice_elbo_matches_jax_composition(model):
    """recognize -> packed E-step under shared noise -> decode -> ELBO, the
    port's make_objective against the same composition in JAX
    (svae_tpu/train/elbo.py objective, lds.run_inference(backend="pallas")
    with the Pallas kernels in interpret mode)."""
    ref = model["refs"]["slice"]
    rp, dp = ref["nets"]
    objective = elbo.make_objective(
        functools.partial(lds.run_inference,
                          eps=torch.from_numpy(model["eps"])),
        recognition.mlp_recognize, decoders.mlp_loglike, model["prior"], N,
        num_samples=S)
    f64 = dict(dtype=torch.float64, device="cpu")
    nets = (convert.recognizer(_np(rp), **f64),
            convert.decoder(_np(dp), **f64))
    value, (stats, terms) = objective(model["glob"], nets,
                                      torch.from_numpy(model["y"]), None)
    _close(value, ref["elbo"])
    _close(stats, ref["stats"])
    for k in ref["terms"]:
        _close(terms[k], ref["terms"][k])
