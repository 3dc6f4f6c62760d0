"""Parity of the port's SLDS ``parallel=`` routes (svae_tpu_torch/models/
slds.py: ``run_inference``, ``local_meanfield``, ``most_likely_states``,
``sample_states`` and ``predict`` with ``parallel=True`` or a chunk count)
with the JAX package, in float64 on the CPU.

The JAX reference is its ``backend="xla"`` path at ``parallel=True``
(``svae_tpu/models/slds.py``: the vmapped ``_sequence_inference``, each
x-step ``kalman.lds_smoother(parallel=True)``, each z-step
``hmm.hmm_posterior(parallel=True)``): ``run_inference`` under its own
noise with the gradient of a scalar of its outputs, and ``local_meanfield``
on one padded sequence, all one XLA program compiled once in a module
fixture. The port runs the same path at ``parallel=True`` (the log-depth
trees) and at ``parallel=2`` (the chunked element scans for the x-steps;
a chunk count takes the trees for the z-steps, as in the JAX package).
``mask=`` and ``lengths=``, and the forecast APIs, are held to the port's
own ``parallel=False`` route, which tests/test_torch_slds.py and
tests/test_torch_forecast.py hold to the JAX package. Values agree at
rtol 1e-8 / atol 1e-10, discrete paths are equal. B=2, T=6, K=3, d=2, 3
mean-field sweeps, none of them differentiated (the gradient runs through
the final x-step and z-step, the same functions a differentiated sweep
runs: a differentiated sweep doubles the JAX reference's trace and
compile, to some 25 s).

Four tests, so that the file, whose JAX reference takes some 15 s to
trace and compile, runs beside tests/test_time_shard.py under
``--dist loadfile`` instead of ahead of it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.models import slds as jax_slds

from svae_tpu_torch import convert
from svae_tpu_torch.models import slds
from svae_tpu_torch.utils.pytree import tree_leaves

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

torch.set_num_threads(1)
K, d, B, T, S = 3, 2, 2, 6, 2
SWEEPS, DIFF = 3, 0
LENGTHS = np.array([6, 4])
PAIR_WEIGHT = np.array([1.0, 1.0, 1.0, 0.0, 0.0])
F64 = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-8, atol=1e-10)


def _close(port, ref, tol=TOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), **tol)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def model():
    k = jax.random.split(jax.random.key(31), 2)
    prior = jax_slds.init_pgm_param(k[0], K, d, dtype=jnp.float64)
    glob = jax_slds.init_pgm_param(k[1], K, d, dtype=jnp.float64)
    rng = np.random.default_rng(32)
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))
    c = rng.standard_normal((S, B, T, d))
    key = jax.random.key(33)

    def loss(glob, jd, h):
        out = jax_slds.run_inference(
            prior, glob, (jd, h), key, S, num_meanfield_iters=SWEEPS,
            num_diff_iters=DIFF, backend="xla", parallel=True)
        return out[3] + jnp.sum(out[0] * c), out

    def references(glob, jd, h):
        (value, run), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(glob, jd, h)
        return dict(
            run=run, grad=(value, grads),
            local=jax_slds.local_meanfield(
                glob, (jd[0], h[0]), SWEEPS, DIFF, parallel=True,
                pair_weight=PAIR_WEIGHT),
            eps=jnp.moveaxis(jax.vmap(
                lambda kb: jax.random.normal(kb, (S, T, d), jnp.float64))(
                    jax.random.split(key, B)), 0, 1))

    args = (glob, jd, h)
    ref = jax.jit(references).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    natparam = functools.partial(convert.natparam, **F64)
    return dict(prior=natparam(jax.tree.map(np.asarray, prior)),
                glob=natparam(jax.tree.map(np.asarray, glob)),
                jd=torch.from_numpy(jd), h=torch.from_numpy(h),
                c=torch.from_numpy(c), **ref)


def _run(m, glob=None, pots=None, **kw):
    pots = (m["jd"], m["h"]) if pots is None else pots
    return slds.run_inference(m["prior"], m["glob"] if glob is None else glob,
                              pots, None, S, num_meanfield_iters=SWEEPS,
                              num_diff_iters=DIFF, eps=_t(m["eps"]), **kw)


@pytest.mark.parametrize("parallel", [True, 2])
def test_run_inference_matches_jax_scan_path(model, parallel):
    """Samples under the JAX path's noise, statistics, global and local KL,
    and the gradient of local_kl + <c, samples> with respect to the
    globals and both potentials, against the JAX package's
    backend="xla", parallel=True; then a ragged batch with an evidence
    mask inside its real frames against the port's parallel=False route
    (the kernels' plain versions), whose pad transitions leave the
    Dirichlet and MNIW counts."""
    _close(_run(model, parallel=parallel), model["run"])
    glob = tuple(tree_leaves(model["glob"]))
    ins = [x.clone().requires_grad_() for x in glob
           + (model["jd"], model["h"])]
    it = iter(ins)
    glob_in = tuple(tuple(next(it) for _ in leaves)
                    if isinstance(leaves, tuple) else next(it)
                    for leaves in model["glob"])
    samples, _, _, lkl = _run(model, glob_in, tuple(ins[-2:]),
                              parallel=parallel)
    value = lkl + (samples * model["c"]).sum()
    grads = torch.autograd.grad(value, ins)
    want_value, want_grads = model["grad"]
    _close((value, grads), (want_value, want_grads))

    rng = np.random.default_rng(34)
    kw = dict(mask=torch.from_numpy((rng.random((B, T)) > 0.3).astype(
        np.float64)), lengths=torch.from_numpy(LENGTHS))
    got = _run(model, parallel=parallel, **kw)
    want = _run(model, parallel=False, **kw)
    _close(got, [x.numpy() for x in tree_leaves(want)])
    assert float(got[1][1].sum()) == pytest.approx((LENGTHS - 1).sum())
    assert float(got[1][3][3].sum()) == pytest.approx((LENGTHS - 1).sum())


def test_local_meanfield_matches_jax(model):
    """One sequence padded to T (pair_weight): the JAX contract
    (hmm_post, lds_post, local_kl) leaf for leaf, with the gradient sweep
    on."""
    got = slds.local_meanfield(
        model["glob"], (model["jd"][0], model["h"][0]), SWEEPS, DIFF,
        parallel=True, pair_weight=torch.from_numpy(PAIR_WEIGHT))
    _close(got, model["local"])


def test_forecasts_at_parallel_true(model):
    """most_likely_states, sample_states and predict at parallel=True give
    the paths of parallel=False under the same noise, and predict's
    trajectories agree; a bad parallel raises."""
    pots = (model["jd"], model["h"])
    glob = model["glob"]
    g = torch.Generator().manual_seed(35)
    noise = dict(gumbel_noise=(slds.hmm.gumbel((B, S, K), g, **F64),
                               slds.hmm.gumbel((B, T - 1, S, K), g, **F64)),
                 eps=torch.randn((S, B, T, d), generator=g, **F64),
                 step_eps=torch.randn((4, S, B, d), generator=g, **F64),
                 step_gumbel=slds.hmm.gumbel((4, S, B, K), g, **F64))
    out = {}
    for parallel in (True, False):
        out[parallel] = (
            slds.most_likely_states(glob, pots, SWEEPS, parallel=parallel),
            slds.sample_states(glob, pots, None, S, SWEEPS,
                               parallel=parallel,
                               gumbel_noise=noise["gumbel_noise"]),
            slds.predict(glob, pots, None, 4, S, SWEEPS, parallel=parallel,
                         **noise))
    for a, b in zip(out[True][:2] + (out[True][2][1],),
                    out[False][:2] + (out[False][2][1],)):
        assert torch.equal(a, b)
    _close(out[True][2][0], out[False][2][0].numpy())
    with pytest.raises(ValueError, match="parallel"):
        slds.most_likely_states(glob, pots, SWEEPS, parallel=-1)
