"""Parity of the port's forecast and state-sampling APIs with the JAX
package, in float64 on the CPU: ``ops.hmm.hmm_sample``,
``models.slds.sample_states`` and ``predict``, ``models.lds.predict`` and
``pgm_expectedstats``, and ``expfam.mniw.posterior_mean_params``.

The JAX side is its per-sequence scan path, ``vmap``ped over the batch
with one key a sequence (``split(key, B)``), as its batched ``predict``
runs; the port gets each sequence's draws from those keys, stacked on its
batch axis: for ``hmm_sample`` ``g0 = gumbel(k0, S + (K,))`` and
``gs = gumbel(k1, (T-1,) + S + (K,))`` with ``k0, k1 = split(key)``;
for ``lds.predict`` the window's ``normal(k1, (S, T, d))`` and the
rollout's ``normal(k2, (num_steps, S, d))`` with ``k1, k2 = split(key)``;
for ``slds.predict`` the four draws of ``split(key, 4)``, the second
of which is also the one ``sample_states`` would draw its paths from (the
JAX package's predict samples its window's paths as sample_states does).
The tree and chunked routes of ``lds.predict`` are held to its sequential
route under the same noise. Discrete paths
must be identical, trajectories and values agree at rtol 1e-8 / atol
1e-10. The globals are drawn by the port's own inits (float64, CPU) and
handed to the JAX package as NumPy arrays; every JAX reference is one XLA
program, compiled once in a module fixture. The problems are small: the
SLDS at T=6, K=3, d=2, 3 mean-field sweeps; the LDS at T=6, d=2; B=2, S=2,
4 forecast steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.models import lds as jax_lds
from svae_tpu.models import slds as jax_slds
from svae_tpu.ops import hmm as jax_hmm

from svae_tpu_torch.expfam import mniw
from svae_tpu_torch.models import lds, slds
from svae_tpu_torch.ops import hmm
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map

torch.set_num_threads(1)
K, d, B, T, S, STEPS, SWEEPS = 3, 2, 2, 6, 2, 4, 3
CHUNKS = 2
F64 = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-8, atol=1e-10)


def _np(tree):
    return tree_map(lambda t: t.numpy(), tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(port, ref):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).numpy(),
                                   np.asarray(r), **TOL)


def _hmm_gumbel(key, S_):
    """hmm_sample's two draws from ``key``."""
    k0, k1 = jax.random.split(key)
    return (jax.random.gumbel(k0, S_ + (K,), jnp.float64),
            jax.random.gumbel(k1, (T - 1,) + S_ + (K,), jnp.float64))


def _lds_noise(key):
    """lds.predict's two draws from one sequence's key."""
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, (S, T, d), jnp.float64),
            jax.random.normal(k2, (STEPS, S, d), jnp.float64))


def _slds_noise(key):
    """slds.predict's four draws from one sequence's key."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return (jax.random.normal(k1, (S, T, d), jnp.float64),
            _hmm_gumbel(k2, (S,)),
            jax.random.normal(k3, (STEPS, S, d), jnp.float64),
            jax.random.gumbel(k4, (STEPS, S, K), jnp.float64))


@pytest.fixture(scope="module")
def model():
    """Globals, potentials and every JAX reference of this file."""
    g = torch.Generator().manual_seed(41)
    lds_glob = lds.init_pgm_param(d, g, **F64)
    slds_glob = slds.init_pgm_param(K, d, g, **F64)
    rng = np.random.default_rng(42)
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))
    mask = (rng.random((B, T)) > 0.3).astype(np.float64)
    li = np.log(rng.dirichlet(np.ones(K)))
    lt = np.log(rng.dirichlet(np.ones(K), size=K))
    lo = 2.0 * rng.standard_normal((B, T, K))
    keys = jax.random.split(jax.random.key(43), B)
    jl, js = _np(lds_glob), _np(slds_glob)

    def references(jd, h, mask, li, lt, lo):
        per_seq = lambda f, *a: jax.vmap(f)(*a)
        return dict(
            posterior_mean=jax_mniw.posterior_mean_params(js[3]),
            expectedstats=jax_lds.pgm_expectedstats(jl),
            hmm=per_seq(lambda o, k: jax_hmm.hmm_sample(li, lt, o, k, (S,)),
                        lo, keys),
            hmm_gumbel=per_seq(lambda k: _hmm_gumbel(k, (S,)), keys),
            lds=jax_lds.predict(jl, (jd, h), jax.random.key(44), STEPS, S,
                                mask=mask),
            lds_noise=per_seq(_lds_noise,
                              jax.random.split(jax.random.key(44), B)),
            slds=jax_slds.predict(js, (jd, h), jax.random.key(45), STEPS, S,
                                  num_meanfield_iters=SWEEPS, mask=mask),
            slds_noise=per_seq(_slds_noise,
                               jax.random.split(jax.random.key(45), B)))

    args = (jd, h, mask, li, lt, lo)
    # XLA's backend optimizations cost a third of the compile and change
    # no float64 value this file compares
    refs = jax.jit(references).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    return dict(lds_glob=lds_glob, slds_glob=slds_glob, jd=jd, h=h,
                mask=mask, li=li, lt=lt, lo=lo,
                **jax.tree.map(np.asarray, refs))


def _pots(m):
    return torch.from_numpy(m["jd"]), torch.from_numpy(m["h"])


# --------------------------------------------------------------------------
# discrete paths
# --------------------------------------------------------------------------


def test_hmm_sample_matches_jax(model):
    """The same paths as the JAX package's per-sequence draws; with one
    sample and no sample axis, the first sample's path."""
    args = tuple(torch.from_numpy(model[k]) for k in ("li", "lt", "lo"))
    g0, gs = _t(model["hmm_gumbel"])
    paths = hmm.hmm_sample(*args, None, S, gumbel_noise=(g0, gs))
    assert paths.dtype == torch.int32 and paths.shape == (B, S, T)
    np.testing.assert_array_equal(paths.numpy(), model["hmm"])
    one = hmm.hmm_sample(*args, None, (), gumbel_noise=(g0[:, 0],
                                                        gs[:, :, 0]))
    assert one.shape == (B, T)
    np.testing.assert_array_equal(one.numpy(), model["hmm"][:, 0])


def test_hmm_sample_draws_with_the_generator():
    """Without an override the generator draws the noise: the same seed
    gives the same paths, a near-deterministic chain gives its one path,
    and ``parallel=`` is not ported."""
    lo = torch.full((2, 5, 3), -30.0, dtype=torch.float64)
    lo[:, :, 1] = 0.0
    args = (torch.zeros(3, dtype=torch.float64),
            torch.zeros(3, 3, dtype=torch.float64), lo)
    draw = lambda: hmm.hmm_sample(*args, torch.Generator().manual_seed(1), 4)
    paths = draw()
    assert torch.equal(paths, draw())
    assert bool((paths == 1).all())
    with pytest.raises(NotImplementedError):
        hmm.hmm_sample(*args, None, 4, parallel=True)


def test_sample_states_matches_jax(model):
    """Masked batch: the paths that the JAX package's slds.predict draws
    for its window, which are sample_states's (svae_tpu/models/slds.py
    predict: local_meanfield with no gradient sweep, _z_chain_inputs and
    hmm_sample on the second of its four keys), under that key's draws;
    one sequence samples as a batch of one."""
    gumbel = _t(model["slds_noise"][1])
    mask = torch.from_numpy(model["mask"])
    paths = slds.sample_states(model["slds_glob"], _pots(model), None, S,
                               num_meanfield_iters=SWEEPS, mask=mask,
                               gumbel_noise=gumbel)
    np.testing.assert_array_equal(paths.numpy(), model["slds"][1][..., :T])
    one = slds.sample_states(model["slds_glob"],
                             tuple(x[0] for x in _pots(model)), None, S,
                             num_meanfield_iters=SWEEPS, mask=mask[0],
                             gumbel_noise=tuple(g[:1] for g in gumbel))
    np.testing.assert_array_equal(one.numpy(), paths[0].numpy())


# --------------------------------------------------------------------------
# forecasts
# --------------------------------------------------------------------------


def test_posterior_mean_params_and_lds_expectedstats_match_jax(model):
    _close(mniw.posterior_mean_params(model["slds_glob"][3]),
           model["posterior_mean"])
    _close(lds.pgm_expectedstats(model["lds_glob"]), model["expectedstats"])


def _lds_predict(m, pots, mask=None, parallel=False, batch=slice(None)):
    eps, step_eps = (torch.from_numpy(a)[batch] for a in m["lds_noise"])
    return lds.predict(m["lds_glob"], pots, None, STEPS, S,
                       parallel=parallel, mask=mask,
                       eps=eps.transpose(0, 1),
                       step_eps=step_eps.permute(1, 2, 0, 3))


def test_lds_predict_matches_jax(model):
    """Window samples and rollout of a masked batch on the sequential
    route (the stationary filter and sampler)."""
    traj = _lds_predict(model, _pots(model), torch.from_numpy(model["mask"]))
    assert traj.shape == (B, S, T + STEPS, d)
    _close(traj, model["lds"])


@pytest.mark.parametrize("parallel", [True, CHUNKS])
def test_lds_predict_parallel_routes(model, parallel):
    """The tree and chunked routes give the sequential route's forecast
    under the same noise (the JAX package holds its scan flavors to each
    other in its own tests)."""
    _close(_lds_predict(model, _pots(model), parallel=parallel),
           _lds_predict(model, _pots(model)).numpy())


def test_lds_predict_of_one_sequence(model):
    """An unbatched window forecasts as a batch of one."""
    mask = torch.from_numpy(model["mask"])
    traj = _lds_predict(model, tuple(x[0] for x in _pots(model)), mask[0],
                        batch=slice(0, 1))
    _close(traj, model["lds"][0])


def test_slds_predict_matches_jax(model):
    """Masked batch: identical z paths, window and rollout trajectories at
    rtol 1e-8, under the JAX package's four draws per sequence."""
    eps, gumbel, step_eps, step_gumbel = _t(model["slds_noise"])
    x, z = slds.predict(model["slds_glob"], _pots(model), None, STEPS, S,
                        num_meanfield_iters=SWEEPS,
                        mask=torch.from_numpy(model["mask"]),
                        eps=eps.transpose(0, 1), gumbel_noise=gumbel,
                        step_eps=step_eps.permute(1, 2, 0, 3),
                        step_gumbel=step_gumbel.permute(1, 2, 0, 3))
    x_r, z_r = model["slds"]
    assert z.dtype == torch.int32 and z.shape == (B, S, T + STEPS)
    np.testing.assert_array_equal(z.numpy(), z_r)
    _close(x, x_r)


def test_forecasts_draw_with_the_generator(model):
    """Without overrides each forecast draws its noise from the generator:
    the same seed gives the same trajectories, and every value is
    finite."""
    for fn, kw in ((lds.predict, {}),
                   (slds.predict, dict(num_meanfield_iters=SWEEPS))):
        glob = model["slds_glob" if fn is slds.predict else "lds_glob"]
        run = lambda: fn(glob, _pots(model),
                         torch.Generator().manual_seed(5), STEPS, S, **kw)
        a, b = run(), run()
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
            assert bool(torch.isfinite(x.double()).all())
