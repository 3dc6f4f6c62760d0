"""Parity of the port's chain-element Kalman inference
(svae_tpu_torch/ops/kalman.py) with the JAX package's
svae_tpu/ops/kalman.py, in float64 on the CPU.

* The element algebra (``combine``, ``marginalize_first`` / ``_last``,
  ``build_leaves`` with shared and per-sequence pairs) against
  svae_tpu/ops/kalman.py on the leaves of tests/test_oracles.py's
  ``make_lds_potentials`` (d=3).
* ``lds_logZ``, ``lds_filter``, ``lds_smoother``, ``lds_sample`` and
  ``lds_inference`` in every scan flavor, ``parallel`` in {False, True, 4,
  3} (the loop, the log-depth tree against ``lax.associative_scan``, and
  the blocked two-pass scan, whose 10 leaves at T=11 take two pad rows at
  C=4 and at C=3), at T=11, against the JAX package's same flavor, one
  ``jax.jit`` per flavor of the JAX package's smoother core (log-partition,
  moments and the filtered messages) and of its sampler on those
  messages; ``lds_logZ`` and ``lds_filter``'s log-partition are held to
  the smoother's. At T=2 the chain has one leaf and every flavor of the
  JAX package computes the same thing, so the port's four flavors are
  held to one JAX reference there.
* The gradient identities of ``lds_logZ`` (tests/test_kalman.py's, at its
  tolerances) in every flavor.

The model's parallel routes are held to the JAX package in
tests/test_torch_chunked.py.

The sampler's noise is the JAX package's own draw, ``normal(key, (S, T,
d))`` per sequence under ``jax.random.split(key, B)``, handed to the port
as ``eps=``. Tolerance rtol 1e-8 / atol 1e-10 unless a test says
otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.ops import kalman as jax_kalman

from svae_tpu_torch.ops import kalman
from svae_tpu_torch.utils.pytree import tree_leaves
from tests.test_oracles import make_lds_potentials

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
B, S, d = 2, 2, 3
FLAVORS = [False, True, 4, 3]


def _t(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_t(x) for x in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float64))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=rtol, atol=atol)


def chain(T, seed=0):
    """make_lds_potentials' init and pairs (time-varying) with B sequences
    of node evidence: N1 shared, N2 per sequence."""
    init, pairs, nodes = make_lds_potentials(T=T, d=d, seed=seed,
                                             time_varying=True)
    N1 = np.tile(nodes[0][None], (B, 1, 1, 1))
    N2 = np.random.default_rng(seed + 1).standard_normal((B, T, d))
    return init, pairs, (N1, N2)


def jax_eps(key, T, batch=B):
    """The JAX package's per-sequence sampler noise as the port's (S, B, T,
    d) ``eps``."""
    eps = jax.vmap(lambda k: jax.random.normal(k, (S, T, d), jnp.float64))(
        jax.random.split(key, batch))
    return torch.from_numpy(np.array(eps)).movedim(0, 1)


@pytest.fixture(scope="module")
def refs():
    """Per (T, flavor): the JAX package's ``((logZ, Ex, ExxT, Exnxt, Jf,
    hf), samples)`` stacked over the sequences, the chain and the noise.
    One jit per flavor runs each sequence in turn (a vmap would add a
    quarter to the trace)."""
    out = {}
    key = jax.random.key(3)
    keys = jax.random.split(key, B)
    for T, flavors in ((11, FLAVORS), (2, [False])):
        init, pairs, nodes = chain(T)
        for par in flavors:
            def one(n1, n2, k, par=par):
                core = jax_kalman._smoother_core(init, pairs, (n1, n2),
                                                 parallel=par)
                return core, jax_kalman.lds_sample(
                    init, pairs, (n1, n2), k, S, parallel=par,
                    filtered=core[4:])
            # without XLA's backend optimizations, which change no
            # float64 value
            one = jax.jit(one).lower(nodes[0][0], nodes[1][0], keys[0]
                                     ).compile(
                {"xla_backend_optimization_level": 0})
            ref = jax.tree.map(lambda *xs: np.stack(xs),
                               *[one(nodes[0][b], nodes[1][b], keys[b])
                                 for b in range(B)])
            out[T, par] = (ref, (init, pairs, nodes), jax_eps(key, T))
    return out


# --------------------------------------------------------------------------
# element algebra
# --------------------------------------------------------------------------


def test_element_algebra_matches_jax():
    """``combine`` of every pair of neighbouring leaves, both
    marginalizations of the combined elements and the log-normalizer of
    their first-marginals."""
    init, pairs, nodes = chain(11)

    @jax.jit
    def ref(init, pairs, n1, n2):
        leaves = jax_kalman.build_leaves(init, pairs, (n1, n2))
        both = jax_kalman.combine(tuple(x[:-1] for x in leaves),
                                  tuple(x[1:] for x in leaves))
        first = jax_kalman.marginalize_first(both)
        return (leaves, both, first, jax_kalman.marginalize_last(both),
                jax_kalman._gauss_logZ_info(*first))

    leaves_j, both_j, first_j, last_j, logZ_j = ref(init, pairs,
                                                    nodes[0][0], nodes[1][0])
    leaves = _t(leaves_j)
    both = kalman.combine(tuple(x[:-1] for x in leaves),
                          tuple(x[1:] for x in leaves))
    _close(both, both_j)
    _close(kalman.marginalize_first(both), first_j)
    _close(kalman.marginalize_last(both), last_j)
    _close(kalman._gauss_logZ_info(*kalman.marginalize_first(both)),
           logZ_j)


@pytest.mark.parametrize("per_sequence", [False, True])
def test_build_leaves_matches_jax(per_sequence):
    """Leaves of shared (T-1, ...) pairs, and of per-sequence (B, T-1, ...)
    pairs (each sequence its own time-varying pairs), against the JAX
    package's per sequence."""
    init, pairs, nodes = chain(11)
    if per_sequence:
        others = [make_lds_potentials(T=11, d=d, seed=s, time_varying=True)[1]
                  for s in range(B)]
        pairs = tuple(np.stack(p) for p in zip(*others))
    got = kalman.build_leaves(_t(init), _t(pairs), _t(nodes))
    in_axes = (None, 0 if per_sequence else None, 0)
    want = jax.vmap(jax_kalman.build_leaves, in_axes=in_axes)(
        init, pairs, nodes)
    _close(got, want)


def test_per_sequence_pairs_match_each_sequence_alone():
    """A batch with per-sequence pairs equals each sequence run alone on
    its own shared pairs, in every flavor."""
    init, _, nodes = chain(11)
    per = [make_lds_potentials(T=11, d=d, seed=s, time_varying=True)[1]
           for s in range(B)]
    pairs = _t(tuple(np.stack(p) for p in zip(*per)))
    for par in FLAVORS:
        got = kalman.lds_smoother(_t(init), pairs, _t(nodes), parallel=par)
        for b in range(B):
            alone = kalman.lds_smoother(
                _t(init), _t(per[b]), tuple(x[b:b + 1] for x in _t(nodes)),
                parallel=par)
            for g, a in zip(got, alone):
                np.testing.assert_allclose(g[b:b + 1].numpy(), a.numpy(),
                                           rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the scan flavors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T", [11, 2])
@pytest.mark.parametrize("par", FLAVORS)
def test_flavor_matches_jax(refs, T, par):
    """lds_logZ, lds_filter, lds_smoother, lds_sample (under the JAX
    package's noise) and lds_inference in one flavor."""
    ((logZ_r, Ex_r, ExxT_r, Exnxt_r, Jf_r, hf_r), samples_r), \
        (init, pairs, nodes), eps = refs[T, par if T > 2 else False]
    moments_r = (Ex_r, ExxT_r, Exnxt_r)
    samples_r = np.moveaxis(np.asarray(samples_r), 0, 1)   # (S, B, T, d)
    args = (_t(init), _t(pairs), _t(nodes))
    _close(kalman.lds_logZ(*args, parallel=par), logZ_r)
    _close(kalman.lds_filter(*args, parallel=par), (logZ_r, Jf_r, hf_r))
    _close(kalman.lds_smoother(*args, parallel=par), (logZ_r,) + moments_r)
    _close(kalman.lds_sample(*args, None, S, parallel=par, eps=eps),
           samples_r)
    _close(kalman.lds_inference(*args, None, S, parallel=par, eps=eps),
           (samples_r, moments_r, logZ_r))


@pytest.mark.parametrize("par", FLAVORS)
def test_logZ_gradient_identities(par):
    """dlogZ/dN1 = E[xx^T], dlogZ/dN2 = E[x], dlogZ/dP2 = E[x' x^T],
    dlogZ/dP1 = E[x' x'^T], dlogZ/dP3 = E[x x^T], dlogZ/dPc = 1 (the
    identities and tolerances of tests/test_kalman.py)."""
    init, pairs, nodes = make_lds_potentials(T=8, d=2, seed=5)
    init = _t(init)
    pairs = tuple(x[None].requires_grad_() for x in _t(pairs))
    nodes = tuple(x[None].requires_grad_() for x in _t(nodes))
    logZ = kalman.lds_logZ(init, pairs, nodes, parallel=par)
    gP1, gP2, gP3, gPc, gN1, gN2 = torch.autograd.grad(logZ.sum(),
                                                       pairs + nodes)
    with torch.no_grad():
        _, Ex, ExxT, Exnxt = kalman.lds_smoother(init, pairs, nodes,
                                                 parallel=par)
    sym = lambda m: 0.5 * (m + m.mT)
    tol = dict(rtol=1e-6, atol=1e-8)
    _close(sym(gN1), ExxT.numpy(), **tol)
    _close(gN2, Ex.numpy(), **tol)
    _close(gP2, Exnxt.mT.numpy(), **tol)
    _close(sym(gP1), ExxT[:, 1:].numpy(), **tol)
    _close(sym(gP3), ExxT[:, :-1].numpy(), **tol)
    _close(gPc, np.ones(gPc.shape), rtol=1e-6, atol=0)
