"""Parity of the port's serving path (svae_tpu_torch/models/streaming.py,
``lds.make_online_filter``, ``lds.expected_chain_potentials`` and
``slds.make_online_filter``) with the JAX package, in float64 on the CPU.

The JAX side is one XLA program compiled once in a module fixture: its
filters ``jax.vmap``ped over B streams and replayed by ``lax.scan``
(``streaming.replay``), the port's on (B, d) potentials a frame, with no
vmap. The switching filter runs at K=3 with asymmetric transition and
initial Dirichlets, so that collapsing over the wrong regime axis shows.
Values agree at rtol 1e-8 / atol 1e-10. B=2, T=6, d=2. Four tests, so
that xdist's ``--dist loadfile`` runs the file beside
tests/test_time_shard.py instead of ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.models import lds as jax_lds
from svae_tpu.models import slds as jax_slds
from svae_tpu.models import streaming as jax_streaming

from svae_tpu_torch.models import lds, slds, streaming
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map

torch.set_num_threads(1)
B, T, d, K = 2, 6, 2, 3
F64 = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-8, atol=1e-10)


def _close(port, ref, tol=TOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).numpy(),
                                   np.asarray(r), **tol)


def _np(tree):
    return tree_map(lambda t: t.numpy(), tree)


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(11)
    lds_glob = lds.init_pgm_param(d, g, **F64)
    init_dir, trans_dir, niw_np, mniw_np = slds.init_pgm_param(K, d, g,
                                                               **F64)
    slds_glob = (init_dir + 2.0 * torch.rand(K, generator=g, **F64),
                 trans_dir + 4.0 * torch.rand((K, K), generator=g, **F64),
                 niw_np, mniw_np)
    rng = np.random.default_rng(12)
    jd = np.logaddexp(rng.standard_normal((B, T, d)), 0.0) + 0.4
    h = rng.standard_normal((B, T, d))

    def references(lds_glob, slds_glob, jd, h):
        f = jax_lds.make_online_filter(lds_glob, dtype=jnp.float64)
        s = jax_slds.make_online_filter(slds_glob, dtype=jnp.float64)
        replay = lambda filt: jax.vmap(
            lambda p: jax_streaming.replay(*filt, p))((jd, h))
        return dict(lds=replay(f), slds=replay(s),
                    potentials=jax_lds.expected_chain_potentials(
                        lds_glob, T, dtype=jnp.float64))

    args = (_np(lds_glob), _np(slds_glob), jd, h)
    ref = jax.jit(references).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    return dict(lds_glob=lds_glob, slds_glob=slds_glob,
                pots=(torch.from_numpy(jd), torch.from_numpy(h)), **ref)


def test_lds_online_filter_matches_jax(model):
    """Filtered means, covariances and each frame's log-evidence of B
    streams against the vmapped JAX filter; their sum is the smoother's
    logZ; and expected_chain_potentials against JAX's."""
    f = lds.make_online_filter(model["lds_glob"], dtype=torch.float64)
    outs = streaming.replay(*f, model["pots"])
    assert [tuple(x.shape) for x in outs] == [(B, T, d), (B, T, d, d),
                                              (B, T)]
    _close(outs, model["lds"])
    logZ = lds.posterior_moments(model["lds_glob"], model["pots"])[3]
    np.testing.assert_allclose(outs[2].sum(1).numpy(), logZ.numpy(), **TOL)
    _close(lds.expected_chain_potentials(model["lds_glob"], T,
                                         dtype=torch.float64),
           model["potentials"])


def test_slds_online_filter_matches_jax(model):
    """The GPB2 filter's regime weights, collapsed means and covariances
    and log-evidence against the vmapped JAX filter at K=3 with asymmetric
    transitions; the weights sum to 1."""
    f = slds.make_online_filter(model["slds_glob"], dtype=torch.float64)
    outs = streaming.replay(*f, model["pots"])
    assert [tuple(x.shape) for x in outs] == [(B, T, K), (B, T, d),
                                              (B, T, d, d), (B, T)]
    _close(outs, model["slds"])
    np.testing.assert_allclose(outs[0].sum(-1).numpy(), 1.0, rtol=0,
                               atol=1e-14)


def test_slds_filter_with_one_state_is_the_lds_filter(model):
    """At K=1 every GPB2 step is exact: the switching filter gives the LDS
    filter's means, covariances and log-evidence on the same globals."""
    g = torch.Generator().manual_seed(13)
    glob = slds.init_pgm_param(1, d, g, **F64)
    lds_glob = (glob[2], tuple(x[0] for x in glob[3]))
    w, *rest = streaming.replay(
        *slds.make_online_filter(glob, dtype=torch.float64), model["pots"])
    want = streaming.replay(
        *lds.make_online_filter(lds_glob, dtype=torch.float64),
        model["pots"])
    assert bool((w == 1.0).all())
    _close(rest, [x.numpy() for x in want])


def test_window_filter_is_single_frames_bit_for_bit(model):
    """For both filters, windows of W = 1, 2 and 3 frames chained over the
    stream, and a replay, give the states and outputs of T single-frame
    steps bit for bit."""
    for which in ("lds", "slds"):
        _check_windows(model, which)


def _check_windows(model, which):
    mod = lds if which == "lds" else slds
    init_fn, step_fn = mod.make_online_filter(model[which + "_glob"],
                                              dtype=torch.float64)
    jd, h = model["pots"]
    state, out = init_fn((jd[:, 0], h[:, 0]))
    outs = [out]
    for t in range(1, T):
        state, out = step_fn(state, (jd[:, t], h[:, t]))
        outs.append(out)
    want = tuple(torch.stack(o, 1) for o in zip(*outs))
    assert all(torch.equal(a, b) for a, b in zip(
        streaming.replay(init_fn, step_fn, model["pots"]), want))
    win_init, win_step = streaming.make_window_filter(init_fn, step_fn)
    for W in (1, 2, 3):
        st, first = win_init((jd[:, :W], h[:, :W]))
        got = [first]
        for t0 in range(W, T, W):
            st, o = win_step(st, (jd[:, t0:t0 + W], h[:, t0:t0 + W]))
            got.append(o)
        got = tuple(torch.cat(o, 1) for o in zip(*got))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(st, state))
