"""Parity of the port's forward-only shared-pair E-step
(svae_tpu_torch/ops/kalman_fwd.py) with the JAX package, in float64 on the
CPU.

* (a) The plain twins and every entry point at B=3, T=7, d=3 with pairs
  that vary in time (tests/test_oracles.py's generative potentials),
  against the JAX package's XLA references ``kalman.lds_filter`` and
  ``kalman.lds_smoother``, vmapped over the batch (the references
  tests/test_pallas_kalman.py holds the Pallas kernels to); the sampler at
  zero noise against the smoothed mean, an exact identity.
* (b) One interpret-mode call of each Pallas entry point at B=3, T=5, d=2
  (``lds_filter_pallas``, ``lds_backward_pallas``,
  ``lds_sample_pallas(eps=)``, ``lds_filter_pallas_bpairs`` and
  ``lds_estep_pallas``, whose noise ``normal(key, (S, B, T, d))`` is
  rebuilt here and passed to the port as ``eps``), which pins the
  log-normalizer convention, the zero row of the beta messages and the
  sample layout.
* (c) CPU tensors take the plain versions: no launch counter moves.
* (d) An input that requires grad raises; the kernel wrappers' checks, on
  meta tensors.

Every JAX reference is compiled once, in a module fixture. Tolerance rtol
1e-8 / atol 1e-10 (both sides float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.ops import kalman as jax_kalman
from svae_tpu.ops import pallas_kalman

from svae_tpu_torch.ops import bpairs, kalman_fwd
from svae_tpu_torch.utils.psd import mvn_logZ_info
from svae_tpu_torch.utils.pytree import tree_leaves
from tests.test_oracles import make_lds_potentials

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10


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


def chain(B, T, d, seed, per_sequence=False):
    """A batch of chains: shared pairs that vary in time (or, with
    ``per_sequence``, those pairs with P1 and P3 scaled per sequence by a
    factor in [1, 1.2], which keeps every pair block positive
    semidefinite), diagonal node evidence per sequence; numpy float64."""
    init, pairs, (N1, _) = make_lds_potentials(T=T, d=d, seed=seed,
                                               time_varying=True)
    rng = np.random.default_rng(seed + 100)
    jd = rng.uniform(0.2, 2.0, (B, T, d))
    N1 = -0.5 * jd[..., None] * np.eye(d)
    N2 = rng.standard_normal((B, T, d))
    if per_sequence:
        s = 1.0 + 0.2 * rng.random((B, 1, 1, 1))
        P1, P2, P3, Pc = pairs
        pairs = (s * P1, np.broadcast_to(P2, (B,) + P2.shape).copy(),
                 s * P3, np.broadcast_to(Pc, (B,) + Pc.shape).copy())
    return init, pairs, (N1, N2)


# --------------------------------------------------------------------------
# (a) against the JAX package's XLA references
# --------------------------------------------------------------------------

B, T, d, S = 3, 7, 3, 2


@pytest.fixture(scope="module")
def xla():
    init, pairs, nodes = chain(B, T, d, seed=0)

    @jax.jit
    def ref(init, pairs, nodes):
        f = jax.vmap(lambda n: jax_kalman.lds_filter(init, pairs, n))(nodes)
        s = jax.vmap(lambda n: jax_kalman.lds_smoother(init, pairs, n))(nodes)
        return f, s

    return dict(args=(_t(init), _t(pairs), _t(nodes)),
                ref=ref(init, pairs, nodes))


def test_filter_matches_xla(xla):
    init, pairs, nodes = xla["args"]
    logZ_r, Jf_r, hf_r = xla["ref"][0]
    _close(kalman_fwd.lds_filter(init, pairs, nodes), (logZ_r, Jf_r, hf_r))
    # the twin on the kernel's arguments: the messages of frames 1..T-1
    # and the log-normalizer without Ic and the last frame's log-partition
    Jf, hf = _t(Jf_r), _t(hf_r)
    rows = lambda P: P.reshape(T - 1, d * d)
    pack = bpairs._pack
    J, h, ln = kalman_fwd.filter_shared_plain(
        Jf[:, 0].reshape(B, d * d).T, hf[:, 0].T, rows(pairs[0]),
        rows(pairs[1]), rows(pairs[2]), pairs[3], pack(nodes[0][:, 1:]),
        pack(nodes[1][:, 1:]))
    _close((J, h), (pack(Jf[:, 1:]), pack(hf[:, 1:])))
    _close(ln + init[2] + mvn_logZ_info(Jf[:, -1], hf[:, -1]),
           logZ_r)


def test_smoother_and_estep_match_xla(xla):
    init, pairs, nodes = xla["args"]
    smoothed = xla["ref"][1]
    _close(kalman_fwd.lds_smoother(init, pairs, nodes), smoothed)
    eps = torch.zeros((S, B, T, d), dtype=torch.float64)
    samples, moments, logZ = kalman_fwd.lds_estep(init, pairs, nodes, None,
                                                  S, eps=eps)
    _close((logZ,) + moments, smoothed)
    # zero noise: the backward conditional means compose to the smoothed
    # mean, exactly
    _close(samples, np.broadcast_to(smoothed[1], samples.shape))


def test_backward_messages_complete_the_smoother(xla):
    """Jf + Jb and hf + hb are the smoothed natural parameters: Ex and the
    node covariances of the XLA smoother."""
    init, pairs, nodes = xla["args"]
    _, Jf, hf = kalman_fwd.lds_filter(init, pairs, nodes)
    Jb, hb = kalman_fwd.lds_backward(pairs, nodes)
    assert not Jb[:, -1].any() and not hb[:, -1].any()
    cov = torch.linalg.inv(Jf + Jb)
    Ex = (cov @ (hf + hb)[..., None])[..., 0]
    _, Ex_r, ExxT_r, _ = xla["ref"][1]
    _close(Ex, Ex_r)
    _close(cov, ExxT_r - Ex_r[..., :, None] * Ex_r[..., None, :])


# --------------------------------------------------------------------------
# (b) against the Pallas entry points in interpret mode
# --------------------------------------------------------------------------

PB, PT, PD, PS = 3, 5, 2, 2


@pytest.fixture(scope="module")
def pallas():
    init, pairs, nodes = chain(PB, PT, PD, seed=1)
    bp_pairs = chain(PB, PT, PD, seed=1, per_sequence=True)[1]
    key = jax.random.key(5)
    eps = np.random.default_rng(6).standard_normal((PS, PB, PT, PD))

    @jax.jit
    def ref(init, pairs, nodes, bp_pairs, eps):
        kw = dict(interpret=True)
        return dict(
            filter=pallas_kalman.lds_filter_pallas(init, pairs, nodes, **kw),
            backward=pallas_kalman.lds_backward_pallas(pairs, nodes, **kw),
            sample=pallas_kalman.lds_sample_pallas(init, pairs, nodes, None,
                                                   PS, eps=eps, **kw),
            bpairs=pallas_kalman.lds_filter_pallas_bpairs(init, bp_pairs,
                                                          nodes, **kw),
            estep=pallas_kalman.lds_estep_pallas(init, pairs, nodes, key, PS,
                                                 **kw))

    return dict(args=(_t(init), _t(pairs), _t(nodes)), bp_pairs=_t(bp_pairs),
                eps=_t(eps),
                key_eps=_t(jax.random.normal(key, (PS, PB, PT, PD),
                                             jnp.float64)),
                ref=ref(init, pairs, nodes, bp_pairs, eps))


def test_entry_points_match_pallas_kalman(pallas):
    init, pairs, nodes = pallas["args"]
    ref = pallas["ref"]
    _close(kalman_fwd.lds_filter(init, pairs, nodes), ref["filter"])
    _close(kalman_fwd.lds_backward(pairs, nodes), ref["backward"])
    _close(kalman_fwd.lds_sample(init, pairs, nodes, None, PS,
                                 eps=pallas["eps"]), ref["sample"])
    _close(kalman_fwd.lds_filter_bpairs(init, pallas["bp_pairs"], nodes),
           ref["bpairs"])
    _close(kalman_fwd.lds_estep(init, pairs, nodes, None, PS,
                                eps=pallas["key_eps"]), ref["estep"])


# --------------------------------------------------------------------------
# (c) the CPU route; (d) what the entry points and wrappers refuse
# --------------------------------------------------------------------------

WRAPPERS = (kalman_fwd.filter_shared, kalman_fwd.backward_shared,
            kalman_fwd.sampler_shared, bpairs.bidir_fwd, bpairs.bidir_adj)
PLAINS = (kalman_fwd.filter_shared_plain, kalman_fwd.backward_shared_plain,
          kalman_fwd.sampler_shared_plain)


def test_cpu_tensors_take_the_plain_versions(xla):
    init, pairs, nodes = xla["args"]
    calls = [p.calls for p in PLAINS]
    kalman_fwd.lds_estep(init, pairs, nodes, torch.Generator().manual_seed(0),
                         S)
    kalman_fwd.lds_filter_bpairs(init, pairs, nodes)
    assert [p.calls - c for p, c in zip(PLAINS, calls)] == [1, 1, 1]
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


ENTRIES = {
    "lds_filter": lambda i, p, n: kalman_fwd.lds_filter(i, p, n),
    "lds_backward": lambda i, p, n: kalman_fwd.lds_backward(p, n),
    "lds_smoother": lambda i, p, n: kalman_fwd.lds_smoother(i, p, n),
    "lds_sample": lambda i, p, n: kalman_fwd.lds_sample(
        i, p, n, torch.Generator().manual_seed(0), S),
    "lds_estep": lambda i, p, n: kalman_fwd.lds_estep(
        i, p, n, torch.Generator().manual_seed(0), S),
    "lds_filter_bpairs": lambda i, p, n: kalman_fwd.lds_filter_bpairs(i, p,
                                                                      n),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_inputs_that_require_grad_raise(xla, entry):
    """The kernels have no adjoint, as the Pallas ones have no custom_vjp:
    an input that requires grad raises, and under ``torch.no_grad()`` the
    same call runs."""
    init, pairs, nodes = xla["args"]
    nodes = (nodes[0], nodes[1].clone().requires_grad_())
    with pytest.raises(ValueError, match="forward only"):
        ENTRIES[entry](init, pairs, nodes)
    with torch.no_grad():
        out = ENTRIES[entry](init, pairs, nodes)
    assert not any(x.requires_grad for x in tree_leaves(out))


def test_per_sequence_pairs_are_refused(xla):
    init, pairs, nodes = xla["args"]
    per_seq = tuple(p.expand((B,) + p.shape) for p in pairs)
    with pytest.raises(ValueError, match="shared over the batch"):
        kalman_fwd.lds_filter(init, per_seq, nodes)


def _meta(shape, dt=torch.float32):
    return torch.empty(shape, dtype=dt, device="meta")


def _kernel_args(kernel, dt=torch.float32, dim=d):
    T1, dd, SB = T - 1, dim * dim, S * B
    rows, node = [(T1, dd)] * 3, [(T1, dd, B), (T1, dim, B)]
    shapes = {"filter_shared": [(dd, B), (dim, B)] + rows + [(T1,)] + node,
              "backward_shared": rows + node,
              "sampler_shared": rows[:2] + node + [(T1, dim, SB), (dim, SB)]}
    return [_meta(s, dt) for s in shapes[kernel]]


@pytest.mark.parametrize("kernel", ["filter_shared", "backward_shared",
                                    "sampler_shared"])
def test_wrappers_reject_what_the_kernels_do_not_take(kernel):
    """Off the CPU a wrapper launches its kernel or raises; on tensors that
    are neither CPU nor CUDA (``meta``) its checks run without a card."""
    wrapper = getattr(kalman_fwd, kernel)
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
    with pytest.raises(ValueError, match="d=5"):
        wrapper(*_kernel_args(kernel, dim=5))
    assert wrapper.launches == 0
