"""Parity of the port's chunked parallel-in-time E-step
(svae_tpu_torch/ops/chunked.py) and of the model's ``parallel=`` routes
(svae_tpu_torch/models/lds.py) with the JAX package, in float64 on the
CPU.

* ``elem_scan_plain`` and ``elem_scan_adj_plain`` against the Pallas
  kernels ``pallas_chunked._scan_fwd_kernel`` and ``_scan_adj_kernel``,
  called directly in interpret mode at d=2 and d=3 on the same packed
  leaves (128 lanes of chains built from tests/test_oracles.py's
  potentials) and random cotangents.
* ``chunked.lds_smoother`` and ``chunked.lds_estep`` (samples under the
  JAX package's noise) for C in {1, 2, 4, 10} at
  tests/test_pallas_chunked.py's shape (B=3, T=11, d=3; C=4 pads the 10
  leaves to 12) against ``pallas_chunked.lds_estep`` at C=4 in interpret
  mode, and the chunked smoother's gradient at each C against the
  gradient through ``pallas_chunked.lds_smoother`` at C=4 (its adjoint
  kernel in interpret mode): pallas_chunked's outputs do not depend on C
  beyond rounding (tests/test_pallas_chunked.py holds every C to the
  sequential scan at rtol 1e-9), so one compile of each serves the four.
* ``lds.run_inference`` (samples under the JAX package's noise,
  statistics, both KLs) and ``posterior_moments`` with ``parallel=True``,
  ``parallel=4`` and ``parallel=0`` (the sequential route), with and
  without ``mask=`` and ``lengths=``, and a bad ``parallel`` raising; one
  ``make_train_step(partial(run_inference, parallel=4))`` step (ELBO,
  natural gradient, net gradients) against the JAX package's
  ``backend="xla"`` path with its sequential scan, whose flavors differ
  only by rounding (its own tests hold each to the sequential one); the
  flavor-for-flavor parity of the scans is tests/test_torch_kalman.py's.
* The kernel wrappers' argument checks, on meta tensors.

Every JAX reference comes from one XLA program, compiled once in a module
fixture without XLA's backend optimizations. Tolerance rtol 1e-8 /
atol 1e-10 (both sides float64) unless a test says otherwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.data import synthetic as jax_synthetic
from svae_tpu.models import lds as jax_lds
from svae_tpu.nets import decoders as jax_decoders
from svae_tpu.nets import recognition as jax_recognition
from svae_tpu.ops import pallas_chunked
from svae_tpu.train import elbo as jax_elbo

from svae_tpu_torch import convert
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.ops import chunked, kalman
from svae_tpu_torch.train import elbo, loop
from svae_tpu_torch.utils.pytree import tree_leaves
from tests.test_oracles import make_lds_potentials
from tests.test_pallas_chunked import batched_pots

# autouse: this module's JAX references trace the JAX package's
# Cholesky on its library route
from tests._jax_cholesky import jax_library_cholesky

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def _t(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_t(x) for x in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float64))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=rtol, atol=atol)


def _jax_eps(key, B, S, T, d):
    """The JAX package's per-sequence sampler noise, ``normal(key_b, (S, T,
    d))`` under ``jax.random.split(key, B)``, (B, S, T, d)."""
    return jnp.stack([jax.random.normal(k, (S, T, d), jnp.float64)
                      for k in jax.random.split(key, B)])


def _eps_t(eps):
    """(B, S, T, d) noise as the port's (S, B, T, d) ``eps``."""
    return torch.from_numpy(np.array(eps)).movedim(0, 1)


# --------------------------------------------------------------------------
# the element scan against the Pallas kernels
# --------------------------------------------------------------------------

LANES, STEPS = 128, 4


def packed_leaves(d, seed=0):
    """(STEPS, R, LANES) packed leaves: one chain of STEPS + 1 frames per
    lane, shared time-varying pairs and per-lane node evidence."""
    init, pairs, nodes = make_lds_potentials(T=STEPS + 1, d=d, seed=seed,
                                             time_varying=True)
    N1 = np.tile(nodes[0][None], (LANES, 1, 1, 1))
    N2 = np.random.default_rng(seed).standard_normal((LANES, STEPS + 1, d))
    leaves = kalman.build_leaves(_t(init), _t(pairs), _t((N1, N2)))
    return chunked._pack(leaves, STEPS)


SCAN_DS = (2, 3)


def scan_inputs(d):
    """The packed leaves of d, their plain prefix scan and random
    cotangents."""
    leaves = packed_leaves(d, seed=d)
    douts = torch.from_numpy(np.random.default_rng(d).standard_normal(
        leaves.shape))
    return leaves, chunked.elem_scan_plain(leaves), douts


def _scan_references(scans):
    """pallas_chunked's two kernels, called directly in interpret mode, on
    each d's inputs."""
    return {d: (pallas_chunked._scan_fwd_call(leaves, d=d, interpret=True),
                pallas_chunked._scan_adj_call(leaves, pref, douts, d=d,
                                              interpret=True))
            for d, (leaves, pref, douts) in scans.items()}


@pytest.mark.parametrize("d", SCAN_DS)
def test_elem_scan_plain_matches_pallas_kernel(refs, d):
    leaves, _, _ = scan_inputs(d)
    _close(chunked.elem_scan_plain(leaves), refs["scans"][d][0])


@pytest.mark.parametrize("d", SCAN_DS)
def test_elem_scan_adj_plain_matches_pallas_kernel(refs, d):
    leaves, pref, douts = scan_inputs(d)
    _close(chunked.elem_scan_adj_plain(leaves, pref, douts),
           refs["scans"][d][1])


def test_wrappers_check_their_arguments():
    """Shapes, then type and layout, then the device: meta tensors reach
    every check without a card."""
    meta = dict(dtype=torch.float32, device="meta")
    R = chunked._nrows(3)
    with pytest.raises(ValueError, match="inconsistent"):
        chunked.elem_scan(torch.empty((4, R - 1, 5), **meta))
    with pytest.raises(ValueError, match="inconsistent"):
        chunked.elem_scan_adj(torch.empty((4, R, 5), **meta),
                              torch.empty((4, R, 6), **meta),
                              torch.empty((4, R, 5), **meta))
    with pytest.raises(ValueError, match="d=5"):
        chunked.elem_scan(torch.empty((4, chunked._nrows(5), 5), **meta))
    with pytest.raises(TypeError, match="float32"):
        chunked.elem_scan(torch.empty((4, R, 5), dtype=torch.float64,
                                      device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        chunked.elem_scan(torch.empty((5, R, 4), **meta).transpose(0, 2))
    with pytest.raises(ValueError, match="CUDA"):
        chunked.elem_scan(torch.empty((4, R, 5), **meta))
    assert chunked.elem_scan.launches == 0
    assert chunked.elem_scan_adj.launches == 0


# --------------------------------------------------------------------------
# the chunked E-step against pallas_chunked
# --------------------------------------------------------------------------

CB, CT, CD, CS = 3, 11, 3, 2
CHUNK_KEY = functools.partial(jax.random.key, 5)


def _smoother_loss(outputs):
    """test_pallas_chunked.py's loss of the smoother's outputs."""
    logZ, Ex, ExxT, Exnxt = outputs
    return (logZ.sum() + (Ex * 0.3).sum() + (ExxT * 0.1).sum()
            + (Exnxt * 0.2).sum())


def _pallas_chunked_references(init, pairs, nodes):
    """pallas_chunked.lds_estep at C=4 (interpret mode) under the key
    CHUNK_KEY, and the gradient of ``_smoother_loss`` of
    ``pallas_chunked.lds_smoother`` at C=4 with respect to the node
    evidence N2."""
    estep = pallas_chunked.lds_estep(init, pairs, nodes, CHUNK_KEY(), CS,
                                     chunks=4, interpret=True)
    grad = jax.grad(lambda n2: _smoother_loss(pallas_chunked.lds_smoother(
        init, pairs, (nodes[0], n2), chunks=4, interpret=True)))(nodes[1])
    return estep, grad


@pytest.mark.parametrize("C", [1, 2, 4, 10])
def test_chunked_estep_matches_pallas_chunked(refs, C):
    (samples_r, moments_r, logZ_r), grad_r = refs["chunked"]
    init, pairs, nodes = _t(refs["chunk_pots"])
    eps = refs["chunk_eps"]
    _close(chunked.lds_smoother(init, pairs, nodes, chunks=C),
           (logZ_r,) + tuple(moments_r))
    _close(chunked.lds_estep(init, pairs, nodes, None, CS, chunks=C,
                             eps=eps), (samples_r, moments_r, logZ_r))
    n2 = nodes[1].clone().requires_grad_()
    loss = _smoother_loss(chunked.lds_smoother(init, pairs, (nodes[0], n2),
                                               chunks=C))
    _close(torch.autograd.grad(loss, n2), (grad_r,))


# --------------------------------------------------------------------------
# the model's parallel routes and a train step
# --------------------------------------------------------------------------

MB, MT, MD, MS = 3, 7, 2, 2
D_OBS, N = 6, 40
MODEL_CASES = ["plain", "mask", "lengths"]


MODEL_KEY = functools.partial(jax.random.key, 1)


def _model_references(m):
    """JAX globals and nets; the JAX package's ``run_inference`` and
    ``posterior_moments`` (``backend="xla"``) for each case (the plain
    case passes an all-ones mask and full lengths, which leave every
    potential and weight as it is: multiplications by one, additions of
    zero), and its ``make_gradfun`` outputs."""
    k = jax.random.split(jax.random.key(0), 4)
    prior = jax_lds.init_pgm_param(k[0], MD, dtype=jnp.float64)
    glob = jax_lds.init_pgm_param(k[1], MD, dtype=jnp.float64)
    rp = jax_recognition.init_mlp_recognize(k[2], D_OBS, (8,), MD,
                                            dtype=jnp.float64)
    dp = jax_decoders.init_mlp_decode(k[3], MD, (8,), D_OBS,
                                      dtype=jnp.float64)
    ones, full = jnp.ones((MB, MT)), jnp.full(MB, MT)
    cases = {"plain": (ones, full), "mask": (m["mask"], full),
             "lengths": (ones, m["lengths"])}
    refs = {}
    for c in MODEL_CASES:
        kw = dict(backend="xla", mask=cases[c][0], lengths=cases[c][1])
        refs[c] = (jax_lds.run_inference(prior, glob, (m["jd"], m["h"]),
                                         MODEL_KEY(), MS, **kw),
                   jax_lds.posterior_moments(glob, (m["jd"], m["h"]), **kw))
    gradfun = jax_elbo.make_gradfun(
        functools.partial(jax_lds.run_inference, backend="xla"),
        jax_recognition.mlp_recognize, jax_decoders.mlp_loglike, prior, N,
        num_samples=MS)
    return dict(prior=prior, glob=glob, nets=(rp, dp), refs=refs,
                grad_out=gradfun(glob, (rp, dp), m["y"], MODEL_KEY()),
                eps=_jax_eps(MODEL_KEY(), MB, MS, MT, MD))


@pytest.fixture(scope="module")
def refs():
    """Every JAX reference of this module from one XLA program, compiled
    once without XLA's backend optimizations (which change no float64
    value): the element-scan kernels at each d, pallas_chunked's E-step
    and gradient, and the model's routes and gradient."""
    rng = np.random.default_rng(4)
    m = dict(jd=np.logaddexp(rng.standard_normal((MB, MT, MD)), 0.0) + 0.4,
             h=rng.standard_normal((MB, MT, MD)),
             mask=(rng.random((MB, MT)) > 0.3).astype(np.float64),
             lengths=np.array([MT, 4, 2]),
             y=jax_synthetic.make_dot_data(
                 seed=2, num_seqs=MB, T=MT,
                 image_width=D_OBS).astype(np.float64))
    scans = {d: tuple(x.numpy() for x in scan_inputs(d)) for d in SCAN_DS}
    chunk_pots = _np(batched_pots(CB, CT, CD))

    def references(scans, chunk_pots, m):
        return dict(scans=_scan_references(scans),
                    chunked=_pallas_chunked_references(*chunk_pots),
                    chunk_eps=_jax_eps(CHUNK_KEY(), CB, CS, CT, CD),
                    model=_model_references(m))

    out = _np(jax.jit(references).lower(scans, chunk_pots, m).compile(
        {"xla_backend_optimization_level": 0})(scans, chunk_pots, m))
    out["chunk_pots"] = chunk_pots
    out["chunk_eps"] = _eps_t(out["chunk_eps"])
    out["model"].update(m, eps=_eps_t(out["model"]["eps"]))
    return out


@pytest.fixture(scope="module")
def model(refs):
    return refs["model"]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("par", [True, 4, 0, np.int64(4)])
def test_model_parallel_routes_match_jax(model, par, case):
    """``parallel=0`` is the sequential route, as in the JAX package, whose
    ``kalman._total_element`` treats 0 as False: the reference's own
    route. A NumPy integer is a chunk count, as there."""
    kw = dict(parallel=par)
    if case == "mask":
        kw["mask"] = torch.from_numpy(model["mask"])
    if case == "lengths":
        kw["lengths"] = torch.from_numpy(model["lengths"])
    prior, glob = (convert.natparam(_np(model[k]), **F64)
                   for k in ("prior", "glob"))
    pots = (torch.from_numpy(model["jd"]), torch.from_numpy(model["h"]))
    got = lds.run_inference(prior, glob, pots, None, MS, eps=model["eps"],
                            **kw)
    ri_r, pm_r = model["refs"][case]
    _close(got, ri_r)
    _close(lds.posterior_moments(glob, pots, **kw), pm_r)


@pytest.mark.parametrize("par", [-1, 2.5, None, np.int64(-1)])
def test_model_rejects_a_bad_parallel(model, par):
    pots = (torch.from_numpy(model["jd"]), torch.from_numpy(model["h"]))
    glob = convert.natparam(_np(model["glob"]), **F64)
    with pytest.raises(ValueError, match="parallel must be"):
        lds.posterior_moments(glob, pots, parallel=par)
    with pytest.raises(ValueError, match="parallel must be"):
        lds.run_inference(glob, glob, pots, None, MS, parallel=par)


def test_train_step_matches_jax(model):
    """One step of the chunked route: ELBO, natural gradient, net
    gradients and terms of ``make_gradfun``, and the ELBO of the
    ``make_train_step`` step."""
    rp, dp = model["nets"]
    nets = (convert.recognizer(_np(rp), **F64), convert.decoder(_np(dp),
                                                                **F64))
    parts = (functools.partial(lds.run_inference, parallel=4,
                               eps=model["eps"]),
             recognition.mlp_recognize, decoders.mlp_loglike,
             convert.natparam(_np(model["prior"]), **F64), N)
    glob = convert.natparam(_np(model["glob"]), **F64)
    y = torch.from_numpy(model["y"])
    value, natgrad, net_grads, terms = elbo.make_gradfun(
        *parts, num_samples=MS)(glob, nets, y, None)
    v_r, nat_r, grads_r, terms_r = model["grad_out"]
    _close(value, v_r)
    _close(natgrad, nat_r)
    _close(net_grads, grads_r)
    for k in terms_r:
        _close(terms[k], terms_r[k])
    init, step = loop.make_train_step(*parts, num_samples=MS)
    _, _, _, step_value, _ = step(glob, nets, init(glob, nets), y, None)
    _close(step_value, v_r)
