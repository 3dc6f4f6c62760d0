"""Parity of the port's HMM forward-backward (svae_tpu_torch/ops/hmm_fb.py)
and Viterbi decode (ops/hmm.py) with the JAX package, in float64 on the
CPU unless a test says otherwise.

* The forward twins and plain adjoints of the four kernels are held to the
  Pallas kernels ``pallas_hmm._hmm_fb_kernel``, ``_hmm_fb_stat_kernel``,
  ``_hmm_fb_adj_kernel`` and ``_hmm_fb_stat_adj_kernel``, called directly
  in interpret mode (U=1) on the same packed inputs and random cotangents,
  at rtol 1e-9 / atol 1e-11 (the tier of tests/test_pallas_hmm.py).
* ``hmm_posterior``'s values and gradients, for both kernel choices and
  for time-varying transitions with pair weights, are held to
  ``pallas_hmm.hmm_posterior(interpret=True)`` at the same tier (values)
  and rtol 1e-8 / atol 1e-10 (gradients, test_pallas_hmm.py's).
* The two hazards of test_pallas_hmm.py: sharp messages (float32) and a
  forced near-forbidden switch, whose pair count must stay finite.
* ``hmm_viterbi`` against the vmapped ``svae_tpu.ops.hmm.hmm_viterbi``:
  the same paths and scores, exactly.

Every JAX reference is computed once, under one ``jax.jit``, in a module
fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.ops import hmm as jax_hmm
from svae_tpu.ops import pallas_hmm

from svae_tpu_torch.ops import hmm, hmm_fb

torch.set_num_threads(1)
RTOL, ATOL = 1e-9, 1e-11
GRAD_TOL = dict(rtol=1e-8, atol=1e-10)
B, T, K = 3, 7, 3
T1 = T - 1
BLOCK = 8


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), rtol=rtol, atol=atol)


def _problem(seed, time_varying=False):
    """log_init (K,), log_trans ((K, K), or (B, T-1, K, K) with uniform
    rows at the pad transitions of lengths (7, 4, 2)), log_obs (B, T, K)
    and the pair weights (None for (K, K) transitions), in NumPy."""
    rng = np.random.default_rng(seed)
    lsm = lambda x: x - np.logaddexp.reduce(x, axis=-1, keepdims=True)
    li = lsm(rng.standard_normal(K))
    lo = 2.0 * rng.standard_normal((B, T, K))
    if not time_varying:
        return li, lsm(rng.standard_normal((K, K))), lo, None
    w = (np.arange(1, T)[None] < np.array([7, 4, 2])[:, None]).astype(float)
    lt = (w[..., None, None] * lsm(rng.standard_normal((B, T1, K, K)))
          + (1.0 - w[..., None, None]) * -np.log(K))
    lo[:, 1:] *= w[..., None]
    return li, lt, lo, w


def _loss(out):
    """test_pallas_hmm.py's mixed loss over the four outputs."""
    logZ, node, pair, r1 = out
    lib = torch if isinstance(logZ, torch.Tensor) else jnp
    return (logZ.sum() + lib.sin(node).sum() + (pair ** 2).sum()
            + lib.cos(r1).sum())


CASES = {"streamed": (0, False), "stationary": (0, False),
         "time_varying": (1, True)}


def _sharp():
    """Near-deterministic transitions and sharp evidence, float32."""
    rng = np.random.default_rng(2)
    return (np.log(np.full(K, 1.0 / K, np.float32)),
            np.log(0.999 * np.eye(K) + 1e-3).astype(np.float32),
            (40.0 * rng.standard_normal((2, 12, K))).astype(np.float32))


def _forced():
    """A near-forbidden switch (log-probability -100) that the
    observations force (K=2)."""
    lt = np.log([[0.999, 0.001], [0.001, 0.999]])
    lt[0, 1] = -100.0
    return (np.log([0.999, 0.001]), lt,
            np.array([[50.0, -50.0]] * 3 + [[-50.0, 50.0]] * 3)[None])


def _viterbi_problem():
    li, lt, lo, _ = _problem(4)
    return li, lt, np.concatenate([lo, np.zeros((1, T, K))])


def _xla_posterior(li, lt, lo):
    return jax.vmap(lambda o: jax_hmm.hmm_posterior(li, lt, o))(lo)


@pytest.fixture(scope="module")
def refs():
    """The kernels' packed inputs (from the port's twins, with random
    cotangents), the Pallas kernels' outputs on them, and the JAX
    package's posteriors and gradients for every case."""
    rng = np.random.default_rng(5)
    li, lt, lo = (_t(a) for a in _problem(2)[:3])
    a0 = (li + lo[:, 0]).T.contiguous()
    streamed = (a0, hmm_fb._pack(lt + lo[:, 1:, None, :]))
    stationary = (a0, lt, hmm_fb._pack(lo[:, 1:]))
    al, be = hmm_fb.hmm_fb_fwd_plain(*streamed)
    dal, dbe = (_t(rng.standard_normal(x.shape)) for x in (al, be))
    # the Pallas adjoints read alpha_t and beta_{t+1} as shifted streams
    ap = torch.cat([a0[None], al[:-1]])
    bn = torch.cat([be[1:], torch.zeros_like(be[:1])])
    LTb = lt.reshape(K * K, 1).expand(K * K, B)
    j = lambda *xs: tuple(jnp.asarray(x.numpy()) for x in xs)
    kw = dict(K=K, U=1, interpret=True)

    problems = {name: _problem(seed, tv)
                for name, (seed, tv) in CASES.items()}

    def references(streamed, stationary, adj, stat_adj, problems):
        out = dict(fwd=pallas_hmm._fb_call(*streamed, **kw),
                   stat_fwd=pallas_hmm._fb_stat_call(*stationary, **kw),
                   adj=pallas_hmm._fb_adj_call(*adj, **kw),
                   stat_adj=pallas_hmm._fb_stat_adj_call(*stat_adj, **kw))
        for name, (li, lt, lo, w) in problems.items():
            kernel = "streamed" if name == "time_varying" else name
            post = lambda li, lt, lo: pallas_hmm.hmm_posterior(
                li, lt, lo, block_b=BLOCK, interpret=True, pair_weights=w,
                kernel=kernel)
            # one trace of the posterior gives its values and, pulled
            # back along the loss's gradient in them, the inputs' gradients
            vals, pull = jax.vjp(post, li, lt, lo)
            out["post_" + name] = (vals, pull(jax.grad(_loss)(vals)))
        out["sharp"] = _xla_posterior(*_sharp())
        out["forced"] = _xla_posterior(*_forced())
        li, lt, lo = _viterbi_problem()
        out["viterbi"] = jax.vmap(lambda o: jax_hmm.hmm_viterbi(li, lt, o))(
            jnp.asarray(lo))
        return out

    # without XLA's backend optimizations, which change no float64 value
    args = (j(*streamed), j(a0, LTb, stationary[2]),
            j(streamed[1], ap, al, dal, be, bn, dbe),
            j(LTb, stationary[2], ap, al, dal, be, bn, dbe), problems)
    out = jax.jit(references).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    return dict(streamed=streamed, stationary=stationary, outs=(al, be),
                cots=(dal, dbe), problems=problems, **out)


# --------------------------------------------------------------------------
# the twins and plain adjoints against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["streamed", "stationary"])
def test_forward_twin_matches_pallas_kernel(refs, kernel):
    twin = (hmm_fb.hmm_fb_fwd_plain if kernel == "streamed"
            else hmm_fb.hmm_fb_stat_fwd_plain)
    _close(twin(*refs[kernel]),
           refs["fwd" if kernel == "streamed" else "stat_fwd"])


@pytest.mark.parametrize("kernel", ["streamed", "stationary"])
def test_plain_adjoint_matches_pallas_kernel(refs, kernel):
    """The plain adjoints (autograd of the twins) against the Pallas
    adjoints, whose per-direction (and, stationary, per-lane) outputs are
    summed as the CUDA wrappers sum their kernels'."""
    args = (*refs[kernel], *refs["outs"], *refs["cots"])
    if kernel == "streamed":
        dMf, dMb, da0 = refs["adj"]
        _close(hmm_fb.hmm_fb_adj_plain(*args), (da0, dMf + dMb))
    else:
        dloa, dlod, da0, dLT = refs["stat_adj"]
        _close(hmm_fb.hmm_fb_stat_adj_plain(*args),
               (da0, dLT.sum(-1).reshape(K, K), dloa + dlod))


@pytest.mark.parametrize("kernel", ["streamed", "stationary"])
def test_functions_backward_matches_twin_autograd(refs, kernel):
    """HmmFb / HmmFbStat wire the adjoints onto the forward's inputs: on
    the CPU their backward runs the plain adjoint, and their gradients
    equal torch's autograd of the twin."""
    apply, twin = ((hmm_fb.HmmFb.apply, hmm_fb.hmm_fb_fwd_plain)
                   if kernel == "streamed" else
                   (hmm_fb.HmmFbStat.apply, hmm_fb.hmm_fb_stat_fwd_plain))
    grads = []
    for f in (apply, twin):
        ins = tuple(x.detach().clone().requires_grad_()
                    for x in refs[kernel])
        out = f(*ins)
        loss = sum((o * c).sum() for o, c in zip(out, refs["cots"]))
        grads.append(torch.autograd.grad(loss, ins))
    _close(grads[0], [g.numpy() for g in grads[1]])


def _meta(shape, dt=torch.float32):
    return torch.empty(shape, dtype=dt, device="meta")


def _kernel_args(kernel, k=K, dt=torch.float32):
    vec = (T1, k, B)
    first = ([(k, B), (T1, k * k, B)] if "stat" not in kernel
             else [(k, B), (k, k), vec])
    rest = [vec] * 4 if kernel.endswith("adj") else []
    return [_meta(s, dt) for s in first + rest]


@pytest.mark.parametrize("kernel", ["hmm_fb_fwd", "hmm_fb_adj",
                                    "hmm_fb_stat_fwd", "hmm_fb_stat_adj"])
def test_wrappers_reject_what_the_kernels_do_not_take(kernel):
    """Off the CPU a wrapper launches its kernel or raises; on tensors that
    are neither CPU nor CUDA (``meta``) its checks run without a card: the
    shapes, K >= 1, the type, contiguity and the device."""
    wrapper = getattr(hmm_fb, kernel)
    bad = _kernel_args(kernel)
    bad[-1] = _meta((1, 2))
    with pytest.raises(ValueError, match="inconsistent shapes"):
        wrapper(*bad)
    with pytest.raises(ValueError, match=r"K=0; the kernels take K >= 1"):
        wrapper(*_kernel_args(kernel, k=0))
    with pytest.raises(TypeError, match="float32"):
        wrapper(*_kernel_args(kernel, dt=torch.float64))
    strided = _kernel_args(kernel)
    strided[0] = strided[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*strided)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*_kernel_args(kernel))
    assert wrapper.launches == 0


# --------------------------------------------------------------------------
# hmm_posterior against the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_hmm_posterior_matches_pallas(refs, case):
    """Values (logZ, node marginals, weighted pair sum, init marginal) and
    the gradients of a mixed loss of all four with respect to all three
    inputs."""
    kernel = "streamed" if case == "time_varying" else case
    li, lt, lo, w = refs["problems"][case]
    ins = [_t(x).requires_grad_() for x in (li, lt, lo)]
    out = hmm_fb.hmm_posterior(*ins, pair_weights=None if w is None
                               else _t(w), kernel=kernel)
    grads = torch.autograd.grad(_loss(out), ins)
    ref_out, ref_grads = refs["post_" + case]
    _close(out, ref_out)
    _close(grads, ref_grads, **GRAD_TOL)


def test_sharp_messages_stable(refs):
    """Near-deterministic transitions and sharp evidence, in float32 (the
    regime where the log-of-sums derivative NaNs): values and gradients
    stay finite and the node marginals match the JAX package's float32
    scan path at test_pallas_hmm.py's tier."""
    li, lt, lo = _sharp()
    lo_t = _t(lo).requires_grad_()
    out = hmm_fb.hmm_posterior(_t(li), _t(lt), lo_t)
    val = out[0].sum() + (out[1] ** 2).sum()
    (g,) = torch.autograd.grad(val, [lo_t])
    assert bool(torch.isfinite(val)) and bool(torch.isfinite(g).all())
    np.testing.assert_allclose(out[1].detach().numpy(),
                               np.asarray(refs["sharp"][1]), rtol=2e-5,
                               atol=2e-6)


def test_forced_switch_pair_sum_finite(refs):
    """A near-forbidden transition (log-probability -100) forced by the
    observations gives a finite pair count of about one, equal to the JAX
    package's scan path: the materialized pair marginal keeps every
    exponent bounded."""
    out = hmm_fb.hmm_posterior(*(_t(x) for x in _forced()))
    for a, b in zip(out, refs["forced"]):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    assert 0.9 < float(out[2][0, 0, 1]) < 1.1


def test_hmm_posterior_rejects_what_it_cannot_run():
    li, lt, lo = (_t(a) for a in _problem(3)[:3])
    ltv = lt.expand(B, T1, K, K)
    with pytest.raises(ValueError, match="stationary"):
        hmm_fb.hmm_posterior(li, ltv, lo, kernel="stationary")
    with pytest.raises(ValueError, match="kernel"):
        hmm_fb.hmm_posterior(li, lt, lo, kernel="bogus")
    with pytest.raises(ValueError, match="T >= 2"):
        hmm_fb.hmm_posterior(li, lt, lo[:, :1])


# --------------------------------------------------------------------------
# the Viterbi decode
# --------------------------------------------------------------------------


def test_viterbi_matches_jax(refs):
    """Paths and scores of a batch, exactly: the max-plus recursion runs
    the same additions in the same order, and ties go to the lowest
    state in both (a chain without evidence included)."""
    path, score = hmm.hmm_viterbi(*(_t(x) for x in _viterbi_problem()))
    ref_path, ref_score = refs["viterbi"]
    assert path.dtype == torch.int32
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref_path))
    np.testing.assert_array_equal(score.numpy(), np.asarray(ref_score))
