"""Parity of the port's parallel-in-time HMM scans (svae_tpu_torch/ops/hmm.py:
``_logmatmul``, ``hmm_logZ``, ``hmm_marginals``, ``hmm_posterior``,
``hmm_viterbi``, ``hmm_sample`` at ``parallel=True``) with the JAX
package's (svae_tpu/ops/hmm.py), in float64 on the CPU.

The JAX side is one XLA program compiled once in a module fixture: its
batched ``hmm_logZ`` and ``hmm_marginals``, and its per-sequence
``hmm_posterior``, ``hmm_viterbi`` and ``hmm_sample`` ``vmap``ped over the
batch, each at ``parallel=True``, with a stationary (K, K) and a
time-varying (B, T-1, K, K) transition matrix; ``hmm_sample`` draws from
one key a sequence and the port is given those Gumbel draws. A sharpened
problem (observations down to -200) holds the gradient of
``hmm_logZ(parallel=True)`` to JAX's custom VJP. The sequential flavors
(``parallel=False``) are held to the parallel ones in the port. Values
agree at rtol 1e-8 / atol 1e-10; paths are equal. B=3, T=7, K=3. Four
tests, so that xdist's ``--dist loadfile`` runs the file beside
tests/test_time_shard.py instead of ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.ops import hmm as jax_hmm

from svae_tpu_torch.ops import hmm, hmm_fb
from svae_tpu_torch.utils.pytree import tree_leaves

torch.set_num_threads(1)
B, T, K, S = 3, 7, 3, 2
TOL = dict(rtol=1e-8, atol=1e-10)


def _close(port, ref, tol=TOL):
    port_leaves, ref_leaves = tree_leaves(port), jax.tree.leaves(ref)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(torch.as_tensor(p).detach().numpy(),
                                   np.asarray(r), **tol)


def _problem(seed, sharp=False):
    """(log_init, stationary log_trans, time-varying log_trans, log_obs,
    pair_weights) as NumPy float64. ``sharp`` sharpens the messages: half
    the observations between -200 and -100, and every switch of state at
    -1000, so that products of the shifted exponentials underflow in
    float64 (as they do in float32 some 900 nats sooner)."""
    rng = np.random.default_rng(seed)
    lsm = lambda x: x - np.log(np.exp(x).sum(-1, keepdims=True))
    li = lsm(rng.standard_normal(K))
    lt = lsm(rng.standard_normal((K, K)))
    lt_tv = lsm(rng.standard_normal((B, T - 1, K, K)))
    lo = 3.0 * rng.standard_normal((B, T, K))
    if sharp:
        lt = np.where(np.eye(K) > 0, 0.0, -1000.0)
        lo = np.where(rng.random((B, T, K)) < 0.5,
                      -100.0 - 100.0 * rng.random((B, T, K)), lo)
    w = (np.arange(1, T)[None] < np.array([T, 4, 2])[:, None]).astype(
        np.float64)
    return li, lt, lt_tv, lo, w


def _gumbel(key):
    k0, k1 = jax.random.split(key)
    return (jax.random.gumbel(k0, (S, K), jnp.float64),
            jax.random.gumbel(k1, (T - 1, S, K), jnp.float64))


@pytest.fixture(scope="module")
def ref():
    li, lt, lt_tv, lo, w = _problem(0)
    sli, slt, _, slo, _ = _problem(1, sharp=True)
    key = jax.random.key(5)

    def references(li, lt, lt_tv, lo, w, sli, slt, slo):
        keys = jax.random.split(key, B)
        per_seq = lambda f: jax.vmap(f, in_axes=(None, None, 0))
        per_seq_tv = lambda f: jax.vmap(f, in_axes=(None, 0, 0))
        out = {}
        for tag, trans, vm in (("stat", lt, per_seq),
                               ("tv", lt_tv, per_seq_tv)):
            out[tag] = dict(
                logZ=jax_hmm.hmm_logZ(li, trans, lo, parallel=True),
                marg=jax_hmm.hmm_marginals(li, trans, lo, parallel=True),
                post=vm(lambda a, b, c: jax_hmm.hmm_posterior(
                    a, b, c, parallel=True))(li, trans, lo),
                viterbi=vm(lambda a, b, c: jax_hmm.hmm_viterbi(
                    a, b, c, parallel=True))(li, trans, lo),
                sample=jax.vmap(
                    lambda b, c, k: jax_hmm.hmm_sample(
                        li, b, c, k, S, parallel=True),
                    in_axes=(0 if tag == "tv" else None, 0, 0))(
                        trans, lo, keys))
        out["tv"]["post_w"] = jax.vmap(
            lambda b, c, ww: jax_hmm.hmm_posterior(
                li, b, c, parallel=True, pair_weights=ww))(lt_tv, lo, w)
        out["gumbel"] = jax.vmap(_gumbel)(keys)
        f = lambda a, b, c: jnp.sum(jax_hmm.hmm_logZ(a, b, c, parallel=True))
        out["sharp"] = jax.value_and_grad(f, argnums=(0, 1, 2))(sli, slt,
                                                                slo)
        return out

    args = (li, lt, lt_tv, lo, w, sli, slt, slo)
    out = jax.jit(references).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    t = lambda x: torch.from_numpy(x)
    return dict(jax=out, li=t(li), lt=t(lt), lt_tv=t(lt_tv), lo=t(lo),
                w=t(w), sharp=(t(sli), t(slt), t(slo)))


def test_logZ_marginals_and_posterior_match_jax(ref):
    """hmm_logZ and hmm_marginals at parallel=True against JAX's, with a
    stationary and a time-varying transition matrix; the sequential flavor
    against the parallel one; the stationary case's pair marginals are the
    summed (K, K) counts. hmm_posterior at parallel=True (and at a chunk
    count, which takes the same scans) against JAX's vmapped one, with
    pair_weights for the time-varying case; parallel=False (the kernels'
    route, their plain versions here) against it too, and only that
    route calls the kernels' plain versions."""
    for tag, trans in (("stat", ref["lt"]), ("tv", ref["lt_tv"])):
        args = (ref["li"], trans, ref["lo"])
        want = ref["jax"][tag]
        _close(hmm.hmm_logZ(*args, parallel=True), want["logZ"])
        marg = hmm.hmm_marginals(*args, parallel=True)
        _close(marg, want["marg"])
        assert marg[2].shape == trans.shape
        _close(hmm.hmm_logZ(*args), want["logZ"])
        _close(hmm.hmm_marginals(*args), want["marg"])
        for parallel in (True, 4, False):
            hmm_fb.hmm_fb_fwd_plain.calls = 0
            _close(hmm.hmm_posterior(*args, parallel=parallel),
                   want["post"])
            assert hmm_fb.hmm_fb_fwd_plain.calls == int(not parallel)
        if tag == "tv":
            for parallel in (True, False):
                _close(hmm.hmm_posterior(*args, parallel=parallel,
                                         pair_weights=ref["w"]),
                       want["post_w"])


def test_viterbi_and_sample_match_jax(ref):
    """The parallel Viterbi paths and scores equal JAX's; the parallel
    sampler draws JAX's paths under its Gumbel draws; both flavors of each
    give the same paths; stationary and time-varying transitions."""
    g = tuple(torch.from_numpy(np.array(x)) for x in ref["jax"]["gumbel"])
    for tag, trans in (("stat", ref["lt"]), ("tv", ref["lt_tv"])):
        args = (ref["li"], trans, ref["lo"])
        want = ref["jax"][tag]
        for parallel in (True, False):
            path, score = hmm.hmm_viterbi(*args, parallel=parallel)
            assert path.dtype == torch.int32
            np.testing.assert_array_equal(path.numpy(),
                                          np.asarray(want["viterbi"][0]))
            _close(score, want["viterbi"][1])
            paths = hmm.hmm_sample(*args, None, S, parallel=parallel,
                                   gumbel_noise=g)
            np.testing.assert_array_equal(paths.numpy(),
                                          np.asarray(want["sample"]))


def _plain_logmatmul(A, B):
    """log(exp(A - rowmax) @ exp(B - colmax)) + shifts, differentiated by
    autograd."""
    Ma, Mb = A.amax(-1, keepdim=True), B.amax(-2, keepdim=True)
    return torch.log(torch.exp(A - Ma) @ torch.exp(B - Mb)) + Ma + Mb


def test_sharp_gradient_is_the_bounded_backward(ref, monkeypatch):
    """On sharpened messages (observations down to -200) some products
    underflow: hmm_logZ(parallel=True)'s gradient is finite and matches
    JAX's custom VJP, while autograd through a plain log-matmul gives a
    non-finite one, so the bounded backward made it."""
    ins = [x.clone().requires_grad_() for x in ref["sharp"]]
    logZ = hmm.hmm_logZ(*ins, parallel=True).sum()
    grads = torch.autograd.grad(logZ, ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    want_logZ, want_grads = ref["jax"]["sharp"]
    _close((logZ, grads), (want_logZ, want_grads))

    monkeypatch.setattr(hmm, "_logmatmul", _plain_logmatmul)
    ins = [x.clone().requires_grad_() for x in ref["sharp"]]
    plain = torch.autograd.grad(hmm.hmm_logZ(*ins, parallel=True).sum(), ins)
    assert not all(bool(torch.isfinite(p).all()) for p in plain)


def test_logmatmul_matches_jax_and_has_second_derivatives():
    """_logmatmul against the JAX package's on a batch with an all -inf
    row, its backward against JAX's custom VJP, and a second derivative
    through hmm_marginals' internal gradient against the sequential
    flavor's (autograd of its logsumexp loop twice)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, K, K)) * 4.0
    Bm = rng.standard_normal((2, K, K)) * 4.0
    A[0, 1] = -np.inf
    ct = rng.standard_normal((2, K, K))
    C, vjp = jax.vjp(jax_hmm._logmatmul, A, Bm)
    a, b = (torch.from_numpy(x).requires_grad_() for x in (A, Bm))
    out = hmm._logmatmul(a, b)
    grads = torch.autograd.grad(out, (a, b), torch.from_numpy(ct))
    _close(out, C)
    np.testing.assert_array_equal(np.isfinite(out.detach().numpy()),
                                  np.isfinite(np.asarray(C)))
    _close(grads, vjp(ct))

    li, lt, _, lo, _ = (torch.from_numpy(x) for x in _problem(7))
    weights = torch.arange(B * T * K, dtype=lo.dtype).reshape(B, T, K)

    def second(parallel):
        x = lo.clone().requires_grad_()
        node = hmm.hmm_marginals(li, lt, x, parallel=parallel)[1]
        return torch.autograd.grad((node * weights).sum(), x)

    _close(second(True), second(False))
