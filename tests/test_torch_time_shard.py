"""The port's time-sharded smoother (svae_tpu_torch/parallel/time_shard.py)
on four gloo ranks on the CPU, in float64, against the JAX package's
``kalman.lds_smoother`` on the same chain at rtol 1e-8 / atol 1e-10.

One spawn of four ranks (a ``file://`` store under the test's temporary
directory) runs both shapes: (T, d) = (16, 3), two sequences on shared
pairs, and (40, 2), one sequence on its own pairs; then the two
``ValueError``s (T not divisible by the group's size; fewer than two rows
a rank). The chains are made with NumPy from a seed (a stable random LDS,
node potentials of random positive definite precisions). The JAX
references (one XLA program, a sequence at a time, as the JAX smoother
takes one) compile while the ranks run; the JAX imports stay inside the
fixture, since the ranks import this module.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from svae_tpu_torch.parallel import multihost
from svae_tpu_torch.parallel.time_shard import lds_smoother_timeshard

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
W = 4
CASES = {"T16_d3": dict(B=2, T=16, d=3, shared=True, seed=0),
         "T40_d2": dict(B=1, T=40, d=2, shared=False, seed=1)}


def _spd(rng, *lead, d):
    X = rng.standard_normal(lead + (d, d))
    return X @ np.swapaxes(X, -1, -2) + d * np.eye(d)


def _chain(B, T, d, shared, seed):
    """``(init, pairs, nodes)`` in natural parameters, NumPy float64:
    pairs shared (T-1, ...) or per sequence (B, T-1, ...)."""
    rng = np.random.default_rng(seed)
    init = (-0.5 * _spd(rng, d=d), rng.standard_normal(d), np.array(0.3))
    lead = (T - 1,) if shared else (B, T - 1)
    A = rng.standard_normal(lead + (d, d))
    A *= 0.8 / np.linalg.norm(A, 2, axis=(-2, -1), keepdims=True)
    Qi = np.linalg.inv(_spd(rng, *lead, d=d))
    At = np.swapaxes(A, -1, -2)
    pairs = (-0.5 * Qi, Qi @ A, -0.5 * At @ Qi @ A, np.full(lead, 0.1))
    nodes = (-0.5 * _spd(rng, B, T, d=d), rng.standard_normal((B, T, d)))
    return init, pairs, nodes


def _torch(tree):
    return tuple(_torch(x) if isinstance(x, tuple) else torch.from_numpy(x)
                 for x in tree)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank_main(rank, store, out):
    torch.set_num_threads(1)
    multihost.initialize(init_method=f"file://{store}", world_size=W,
                         rank=rank, device="cpu", timeout_secs=120)
    res = {}
    for name, case in CASES.items():
        got = lds_smoother_timeshard(*_torch(_chain(**case)))
        res[name] = [a.numpy() for a in got]
    small = lambda T: _torch(_chain(B=1, T=T, d=2, shared=True, seed=2))
    res["indivisible"] = _raises(lambda: lds_smoother_timeshard(*small(18)))
    res["too_short"] = _raises(lambda: lds_smoother_timeshard(*small(4)))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _jax_references():
    """The JAX package's ``kalman.lds_smoother``, one sequence at a time,
    every case in one XLA program."""
    import jax
    from svae_tpu.ops import kalman as jax_kalman

    chains = {name: _chain(**case) for name, case in CASES.items()}

    def references(chains):
        out = {}
        for name, (init, pairs, nodes) in chains.items():
            seqs = []
            for b in range(CASES[name]["B"]):
                pb = pairs if CASES[name]["shared"] else tuple(
                    p[b] for p in pairs)
                seqs.append(jax_kalman.lds_smoother(
                    init, pb, tuple(n[b] for n in nodes)))
            out[name] = [jax.numpy.stack(x) for x in zip(*seqs)]
        return out

    return jax.tree.map(np.asarray, jax.jit(references).lower(chains).compile(
        {"xla_backend_optimization_level": 0})(chains))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests._jax_cholesky import library_cholesky

    tmp = tmp_path_factory.mktemp("time_shard")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(multihost.spawn_local, _rank_main, W,
                            (str(tmp / "store"), str(tmp)), 240)
        with library_cholesky():
            refs = _jax_references()
        ranks.result()
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(W)]
    return refs, got


@pytest.mark.parametrize("name", list(CASES))
def test_timeshard_matches_jax(runs, name):
    """(logZ, Ex, ExxT, Exnxt) on every rank against the JAX smoother."""
    refs, got = runs
    for res in got:
        assert len(res[name]) == len(refs[name]) == 4
        for a, r in zip(res[name], refs[name]):
            assert a.shape == r.shape
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


def test_timeshard_rejects_bad_lengths(runs):
    """T not divisible by the group's size, and fewer than two rows a rank
    (rank 0 holds the pad row), raise on every rank."""
    _, got = runs
    for res in got:
        assert res["indivisible"] == "T=18 not divisible by time-axis size 4"
        assert res["too_short"] == ("need T >= 2*4 (device 0 holds the pad "
                                    "row)")
