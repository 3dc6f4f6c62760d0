"""The port's data-parallel layer (svae_tpu_torch/parallel/, the loader's
``sharding=``) on four gloo ranks on the CPU, in float64.

One spawn of four ranks (a ``file://`` store under the test's temporary
directory) runs, per rank: the DP train step of an LDS-SVAE (global batch
4, T=6, d=2, MLPs of width 4; the globals from the port's init, the nets
drawn with NumPy in the JAX package's layout and carried over by
svae_tpu_torch/convert.py) on the meshes (data=2, mc=1), 4 particles a
shard, where ranks 2 and 3 hold no shard, and (data=2, mc=2), S=2 particles
a shard, each shard's noise given through ``eps=`` and picked by its mesh
index; a ragged DP step with every length T; a GMM DP step and (on ranks 2
and 3, idle there) the single-process one; the loader's slices;
``assert_replicated_consistent`` with one rank perturbed; and
``make_mesh``'s shapes and errors (tests/test_parallel.py's cases scaled to
four ranks). The ranks write what they got; the tests compare it here.

The reference of both LDS steps is the JAX package's single-process
``loop.make_train_step`` on the global batch with S*M = 4 particles, its
E-step on ``backend="xla"``, its noise drawn from its key and given to the
shards: for mc=1 the shards' noise is that noise concatenated in data
order, for mc=2 the S*M particles split in mc order. ``mlp_loglike``
averages over the particles (svae_tpu/nets/decoders.py:53), and the
E-step's statistics and KLs do not depend on the noise, so the mean over mc
of the shards' objectives is that average. Tolerance rtol 1e-8 / atol 1e-10
(both sides float64; the Adam update needs no looser one,
tests/test_torch_train.py). The JAX reference is one XLA program compiled
while the ranks run (they take the noise from a file once the JAX side has
drawn it), on the JAX package's library Cholesky (tests/_jax_cholesky.py).
The JAX imports stay inside the fixture: the ranks import this module, and
they run no JAX.
"""

import concurrent.futures
import functools
import os
import time

import numpy as np
import pytest
import torch

from svae_tpu_torch import convert
from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.data.loader import make_loader
from svae_tpu_torch.models import gmm, lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.parallel import (local_batch_size, make_dp_train_step,
                                     make_mesh, multihost)
from svae_tpu_torch.train import elbo, loop
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10
W = 4                                    # ranks
B, T, d, S, D_OBS, N = 4, 6, 2, 2, 5, 40
LR, PGM_STEP = 1e-2, 0.5
MESHES = {"data2_mc1": (2, 1), "data2_mc2": (2, 2)}
M = 2                                    # the reference's S*M particles
F64 = dict(dtype=torch.float64, device="cpu")
GMM_B, GMM_K, GMM_ITERS = 8, 3, 4


def _np(tree):
    return tree_map(lambda a: a.detach().numpy().copy(), tree)


def _port_model(prob):
    return (convert.natparam(prob["prior"], **F64),
            convert.natparam(prob["glob"], **F64),
            (convert.recognizer(prob["rec"], **F64),
             convert.decoder(prob["dec"], **F64)))


def _step_out(out):
    pgm, nets, _, value, terms = out
    return dict(pgm=_np(pgm),
                nets=_np(elbo.net_parameters(nets)),
                elbo=float(value), terms={k: float(v)
                                          for k, v in terms.items()})


def _lds_dp_step(prob, mesh, eps, batch, ragged=False):
    prior, glob, nets = _port_model(prob)
    init, step = make_dp_train_step(
        functools.partial(lds.run_inference, eps=torch.from_numpy(eps)),
        recognition.mlp_recognize, decoders.mlp_loglike, prior, N, mesh, B,
        num_samples=eps.shape[0], pgm_step_size=PGM_STEP, net_step_size=LR,
        ragged=ragged)
    return _step_out(step(glob, nets, init(glob, nets), batch, None))


def _gmm_problem():
    g = torch.Generator().manual_seed(11)
    prior = gmm.init_pgm_param(GMM_K, 2, g, **F64)
    glob = gmm.init_pgm_param(GMM_K, 2, g, random_scale=2.0, **F64)
    nets = (recognition.init_mlp_recognize(2, (8,), 2, g, **F64),
            decoders.init_mlp_decode(2, (8,), 2, g, **F64))
    y = torch.randn(GMM_B, 2, generator=g, **F64)
    eps = torch.randn(S, GMM_B, 2, generator=g, **F64)
    return prior, glob, nets, y, eps


def _gmm_step(mesh=None):
    """One GMM step: data-parallel over ``mesh`` (this rank's slice), or
    single-process on the whole batch."""
    prior, glob, nets, y, eps = _gmm_problem()
    rows = slice(None)
    if mesh is not None:
        bl = local_batch_size(GMM_B, mesh)
        rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
    run = functools.partial(gmm.run_inference, eps=eps[:, rows],
                            num_meanfield_iters=GMM_ITERS)
    parts = (run, recognition.mlp_recognize, decoders.mlp_loglike, prior,
             4 * GMM_B)
    kw = dict(num_samples=S, pgm_step_size=PGM_STEP, net_step_size=LR)
    if mesh is None:
        init, step = loop.make_train_step(*parts, **kw)
    else:
        init, step = make_dp_train_step(*parts, mesh, GMM_B, **kw)
    return _step_out(step(glob, nets, init(glob, nets), y[rows], None))


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _wait_for(path, timeout_secs=120):
    deadline = time.monotonic() + timeout_secs
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout_secs}s")
        time.sleep(0.05)
    return np.load(path)


def _rank_main(rank, store, out, prob, eps_path):
    torch.set_num_threads(1)
    multihost.initialize(init_method=f"file://{store}", world_size=W,
                         rank=rank, device="cpu", timeout_secs=120)
    res = {}
    m22 = make_mesh(data=2, mc=2)
    res["mesh"] = dict(
        shape=m22.shape, index=(m22.data_index, m22.mc_index),
        default=make_mesh().shape, mc2=make_mesh(mc=2).shape,
        local=local_batch_size(8, m22),
        bad_batch=_raises(lambda: local_batch_size(7, m22)),
        too_big=_raises(lambda: make_mesh(data=8, mc=1)),
        indivisible=_raises(lambda: make_mesh(mc=3)))

    # the loader's slices: dense and ragged, by data index
    res["loader"] = {kind: list(make_loader(corpus, 4, seed=3, prefetch=0,
                                            sharding=m22, **kw)(1))
                     for kind, (corpus, kw) in _corpora().items()}

    # replicated-state check: equal, then rank 1 perturbed
    m41 = make_mesh(data=4)
    _, glob, _ = _port_model(prob)
    res["consistent"] = multihost.assert_replicated_consistent(glob, m41)
    if rank == 1:
        glob = tree_map(lambda a: a + 1e-3, glob)
    try:
        multihost.assert_replicated_consistent(glob, m41)
        res["perturbed"] = None
    except AssertionError as e:
        res["perturbed"] = str(e)

    m21 = make_mesh(data=2, mc=1)
    if m21.on_mesh:
        res["gmm"] = _gmm_step(m21)
    else:   # idle on the 2x1 mesh: the single-process GMM step
        res["gmm_single"] = _gmm_step()

    y, eps_all = prob["y"], _wait_for(eps_path)
    for name, mesh in (("data2_mc1", m21), ("data2_mc2", m22)):
        if not mesh.on_mesh:
            res[name] = None
            continue
        D, mc = mesh.shape["data"], mesh.shape["mc"]
        bl, s = B // D, S * M // mc
        rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
        eps = eps_all[mesh.mc_index * s:(mesh.mc_index + 1) * s, rows]
        res[name] = _lds_dp_step(prob, mesh, eps, torch.from_numpy(y[rows]))
        if mc == 1:
            lengths = torch.full((bl,), T, dtype=torch.int64)
            res["ragged"] = _lds_dp_step(
                prob, mesh, eps, (torch.from_numpy(y[rows]), lengths),
                ragged=True)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _corpora():
    """A dense corpus and a ragged one for the loader's slices."""
    return dict(
        dense=(np.arange(10 * 3, dtype=np.float64).reshape(10, 3), {}),
        ragged=([np.full((t, 2), t, np.float64)
                 for t in (3, 9, 5, 7, 4, 8, 6, 2)],
                dict(drop_remainder=True)))


def _gaussian_mlp(rng, sizes):
    """A Gaussian MLP's parameters in the JAX package's layout, (hidden
    [(W, b), ...], ((W, b), (W, b)) of the head), drawn with NumPy."""
    dense = lambda m, n: (rng.standard_normal((m, n)) / np.sqrt(m),
                          0.1 * rng.standard_normal(n))
    return ([dense(m, n) for m, n in zip(sizes[:-2], sizes[1:-1])],
            (dense(*sizes[-2:]), dense(*sizes[-2:])))


def _problem():
    """Parameters and data (NumPy, no JAX): the globals from the port's
    init, the nets in the JAX layout."""
    g = torch.Generator().manual_seed(19)
    rng = np.random.default_rng(19)
    return dict(
        prior=_np(lds.init_pgm_param(d, g, **F64)),
        glob=_np(lds.init_pgm_param(d, g, **F64)),
        rec=_gaussian_mlp(rng, (D_OBS, 4, d)),
        dec=_gaussian_mlp(rng, (d, 4, D_OBS)),
        y=make_dot_data(seed=4, num_seqs=B, T=T,
                        image_width=D_OBS).astype(np.float64))


def _jax_reference(prob, eps_path):
    """The JAX package's single-process train step on the global batch
    with S*M particles, its noise drawn from its key; the noise, as the
    xla route draws it, is written to ``eps_path`` for the ranks first.
    One small XLA program for the noise, one for the step."""
    import jax
    import jax.numpy as jnp
    from svae_tpu.models import lds as jax_lds
    from svae_tpu.nets import decoders as jax_decoders
    from svae_tpu.nets import recognition as jax_recognition
    from svae_tpu.train import loop as jax_loop

    key = jax.random.key(23)

    def noise():
        # the xla route's draw: one key a sequence, (S*M, T, d) each
        return jnp.stack([jax.random.normal(kb, (S * M, T, d), jnp.float64)
                          for kb in jax.random.split(key, B)], 1)

    np.save(eps_path + ".tmp.npy", np.asarray(jax.jit(noise)()))
    os.replace(eps_path + ".tmp.npy", eps_path)

    def reference(prob):
        init, step = jax_loop.make_train_step(
            functools.partial(jax_lds.run_inference, backend="xla"),
            jax_recognition.mlp_recognize, jax_decoders.mlp_loglike,
            prob["prior"], N, num_samples=S * M, pgm_step_size=PGM_STEP,
            net_step_size=LR, donate=False)
        nets = (prob["rec"], prob["dec"])
        return step(prob["glob"], nets, init(prob["glob"], nets), prob["y"],
                    key)

    return jax.tree.map(np.asarray, jax.jit(reference).lower(prob).compile(
        {"xla_backend_optimization_level": 0})(prob))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests._jax_cholesky import library_cholesky

    tmp = tmp_path_factory.mktemp("dp")
    prob = _problem()
    eps_path = str(tmp / "eps.npy")
    # the ranks start first and take the noise from the file once the JAX
    # side has drawn it; the JAX reference compiles while they run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(multihost.spawn_local, _rank_main, W,
                            (str(tmp / "store"), str(tmp), prob, eps_path),
                            240)
        with library_cholesky():
            ref = _jax_reference(prob, eps_path)
        ranks.result()
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(W)]
    return ref, got


def _close(port, ref):
    port, ref = tree_leaves(port), tree_leaves(ref)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def _flat(out):
    """One step's outputs (``_step_out``) as a list of leaves."""
    return ([out["elbo"]] + tree_leaves(out["pgm"]) + tree_leaves(out["nets"])
            + [out["terms"][k] for k in sorted(out["terms"])])


def _jax_leaves(tree):
    import jax
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("name", list(MESHES))
def test_dp_step_matches_jax(runs, name):
    """ELBO, terms and the updated globals and nets of one DP step on every
    rank of the mesh, against the JAX package's single-process step on the
    global batch; ranks beyond the mesh hold no shard."""
    ref, got = runs
    pgm_r, nets_r, _, value_r, terms_r = ref
    for rank, res in enumerate(got):
        if rank >= np.prod(MESHES[name]):
            assert res[name] is None
            continue
        out = res[name]
        _close(out["elbo"], value_r)
        _close(out["pgm"], _jax_leaves(pgm_r))
        _close(out["nets"], _jax_leaves(nets_r))
        assert sorted(out["terms"]) == sorted(terms_r)
        for k in terms_r:
            _close(out["terms"][k], terms_r[k])


def test_dp_identities_on_four_ranks(runs):
    """A ragged DP step with every length T equals the dense one; a GMM DP
    step equals the port's single-process GMM step; the loader's slices
    are the single-process batches split by data index; a perturbed rank
    makes the consistency check raise on every rank; make_mesh's shapes
    and errors."""
    _, got = runs
    gmm_ref = got[2]["gmm_single"]
    for rank, res in enumerate(got[:2]):
        _close(_flat(res["ragged"]), _flat(res["data2_mc1"]))
        _close(_flat(res["gmm"]), _flat(gmm_ref))

    whole = {kind: list(make_loader(corpus, 4, seed=3, prefetch=0, **kw)(1))
             for kind, (corpus, kw) in _corpora().items()}
    for kind, batches in whole.items():
        assert len(batches) == 2
        for i, batch in enumerate(batches):
            # mesh (2, 2): rank r has data index r % 2; mc peers agree
            for a, b in zip(tree_leaves(got[0]["loader"][kind][i]),
                            tree_leaves(got[2]["loader"][kind][i])):
                np.testing.assert_array_equal(a, b)
            halves = [got[r]["loader"][kind][i] for r in (0, 1)]
            for leaf, h0, h1 in zip(tree_leaves(batch), tree_leaves(halves[0]),
                                    tree_leaves(halves[1])):
                np.testing.assert_array_equal(np.concatenate([h0, h1]), leaf)

    for rank, res in enumerate(got):
        assert res["consistent"] == 0.0
        assert "diverged across 'data' shards" in res["perturbed"]
        m = res["mesh"]
        assert m["shape"] == {"mc": 2, "data": 2}
        assert m["index"] == (rank % 2, rank // 2)
        assert m["default"] == {"mc": 1, "data": 4}
        assert m["mc2"] == {"mc": 2, "data": 2}
        assert m["local"] == 4
        assert "not divisible by data-parallel degree 2" in m["bad_batch"]
        assert "needs 8 devices, have 4" in m["too_big"]
        assert "not divisible by mc=3" in m["indivisible"]
