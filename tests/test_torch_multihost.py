"""The port's multi-process layer (svae_tpu_torch/parallel/multihost.py) on
the CPU: ``param_fingerprint`` against the JAX package's on the same
parameters (float32 sums, rtol 1e-6); ``initialize`` raising when one of
two ranks never comes, forming a one-rank group, and returning ``False``
once a group exists; and a two-rank ``experiment.run`` on the DP step
(gloo, a ``file://`` store, each rank its own checkpoint directory),
stopped after one epoch and resumed, equal to the uninterrupted two-epoch
run on both ranks, with the replicas equal at the end.

The two-rank run is spawned when the module starts and joined by its
test, so that it runs beside the other two; its ranks import this module
and no JAX (the JAX imports stay inside the test that needs them).
"""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from svae_tpu_torch import convert
from svae_tpu_torch.config import TrainConfig
from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.parallel import make_dp_train_step, make_mesh, multihost
from svae_tpu_torch.train import elbo, experiment
from svae_tpu_torch.utils.pytree import tree_leaves

from tests.test_torch_dp import _gaussian_mlp

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
RESUME = dict(W=2, B=4, T=6, d=2, D_OBS=5, local_seqs=8)


def _resume_model(seed_data):
    c = RESUME
    g = torch.Generator().manual_seed(3)
    prior = lds.init_pgm_param(c["d"], g, **F64)
    glob = lds.init_pgm_param(c["d"], g, **F64)
    nets = (recognition.init_mlp_recognize(c["D_OBS"], (4,), c["d"], g,
                                           **F64),
            decoders.init_mlp_decode(c["d"], (4,), c["D_OBS"], g, **F64))
    data = torch.from_numpy(make_dot_data(
        seed=seed_data, num_seqs=c["local_seqs"], T=c["T"],
        image_width=c["D_OBS"]).astype(np.float64))
    return prior, glob, nets, data


def _resume_rank(rank, store, out):
    """Two epochs uninterrupted, then one epoch with a checkpoint and a
    resume to two, through ``experiment.run`` on the DP step over a
    (data=2) mesh; each rank holds its data index's corpus."""
    torch.set_num_threads(1)
    c = RESUME
    multihost.initialize(init_method=f"file://{store}", world_size=c["W"],
                         rank=rank, device="cpu", timeout_secs=120)
    mesh = make_mesh(data=c["W"])
    B_local = c["B"] // c["W"]
    tc = TrainConfig(num_epochs=2, batch_size=B_local, seed=5,
                     net_step_size=1e-2,
                     checkpoint_every=c["local_seqs"] // B_local)
    res = {}

    def run(tc):
        prior, glob, nets, data = _resume_model(seed_data=mesh.data_index)
        init, step = make_dp_train_step(
            lds.run_inference, recognition.mlp_recognize,
            decoders.mlp_loglike, prior, c["W"] * c["local_seqs"], mesh,
            c["B"], num_samples=2, net_step_size=tc.net_step_size)
        return experiment.run(tc, step, glob, nets, init(glob, nets), data)

    pgm, nets, _, res["full"] = run(tc)
    res["full_params"] = [a.detach().numpy().copy() for a in tree_leaves(
        (pgm, elbo.net_parameters(nets)))]
    ckdir = os.path.join(out, f"ck_rank{rank}")
    _, _, _, res["first"] = run(dataclasses.replace(
        tc, num_epochs=1, checkpoint_dir=ckdir))
    pgm, nets, _, res["rest"] = run(dataclasses.replace(
        tc, checkpoint_dir=ckdir))
    res["resumed_params"] = [a.detach().numpy().copy() for a in tree_leaves(
        (pgm, elbo.net_parameters(nets)))]
    res["consistent"] = multihost.assert_replicated_consistent(
        (pgm, nets), mesh)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module", autouse=True)
def resume_ranks(tmp_path_factory):
    """The two-rank resume run, started with the module."""
    tmp = tmp_path_factory.mktemp("multihost")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield tmp, pool.submit(multihost.spawn_local, _resume_rank,
                               RESUME["W"], (str(tmp / "store"), str(tmp)),
                               240)


def test_param_fingerprint_matches_jax():
    """The port's fingerprint of (globals, nets) against the JAX package's
    on the same parameters; a perturbed copy moves it."""
    import jax
    from svae_tpu.parallel import multihost as jax_multihost

    rng = np.random.default_rng(7)
    g = torch.Generator().manual_seed(7)
    glob = tree_leaves(lds.init_pgm_param(3, g, **F64))
    glob = tuple(a.numpy() for a in glob)
    rec, dec = _gaussian_mlp(rng, (5, 4, 3)), _gaussian_mlp(rng, (3, 4, 5))
    port = (convert.natparam(glob, device="cpu"),
            (convert.recognizer(rec, device="cpu"),
             convert.decoder(dec, device="cpu")))
    want = np.asarray(jax.jit(jax_multihost.param_fingerprint)(
        (glob, (rec, dec))))
    got = multihost.param_fingerprint(port)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    moved = multihost.param_fingerprint(
        (tuple(a + 1e-3 for a in port[0]), port[1]))
    assert float((moved - got).abs().max()) > 0


def test_initialize_timeout_and_reinit(tmp_path, monkeypatch):
    """One of two ranks never comes: ``RuntimeError`` naming the fix. No
    torchrun environment and no init_method: ``ValueError``. Then a
    one-rank group forms (``True``), and a second call returns
    ``False``."""
    with pytest.raises(RuntimeError, match=r"not all 2 processes joined"
                       r"(.|\n)*resume from the latest checkpoint"):
        multihost.initialize(init_method=f"file://{tmp_path / 'store'}",
                             world_size=2, rank=0, device="cpu",
                             timeout_secs=1)
    assert not dist.is_initialized()
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun's environment"):
        multihost.initialize(device="cpu")
    try:
        assert multihost.initialize(world_size=1, device="cpu") is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert multihost.initialize(world_size=1, device="cpu") is False
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_rank_experiment_resume(resume_ranks):
    """Stopped after epoch 1 and resumed: the same ELBO history and final
    parameters as the uninterrupted run, on both ranks, bitwise; the
    replicas equal; ranks with different data indices trained on
    different corpora but hold the same parameters."""
    tmp, ranks = resume_ranks
    ranks.result()
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
           for r in range(RESUME["W"])]
    steps = 2 * RESUME["local_seqs"] // (RESUME["B"] // RESUME["W"])
    for res in got:
        assert len(res["full"]) == steps and np.isfinite(res["full"]).all()
        assert res["first"] + res["rest"] == res["full"]
        for a, b in zip(res["resumed_params"], res["full_params"]):
            np.testing.assert_array_equal(a, b)
        assert res["consistent"] == 0.0
    assert got[0]["full"] == got[1]["full"]
    for a, b in zip(got[0]["full_params"], got[1]["full_params"]):
        np.testing.assert_array_equal(a, b)
