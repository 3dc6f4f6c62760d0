"""The port's experiment layer (svae_tpu_torch/train/experiment.py and
``loop.run(steps_per_dispatch=)``), with the semantics of the JAX
package's tests/test_train.py: a preempted and resumed ``run`` and
``run_with_loader`` reproduce the uninterrupted trajectories bit for bit
on the CPU, ``checkpoint_cast`` reaches the restore, the JSONL records
come at the JAX package's cadence with grouped steps, and the trajectory
of ``loop.run`` does not depend on ``steps_per_dispatch``. No JAX."""

import json

import numpy as np
import pytest
import torch

from svae_tpu_torch.config import TrainConfig
from svae_tpu_torch.data import loader
from svae_tpu_torch.data.synthetic import make_pinwheel
from svae_tpu_torch.models import gmm, lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import checkpoint as ckpt_lib
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


def _gmm(K=6, d=2, d_obs=2, seed=0, S=1):
    """tests/test_train.py's GMM problem: pinwheel N=80, 20 sweeps."""
    g = torch.Generator().manual_seed(seed)
    prior = gmm.init_pgm_param(K, d, g, **F64)
    glob = gmm.init_pgm_param(K, d, g, random_scale=2.0, **F64)
    nets = (recognition.init_mlp_recognize(d_obs, (20,), d, g, **F64),
            decoders.init_mlp_decode(d, (20,), d_obs, g, **F64))
    data = torch.from_numpy(make_pinwheel(num_per_class=16)).double()

    def run_inf(prior, glob, pots, generator, S):
        return gmm.run_inference(prior, glob, pots, generator, S,
                                 num_meanfield_iters=20)

    opt_init, step = loop_lib.make_train_step(
        run_inf, recognition.mlp_recognize, decoders.mlp_loglike, prior,
        data.shape[0], num_samples=S)
    return glob, nets, opt_init, step, data


def _fresh(glob, nets, opt_init):
    """Copies of the initial state, so that each run starts from it (the
    nets are updated in place)."""
    import copy
    nets = tuple(copy.deepcopy(n) for n in nets)
    return glob, nets, opt_init(glob, nets)


def test_preemption_resume_continues_trajectory(tmp_path):
    """Kill a checkpointed run at an epoch boundary, resume through
    experiment.run, and the resumed trajectory equals the uninterrupted
    run's exactly (parameters and the generator's noise stream);
    checkpoint_every == steps-per-epoch puts the checkpoint on the
    boundary."""
    glob, nets, opt_init, step, data = _gmm()

    def cfg(num_epochs, ckdir):
        return TrainConfig(num_epochs=num_epochs, batch_size=40,
                           checkpoint_dir=ckdir, checkpoint_every=2, seed=3)

    _, _, _, hist_full = experiment.run(
        cfg(4, str(tmp_path / "full")), step, *_fresh(glob, nets, opt_init),
        data)
    ckdir = str(tmp_path / "pre")
    _, _, _, hist_a = experiment.run(cfg(2, ckdir), step,
                                     *_fresh(glob, nets, opt_init), data)
    assert ckpt_lib.latest(ckdir).endswith("ckpt_4.npz")
    # a fresh state (other weights would do too): the restore overrides it
    _, _, _, hist_b = experiment.run(cfg(4, ckdir), step,
                                     *_fresh(glob, nets, opt_init), data)
    assert len(hist_a) == 4 and len(hist_b) == 4
    assert hist_a + hist_b == hist_full
    assert ckpt_lib.latest(ckdir).endswith("ckpt_8.npz")


def _ragged(seed=0):
    """tests/test_train.py's ragged LDS problem: 12 sequences of lengths
    4-9, d=2, batches of 4 padded to multiples of 4."""
    d, d_obs = 2, 4
    rng = np.random.RandomState(0)
    seqs = [rng.randn(rng.randint(4, 10), d_obs) for _ in range(12)]
    g = torch.Generator().manual_seed(9)
    prior = lds.init_pgm_param(d, g, **F64)
    glob = lds.init_pgm_param(d, g, **F64)
    nets = (recognition.init_mlp_recognize(d_obs, (8,), d, g, **F64),
            decoders.init_mlp_decode(d, (8,), d_obs, g, **F64))
    opt_init, step = loop_lib.make_train_step(
        lds.run_inference, recognition.mlp_recognize, decoders.mlp_loglike,
        prior, len(seqs), num_samples=1, ragged=True)
    get_np = loader.make_loader(seqs, 4, seed=5, pad_multiple=4, prefetch=0)

    def get_batches(epoch):
        for frames, lengths in get_np(epoch):
            yield torch.from_numpy(frames), torch.from_numpy(lengths)

    return glob, nets, opt_init, step, get_batches


def test_loader_runner_resume_continues_trajectory(tmp_path):
    """run_with_loader: epoch-granular checkpoint / resume on a ragged
    length-bucketed corpus reproduces the uninterrupted trajectory exactly,
    with the JSONL metrics numbered by global step."""
    glob, nets, opt_init, step, get_batches = _ragged()

    def cfg(num_epochs, ckdir, metrics=None):
        return TrainConfig(num_epochs=num_epochs, batch_size=4,
                           checkpoint_dir=ckdir, seed=3,
                           metrics_path=metrics)

    mpath = str(tmp_path / "m.jsonl")
    _, _, _, hist_full = experiment.run_with_loader(
        cfg(4, str(tmp_path / "full"), mpath), step,
        *_fresh(glob, nets, opt_init), get_batches, device="cpu")
    lines = [json.loads(l) for l in open(mpath)]
    assert len(lines) == len(hist_full)
    assert all(np.isfinite(l["elbo"]) for l in lines)
    assert [l["step"] for l in lines] == list(range(len(hist_full)))

    ckdir = str(tmp_path / "pre")
    _, _, _, hist_a = experiment.run_with_loader(
        cfg(2, ckdir), step, *_fresh(glob, nets, opt_init), get_batches,
        device="cpu")
    assert ckpt_lib.latest(ckdir, prefix="ckpt_epoch_").endswith(
        "ckpt_epoch_2.npz")
    _, _, _, hist_b = experiment.run_with_loader(
        cfg(4, ckdir), step, *_fresh(glob, nets, opt_init), get_batches,
        device="cpu")
    assert hist_a + hist_b == hist_full


def test_experiment_checkpoint_cast_plumbed(tmp_path):
    """TrainConfig.checkpoint_cast reaches checkpoint.restore through the
    experiment's restore, so a precision-migrated checkpoint is
    recoverable."""
    path = str(tmp_path / "c.npz")
    ckpt_lib.save(path, ({"w": np.zeros((2,), np.float64)},
                         np.asarray(3, np.int64)))
    f32_head = ({"w": torch.zeros(2)},)
    with pytest.raises(ValueError, match="dtype"):
        experiment._restore_with_counters(path, f32_head, 1)
    out = experiment._restore_with_counters(path, f32_head, 1, cast=True)
    assert out[0]["w"].dtype == torch.float32
    assert int(out[1]) == 3
    # an int32 counter (the JAX package's older checkpoints) restores too
    ckpt_lib.save(path, ({"w": np.zeros((2,), np.float32)},
                         np.asarray(4, np.int32)))
    assert int(experiment._restore_with_counters(path, f32_head, 1)[1]) == 4


@pytest.mark.parametrize("every, k, fired", [
    (1, 2, [1, 3, 4, 6, 8, 9]),
    (3, 2, [3, 6, 8, 9]),
    (3, 1, [2, 5, 8, 9]),
])
def test_metrics_records_and_cadence(tmp_path, every, k, fired):
    """5 batches an epoch, 2 epochs: with steps_per_dispatch=k the records
    come at the ends of groups of k in which a multiple of metrics_every
    fell (an epoch's trailing partial group step by step) and at the last
    step, as the JAX package's grouped dispatches fire them; each record
    holds the step, the time, the ELBO, the per-step time and rate, and
    the ELBO's terms."""
    glob, nets, opt_init, step, data = _gmm()
    mpath = str(tmp_path / "m.jsonl")
    # one case also runs the profiler and the NaN guard
    instrumented = (every, k) == (1, 2)
    cfg = TrainConfig(num_epochs=2, batch_size=16, seed=1,
                      metrics_every=every, steps_per_dispatch=k,
                      metrics_path=mpath, debug_nans=instrumented,
                      profile_dir=(str(tmp_path / "prof") if instrumented
                                   else None))
    _, _, _, hist = experiment.run(cfg, step, *_fresh(glob, nets, opt_init),
                                   data)
    assert len(hist) == 10
    lines = [json.loads(l) for l in open(mpath)]
    assert [l["step"] for l in lines] == fired
    assert set(lines[0]) == {"step", "time", "elbo", "step_time_s",
                             "steps_per_sec", "loglike", "local_kl",
                             "global_kl", "net_grad_norm"}
    for l in lines:
        assert l["elbo"] == hist[l["step"]]
        assert l["step_time_s"] > 0 and l["steps_per_sec"] > 0
    assert (tmp_path / "prof" / "trace.json").exists() == instrumented
    assert not torch.is_anomaly_enabled()


def test_loop_steps_per_dispatch_matches_per_step():
    """loop.run(steps_per_dispatch=k) runs the same trajectory for every k
    (the same batches and noise; a trailing partial group when k does not
    divide the steps of an epoch), and fires the callback at group ends."""
    glob, nets, opt_init, step, data = _gmm(S=2)
    outs = {}
    for k in (1, 2, 3, 5):
        calls = []
        pgm, nets_k, _, hist, gen = loop_lib.run(
            step, *_fresh(glob, nets, opt_init), data,
            torch.Generator().manual_seed(3), num_epochs=2, batch_size=16,
            callback=lambda i, e, *_: calls.append(i), callback_every=1,
            steps_per_dispatch=k)
        outs[k] = (hist, pgm, nets_k, gen.get_state(), calls)
    hist1, pgm1, nets1, gen1, _ = outs[1]
    assert len(hist1) == 10 and all(np.isfinite(hist1))
    for k, (hist, pgm, nets_k, gen, calls) in outs.items():
        assert hist == hist1, k
        assert torch.equal(gen, gen1)
        for a, b in zip(loop_lib.tree_leaves(pgm), loop_lib.tree_leaves(pgm1)):
            assert torch.equal(a, b)
        for m, m1 in zip(nets_k, nets1):
            for a, b in zip(m.parameters(), m1.parameters()):
                assert torch.equal(a, b)
    assert outs[2][4] == [1, 3, 4, 6, 8, 9]
    assert outs[3][4] == [2, 3, 4, 7, 8, 9]
    assert outs[5][4] == [4, 9]
