"""Experiment runner: wires a ``TrainConfig`` into the loops with JSONL
metrics, checkpoint / resume, profiling and the NaN guard (port of
svae_tpu/train/experiment.py, with its semantics).

The JAX package's PRNG key becomes one ``torch.Generator`` seeded with
``TrainConfig.seed`` on the data's device (on ``device`` for
:func:`run_with_loader`); a checkpoint holds its state advanced past the
checkpointed step, so a resumed run continues the noise stream.
"""

import contextlib
import os
import time

import numpy as np
import torch

from svae_tpu_torch.train import checkpoint as ckpt_lib
from svae_tpu_torch.train import loop as loop_lib
from svae_tpu_torch.train.metrics import MetricsWriter


def _restore_with_counters(path, head_state, n_counters, cast=False):
    """Restore ``head_state + (counter,) * n_counters`` trying int64 then
    int32 counter templates: the dtype check is strict, and the JAX
    package's checkpoints written before it pinned its counters to int64
    stored them in whichever width its x64 mode gave. ``cast``
    (TrainConfig.checkpoint_cast) forwards to checkpoint.restore's opt-in
    lossy dtype coercion."""
    for ctype in (np.int64, np.int32):
        state = head_state + tuple(
            np.zeros((), ctype) for _ in range(n_counters))
        try:
            return ckpt_lib.restore(path, state, cast=cast)
        except ValueError as e:
            if "dtype mismatch" not in str(e) or ctype is np.int32:
                raise
    raise AssertionError("unreachable")


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


@contextlib.contextmanager
def _instruments(train_cfg):
    """``debug_nans`` turns on autograd's anomaly detection (a backward
    that makes a NaN raises, naming the forward op) for the run;
    ``profile_dir`` runs ``torch.profiler`` over it and writes a Chrome
    trace there, ``trace.json``."""
    with contextlib.ExitStack() as stack:
        if train_cfg.debug_nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        prof = None
        if train_cfg.profile_dir:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(train_cfg.profile_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(profile(activities=acts))
        yield
    if prof is not None:
        prof.export_chrome_trace(
            os.path.join(train_cfg.profile_dir, "trace.json"))


def _make_callback(writer, last_fired, step_base, extra_callback,
                   on_fire=None):
    """The loops' callback: a JSONL record of the ELBO, the terms and the
    time per step since the previous firing, then ``on_fire`` and
    ``extra_callback``."""
    t_last = [time.perf_counter()]

    def callback(step, elbo, params, terms=None, generator=None):
        now = time.perf_counter()
        dt = now - t_last[0]
        t_last[0] = now
        global_step = step_base[0] + step
        extra = ({k: float(v) for k, v in terms.items()}
                 if terms is not None else {})
        # true steps since the previous firing: with steps_per_dispatch > 1
        # the cadence rounds to group boundaries, so dividing by
        # metrics_every would overstate the step time by the group factor
        n_steps = max(global_step - last_fired[0], 1)
        last_fired[0] = global_step
        per_step = dt / n_steps
        writer.write(global_step, elbo=elbo, step_time_s=round(per_step, 5),
                     steps_per_sec=round(1.0 / max(per_step, 1e-9), 3),
                     **extra)
        if on_fire is not None:
            on_fire(global_step, params, generator)
        if extra_callback is not None:
            extra_callback(global_step, elbo, params, terms)

    return callback


def run(train_cfg, train_step, pgm_params, net_params, opt_state, data,
        extra_callback=None):
    """Run the training loop per ``TrainConfig``; returns
    ``(pgm_params, net_params, opt_state, history)``.

    Resumes from the latest checkpoint in ``checkpoint_dir`` if present.
    Checkpoint state = (pgm, net, opt, generator, step), the generator
    ADVANCED past the checkpointed step, so a resumed run continues the
    noise stream instead of replaying it. Resume granularity is the epoch:
    completed epochs (step // steps_per_epoch) are skipped, so a checkpoint
    taken at an epoch boundary (``checkpoint_every`` divisible by
    steps-per-epoch) resumes with the exact batch and noise sequence of the
    uninterrupted run. A mid-epoch checkpoint resumes from the enclosing
    epoch's start with the advanced generator: a coherent fresh stream, not
    a replay. Checkpoints are written when a ``checkpoint_every`` boundary
    was crossed since the previous firing, and at the end.

    Metrics are appended as JSONL every ``metrics_every`` steps; between
    firings the loop makes no host sync of its own.
    """
    generator = _generator(train_cfg.seed, data.device)
    start_step = 0
    if train_cfg.checkpoint_dir:
        os.makedirs(train_cfg.checkpoint_dir, exist_ok=True)
        latest = ckpt_lib.latest(train_cfg.checkpoint_dir)
        if latest is not None:
            pgm_params, net_params, opt_state, generator, step_arr = (
                _restore_with_counters(
                    latest, (pgm_params, net_params, opt_state, generator),
                    1, cast=train_cfg.checkpoint_cast))
            start_step = int(step_arr)

    num_batches = max(data.shape[0] // train_cfg.batch_size, 1)
    epochs_done = min(start_step // num_batches, train_cfg.num_epochs)
    start_step = epochs_done * num_batches  # epoch-granular resume
    epochs_left = train_cfg.num_epochs - epochs_done

    every_ckpt = max(train_cfg.checkpoint_every, 1)
    last_ckpt = [start_step // every_ckpt]

    def checkpoint(global_step, params, gen):
        # checkpoint when a cadence boundary was CROSSED since the last
        # firing (exact-multiple equality never holds when the boundary
        # falls inside a group)
        ckpt_idx = (global_step + 1) // every_ckpt
        if train_cfg.checkpoint_dir and ckpt_idx > last_ckpt[0]:
            last_ckpt[0] = ckpt_idx
            ckpt_lib.save(
                os.path.join(train_cfg.checkpoint_dir,
                             f"ckpt_{global_step + 1}.npz"),
                tuple(params) + (gen, np.asarray(global_step + 1, np.int64)))

    writer = MetricsWriter(train_cfg.metrics_path)
    callback = _make_callback(writer, [start_step - 1], [start_step],
                              extra_callback, on_fire=checkpoint)
    history = []
    try:
        with _instruments(train_cfg):
            if epochs_left > 0:
                (pgm_params, net_params, opt_state, history,
                 generator) = loop_lib.run(
                    train_step, pgm_params, net_params, opt_state, data,
                    generator, num_epochs=epochs_left,
                    batch_size=train_cfg.batch_size, callback=callback,
                    callback_every=max(int(train_cfg.metrics_every), 1),
                    steps_per_dispatch=train_cfg.steps_per_dispatch)
    finally:
        writer.close()

    if train_cfg.checkpoint_dir:
        final_step = start_step + len(history)
        ckpt_lib.save(
            os.path.join(train_cfg.checkpoint_dir, f"ckpt_{final_step}.npz"),
            (pgm_params, net_params, opt_state, generator,
             np.asarray(final_step, np.int64)))
    return pgm_params, net_params, opt_state, history


def run_with_loader(train_cfg, train_step, pgm_params, net_params,
                    opt_state, get_batches, extra_callback=None,
                    device="cuda"):
    """Loader-driven variant of :func:`run` for ragged corpora
    (``get_batches(epoch)`` from ``data.loader.make_loader``; pair with
    ``make_train_step(ragged=True)`` for ``(frames, lengths)`` batches).

    Same JSONL metrics cadence as :func:`run`, and the same
    ``TrainConfig.steps_per_dispatch`` cadence (pair with
    ``make_loader(group_by_shape=True)`` so buckets emit consecutively and
    groups fill). Checkpoints are EPOCH-granular (the per-epoch step count
    varies with bucketing): state = (pgm, net, opt, generator, epochs_done,
    steps_done) written at every epoch end as ``ckpt_epoch_{e}.npz``;
    resume skips completed epochs, continues the advanced generator's
    noise stream and the global metrics step numbering. The generator lives
    on ``device`` (default ``"cuda"``; pass the loader's device, ``"cpu"``
    to run on the CPU). Returns (pgm_params, net_params, opt_state,
    history).
    """
    generator = _generator(train_cfg.seed, device)
    epochs_done = 0
    steps_done = 0
    if train_cfg.checkpoint_dir:
        os.makedirs(train_cfg.checkpoint_dir, exist_ok=True)
        latest = ckpt_lib.latest(train_cfg.checkpoint_dir,
                                 prefix="ckpt_epoch_")
        if latest is not None:
            pgm_params, net_params, opt_state, generator, ep_arr, st_arr = (
                _restore_with_counters(
                    latest, (pgm_params, net_params, opt_state, generator),
                    2, cast=train_cfg.checkpoint_cast))
            epochs_done = min(int(ep_arr), train_cfg.num_epochs)
            steps_done = int(st_arr)

    writer = MetricsWriter(train_cfg.metrics_path)
    step_base = [steps_done]
    callback = _make_callback(writer, [steps_done - 1], step_base,
                              extra_callback)
    history = []
    try:
        with _instruments(train_cfg):
            for epoch in range(epochs_done, train_cfg.num_epochs):
                (pgm_params, net_params, opt_state, h,
                 generator) = loop_lib.run_loader(
                    train_step, pgm_params, net_params, opt_state,
                    lambda _e, ep=epoch: get_batches(ep), generator,
                    num_epochs=1, callback=callback,
                    callback_every=max(int(train_cfg.metrics_every), 1),
                    steps_per_dispatch=train_cfg.steps_per_dispatch)
                history.extend(h)
                step_base[0] += len(h)
                if train_cfg.checkpoint_dir:
                    ckpt_lib.save(
                        os.path.join(train_cfg.checkpoint_dir,
                                     f"ckpt_epoch_{epoch + 1}.npz"),
                        (pgm_params, net_params, opt_state, generator,
                         np.asarray(epoch + 1, np.int64),
                         np.asarray(step_base[0], np.int64)))
    finally:
        writer.close()
    return pgm_params, net_params, opt_state, history
