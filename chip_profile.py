"""Where the time goes in the PyTorch port's inference and training
paths, on one CUDA card.

    python3 chip_profile.py [--calls N] [--tables FILE]

Stages, at BASELINE config 2 (LDS-SVAE on 1-D dot videos, B=64, T=100,
d_latent=10, d_obs=20, S=2, MLP recognizer and decoder of width 64, float32,
random weights from a seed): the expected potentials, the global KL, the
E-step (``lds_estep_stationary``), ``run_inference`` (the three, plus its
finiteness check), one MC-ELBO batch (recognize, ``run_inference``,
decode; no gradient) and one SVI train step (``loop.make_train_step``: the
ELBO, its gradient through the adjoint kernels, the natural gradient and
the Adam update), also without ``run_inference``'s finiteness check, the
step's one host sync; the same step through the chunked parallel-in-time
E-step (``run_inference(parallel=8)``), and ``posterior_moments`` at
benchmarks/bench_longT.py's shape (B=8, d=10) at T=512 and 2048, chunked
(C=64) and sequential (``parallel=False``).

One run takes every reading, in this order:

1. for every stage, without the profiler, ``N`` calls back to back: the
   median CUDA-event time of a call (events recorded on the stream around
   each call), the median host time to issue a call (``perf_counter``
   around the call, no synchronize) and the wall time per call
   (``perf_counter`` over the ``N`` calls and a final synchronize, divided
   by ``N``);
2. for every stage, under ``torch.profiler`` (CPU and CUDA activities),
   ``N`` more calls: the device busy time per call (the union of the
   intervals of the device's kernels and copies), the device operations
   per call, the wall time per call and the median issue time with the
   profiler on, and the device operations that take the most time;
3. reading 1 once more, after the profiler has run: the tracing the
   profiler installs slows the host even after it stops, so only the
   readings of step 1 are clean.

The device idle share is ``1 - busy / wall`` with the wall of step 1.
``--tables`` writes the profiler's ``key_averages`` tables to a file.
There is no CPU path.
"""

import argparse
import collections
import functools
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from svae_tpu_torch.data.synthetic import (make_dot_data,
                                           make_switching_dot_data)
from svae_tpu_torch.models import lds, slds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.ops import _build, estep
from svae_tpu_torch.train import elbo, loop
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.pytree import tree_map

B, T, S, D_OBS = 64, 100, 2, 20
TOP = 8


def stages(device="cuda"):
    """The stages of the config-2 inference and training paths as
    no-argument calls."""
    prior, glob, rec, dec = chip_smoke._config2_models(device)
    data = make_dot_data(seed=0, num_seqs=B, T=T, image_width=D_OBS)
    batch = torch.from_numpy(data).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        nodes = rec(batch)
    init, mats = lds._expected_potentials(glob, torch.float32)
    parts = (lds.run_inference, recognition.mlp_recognize,
             decoders.mlp_loglike, prior, 50 * B)
    objective = elbo.make_objective(*parts, num_samples=S)
    opt_init, step = loop.make_train_step(*parts, num_samples=S)
    state = [glob, (rec, dec), opt_init(glob, (rec, dec))]

    seqs = chip_smoke.ragged_corpus()
    buckets = {b[0].shape[1]: b for b in chip_smoke._ragged_epoch(
        seqs, B, chip_smoke.RAGGED_PAD, device)}
    ropt_init, rstep = loop.make_train_step(*parts[:4], len(seqs),
                                            num_samples=1, ragged=True)
    rstate = [glob, (rec, dec), ropt_init(glob, (rec, dec))]

    def ragged_step(T):
        def run():
            rstate[0], rstate[1], rstate[2], _, _ = rstep(*rstate,
                                                          buckets[T], gen)
        return run

    def value():
        with torch.no_grad():
            return objective(glob, (rec, dec), batch, gen)

    slds_stages = slds_stage_fns(device, gen)
    chunked_stages = chunked_stage_fns(device, gen, batch)

    def train_step():
        state[0], state[1], state[2], _, _ = step(*state, batch, gen)

    def train_step_nosync():
        # the same step without run_inference's one host sync (its
        # finiteness check): what a CUDA graph of the step would drop
        check = smallchol.check_finite
        smallchol.check_finite = lambda *a: None
        try:
            train_step()
        finally:
            smallchol.check_finite = check

    return {
        "expected_potentials": lambda: lds._expected_potentials(
            glob, torch.float32),
        "prior_kl": lambda: lds.prior_kl(glob, prior),
        "estep": lambda: estep.lds_estep_stationary(init, mats, nodes, gen,
                                                    S),
        "run_inference": lambda: lds.run_inference(prior, glob, nodes, gen,
                                                   S),
        "objective": value,
        "train_step": train_step,
        "train_step_nosync": train_step_nosync,
        "ragged_train_step_T128": ragged_step(128),
        "ragged_train_step_T512": ragged_step(512),
        **slds_stages,
        **chunked_stages,
    }


def chunked_stage_fns(device, gen, batch, C=64):
    """The chunked E-step's stages as no-argument calls: a config-2 train
    step through ``run_inference(parallel=chip_smoke.CHUNKS)``, and
    ``posterior_moments`` at bench_longT's shape with ``parallel=C`` and
    ``parallel=False``."""
    prior, glob, rec, dec = chip_smoke._config2_models(device)
    run = functools.partial(lds.run_inference, parallel=chip_smoke.CHUNKS)
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior,
        50 * B, num_samples=S)
    state = [glob, (rec, dec), opt_init(glob, (rec, dec))]

    def train_step():
        state[0], state[1], state[2], _, _ = step(*state, batch, gen)

    out = {"train_step_chunked": train_step}
    for Tl in chip_smoke.LONG_T["Ts"]:
        g, pots = chip_smoke.long_t_problem(Tl)
        on = lambda x: x.float().to(device)
        g, pots = tree_map(on, g), tree_map(on, pots)
        out[f"moments_T{Tl}_C{C}"] = functools.partial(
            lds.posterior_moments, g, pots, parallel=C)
        out[f"moments_T{Tl}_sequential"] = functools.partial(
            lds.posterior_moments, g, pots)
    return out


def slds_stage_fns(device, gen):
    """The SLDS stages as no-argument calls."""
    cfg = chip_smoke.SLDS_CONFIG
    K, d, Ts, Bs = cfg["K"], cfg["d"], cfg["T"], cfg["B"]
    prior, glob, rec, dec = chip_smoke._slds_models(device, K, d,
                                                    cfg["width"],
                                                    cfg["hidden"])
    data = torch.from_numpy(make_switching_dot_data(
        0, cfg["N"], Ts, cfg["width"])).to(device)
    with torch.no_grad():
        jd, h = rec(data[:Bs])
    e_pi0, e_Pi, chain_init, E_pair = slds._expected_globals(glob,
                                                             torch.float32)
    nodes = (-0.5 * torch.diag_embed(jd), h)
    r_next = torch.full((Bs, Ts - 1, K), 1.0 / K, device=device)
    moments = slds._x_step(E_pair, chain_init, nodes, r_next)[2]

    def x_step():
        with torch.no_grad():
            return slds._x_step(E_pair, chain_init, nodes, r_next)

    def z_step():
        with torch.no_grad():
            return slds._z_step(E_pair, e_pi0, e_Pi, moments)

    ms = chip_smoke.MEASURE_SLDS
    g = torch.Generator().manual_seed(0)
    mglob = slds.init_pgm_param(ms["K"], ms["d"], g, device=device)
    mjd = (torch.logaddexp(torch.randn((ms["B"], ms["T"], ms["d"]),
                                       generator=g), torch.zeros(()))
           + 0.5).to(device)
    mh = torch.randn((ms["B"], ms["T"], ms["d"]), generator=g).to(device)

    run = functools.partial(slds.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior,
        cfg["N"], num_samples=cfg["S"], pgm_step_size=cfg["pgm_step_size"],
        net_step_size=cfg["net_step_size"])
    state = [glob, (rec, dec), opt_init(glob, (rec, dec))]

    def train_step():
        state[0], state[1], state[2], _, _ = step(*state, data[:Bs], gen)

    return {
        "slds_x_step": x_step,
        "slds_z_step": z_step,
        "slds_run_inference": lambda: slds.run_inference(
            mglob, mglob, (mjd, mh), gen, ms["S"],
            num_meanfield_iters=ms["sweeps"]),
        "slds_train_step": train_step,
    }


def plain_readings(fn, calls):
    """Reading 1: median event ms, median issue ms, wall ms per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs, issue = [], []
    t0 = time.perf_counter()
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        fn()
        issue.append(time.perf_counter() - t)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls
    return (float(np.median([s.elapsed_time(e) for s, e in pairs])),
            float(np.median(issue)) * 1e3, wall * 1e3)


def _busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def profiled_readings(fn, calls):
    """Reading 2 under torch.profiler. Returns the per-call figures, the
    top device operations and the key_averages table."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        issue = []
        t0 = time.perf_counter()
        for _ in range(calls):
            t = time.perf_counter()
            fn()
            issue.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls
    # device kernels and copies; user annotations (such as the
    # optimizer's step range) span kernels and are not device work
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.end - e.time_range.start
        count[e.name] += 1
    top = [(name[:70], us / calls, count[name] / calls)
           for name, us in by_name.most_common(TOP)]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in dev])
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    return (busy / calls / 1e3, len(dev) / calls, wall * 1e3,
            float(np.median(issue)) * 1e3, top, table)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--tables", help="write the profiler tables here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA card (this script has no "
                         "CPU path)")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    _build.build()
    _build.load_library()
    fns = stages()
    clean = {name: plain_readings(fn, args.calls)
             for name, fn in fns.items()}
    profiled = {name: profiled_readings(fn, args.calls)
                for name, fn in fns.items()}
    tables = []
    for name, fn in fns.items():
        ev, issue, wall = clean[name]
        busy, n_dev, pwall, pissue, top, table = profiled[name]
        after_ev, after_issue, after_wall = plain_readings(fn, args.calls)
        idle = 1.0 - busy / wall if busy else float("nan")
        print(f"== {name}: event {ev:.4f} ms, issue {issue:.4f} ms, wall "
              f"{wall:.4f} ms per call; device busy {busy:.4f} ms per call "
              f"in {n_dev:.1f} device ops (idle {idle:.1%} of the wall); "
              f"under the profiler wall {pwall:.4f} ms, issue "
              f"{pissue:.4f} ms; after the profiler event {after_ev:.4f} "
              f"ms, issue {after_issue:.4f} ms, wall {after_wall:.4f} ms "
              f"per call")
        for op, us, n in top:
            print(f"   {us:9.1f} us/call  {n:6.1f}x  {op}")
        tables.append(f"== {name}\n{table}\n")
    if args.tables:
        with open(args.tables, "w") as f:
            f.writelines(tables)


if __name__ == "__main__":
    main()
