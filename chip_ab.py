"""Time the port's config-2 stages in two or more checkouts of the repo
side by side on one CUDA card, so that versions are compared within one
run on one card.

    python3 chip_ab.py DIR [DIR ...] [--calls N] [--rounds R]

Each DIR is the root of a checkout, for example the parent commit unpacked
with ``git archive`` into a directory that .gitignore lists. Each runs in
a process of its own that imports ``svae_tpu_torch`` from that DIR, builds
its kernels and takes, for every stage, the median CUDA-event time and the
median host time to issue a call (``perf_counter`` around the call, no
synchronize) over ``N`` calls after 3 warm-ups. The checkouts run in the
order given and then in reverse (A B B A), ``R`` times over, so that a
drift of the host during the run falls on each alike.

Stages, at BASELINE config 2 (B=64, T=100, d_latent=10, d_obs=20, S=2, MLP
recognizer and decoder of width 64, float32, random weights from a seed):
the E-step (``lds_estep_stationary``), ``run_inference``,
``posterior_moments``, one MC-ELBO batch under ``torch.no_grad``, the two
stationary forward kernels alone (``estep.filter_fwd`` on the E-step's
packed inputs, ``estep.sampler_fwd`` on its forward messages and noise
drawn from one seed), the two stationary adjoint kernels alone
(``estep.filter_adj`` and ``estep.sampler_adj`` on the forward kernels'
outputs and cotangents drawn from one seed) where the checkout has them;
the element scan alone (``chunked.elem_scan`` at the config-2 fold: B=64,
T=100 in C=8 chunks, 512 lanes of 13 steps; at the long-T fold: B=8,
T=2048 in C=64 chunks, 512 lanes of 32 steps; and at the config-2 chunk
totals' shape: 64 lanes of 8 steps) and its adjoint alone
(``chunked.elem_scan_adj`` at the config-2 fold) and the
bidirectional filter's (``bpairs.bidir_adj`` at a ragged B=64, T=512
batch, at the slds_synth x-step's 32 lanes of T=80, d=4, and over one
direction's 8 lanes of T=2048); the bidirectional filter alone
(``bpairs.bidir_fwd`` at ragged B=64 batches of T=128 and T=512, at the
slds_synth x-step's lanes and over one direction's lanes of T=2048) and
the per-sequence sampler and its adjoint alone (``bpairs.sampler_bp_fwd``
and ``bpairs.sampler_bp_adj`` at T=128 and T=512, S=1, and at the
slds_synth shape, B=16, S=2); the four HMM kernels alone
(``hmm_fb.hmm_fb_fwd``, ``hmm_fb_adj``, ``hmm_fb_stat_fwd`` and
``hmm_fb_stat_adj`` at the slds_synth z-step's shape, B=16, T=80, K=4,
and at bench.py measure_hmm's, B=128, T=100, K=8, the adjoints on the
plain forward's messages and cotangents drawn from one seed); the two
shared-pair filters alone (``kalman_fwd.filter_shared`` and
``backward_shared`` at chip_smoke.py's KFWD_SHAPES config-2 width and B=8,
T=2048, and at config-2 width at the other built latent sizes) and
``bpairs.bidir_fwd`` over the B forward and the B backward lanes of the
same chains (``bidir_fwd_shared_*``); all on float32 copies of
chip_smoke.py's float64 problems, where the checkout has them; an empty
kernel (``torch.cuda._sleep(0)``), the floor under any launch's device
time; and, where the checkout has the training loop, one
train step
(``make_train_step``), one chunked config-2 train step
(``run_inference(parallel=8)``), one ragged train step at the T=512
bucket of ``benchmarks/ragged_throughput.py``'s corpus (S=1) and one
slds_synth train step (chip_smoke.py's SLDS_CONFIG).
Prints one line per run, then for every stage and checkout the median
and quartiles of the event times and of the issue times and, against the
first checkout, how many of the A B / B A pairs each side was faster in
(by event time); for the kernel stages alone (DEVICE_STAGES) the same by
their device time under torch.profiler (every kernel of the call
summed), taken after the event times; and last a JSON object of every
reading. ``--stages P [P ...]`` times only the stages whose names start
with one of the prefixes P. There is no CPU path.
"""

import argparse
import copy
import functools
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

B, T, S, D, D_OBS = 64, 100, 2, 10, 20
# the stages whose device time is taken too
DEVICE_STAGES = ("bidir_fwd", "sampler_bp_fwd", "sampler_bp_adj", "bidir_adj",
                 "elem_scan", "hmm_fb", "filter_shared", "backward_shared",
                 "empty_kernel")


def _median_ms(fn, calls):
    import numpy as np
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs, issue = [], []
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
    return (float(np.median([s.elapsed_time(e) for s, e in pairs])),
            float(np.median(issue)) * 1e3)


def _kernel_stages(torch, estep, init, mats, nodes):
    """The two stationary forward kernels alone and, where the checkout
    has them, the two adjoint kernels alone, on the forward kernels'
    outputs at config 2 and noise and cotangents drawn from one seed: the
    same inputs in every checkout whose forward kernels agree."""
    dev = nodes[0].device
    fin = estep.filter_inputs(init, mats, nodes)
    J, h, ln = estep.filter_fwd(*fin)
    g = torch.Generator(device=dev).manual_seed(5)
    cot = lambda x: torch.randn(x.shape, generator=g, device=dev)
    filt = (*fin, J, h, cot(J), cot(h), cot(ln))
    Jf = torch.cat([fin[0][None, :, :B], J[:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], h[:, :, :B]])
    eps = torch.randn((S, B, T, D), generator=g, device=dev)
    samp, _ = estep.sampler_inputs(mats, Jf, hf, eps)
    x = estep.sampler_fwd(*samp)
    stages = {"filter_fwd": lambda: estep.filter_fwd(*fin),
              "sampler_fwd": lambda: estep.sampler_fwd(*samp)}
    if hasattr(estep, "filter_adj"):
        adj = (*samp, x, cot(x))
        stages.update({"filter_adj": lambda: estep.filter_adj(*filt),
                       "sampler_adj": lambda: estep.sampler_adj(*adj)})
    return stages


def _scan_bidir_adj_stages(torch, dev):
    """The element scan and its adjoint, the bidirectional filter and its
    adjoint, and the per-sequence sampler and its adjoint alone, on
    float32 copies of the checkout's chip_smoke.py problems (seeded, the
    same in every checkout whose problem functions agree)."""
    import chip_smoke
    from svae_tpu_torch.models import lds
    from svae_tpu_torch.ops import bpairs, chunked
    f32 = lambda xs: tuple(x.float().contiguous() for x in xs)
    leaves = chip_smoke.elem_problem(dict(B=B, T=T, d=D, C=8), 0, dev)
    pref = chunked.elem_scan_plain(leaves)
    g = torch.Generator(device=dev).manual_seed(3)
    douts = torch.randn(pref.shape, generator=g, dtype=pref.dtype,
                        device=dev)
    stages = {"elem_scan_adj": functools.partial(
        chunked.elem_scan_adj, *f32((leaves, pref, douts)))}
    for name, shape in (("config2", dict(B=B, T=T, d=D, C=8)),
                        ("longT", dict(B=8, T=2048, d=D, C=64)),
                        ("totals", dict(B=B, T=9, d=D, C=1))):
        stages[f"elem_scan_{name}"] = functools.partial(
            chunked.elem_scan, *f32((chip_smoke.elem_problem(shape, 0,
                                                             dev),)))
    for name, shape in (("T512", dict(B=B, T=512, d=D, S=1)),
                        ("slds", dict(B=16, T=80, d=4, S=2))):
        filt = chip_smoke.bpairs_problem(shape, 0, dev)[0]
        stages[f"bidir_adj_{name}"] = functools.partial(bpairs.bidir_adj,
                                                        *f32(filt))
    # one direction's B lanes: the forward filter's, as bpairs.lds_filter
    # runs them
    init, mats, nodes, _ = chip_smoke._problem(dict(B=8, T=2048, d=D, S=1),
                                               0, dev)
    pairs, bnodes = lds._chain(mats, nodes)
    fin = bpairs._packed(*bpairs._initial(init, bnodes),
                         bpairs._streams(pairs, bnodes))
    J, h, ln = bpairs.bidir_fwd_plain(*fin)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype,
                                device=dev)
    stages["bidir_adj_one_direction"] = functools.partial(
        bpairs.bidir_adj, *f32((*fin, J, h, cot(J), cot(h), cot(ln))))
    # the bidirectional filter and the per-sequence sampler's adjoint alone
    stages["bidir_fwd_one_direction"] = functools.partial(bpairs.bidir_fwd,
                                                          *f32(fin))
    for name, shape in (("T128", dict(B=B, T=128, d=D, S=1)),
                        ("T512", dict(B=B, T=512, d=D, S=1)),
                        ("slds", dict(B=16, T=80, d=4, S=2))):
        filt, samp, _ = chip_smoke.bpairs_problem(shape, 0, dev)
        stages[f"bidir_fwd_{name}"] = functools.partial(bpairs.bidir_fwd,
                                                        *f32(filt[:8]))
        stages[f"sampler_bp_adj_{name}"] = functools.partial(
            bpairs.sampler_bp_adj, *f32(samp))
        stages[f"sampler_bp_fwd_{name}"] = functools.partial(
            bpairs.sampler_bp_fwd, *f32(samp[:6]))
    return stages


def _hmm_stages(torch, dev):
    """The four HMM kernels alone at the slds_synth z-step's shape and at
    measure_hmm's, on float32 copies of the checkout's chip_smoke.py
    problems: the adjoints on the plain forward's messages and cotangents
    drawn from one seed."""
    import chip_smoke
    from svae_tpu_torch.ops import hmm_fb
    f32 = lambda xs: tuple(x.float().contiguous() for x in xs)
    stages = {}
    for name in ("slds", "measure_hmm"):
        li, lt, lo, _ = chip_smoke.hmm_problem(chip_smoke.HMM_SHAPES[name],
                                               0, dev)
        g = torch.Generator(device=dev).manual_seed(3)
        for fwd, adj in chip_smoke.HMM_RUNS:
            args = chip_smoke.hmm_kernel_args(li, lt, lo)[fwd]
            outs = getattr(hmm_fb, fwd + "_plain")(*args)
            cots = tuple(torch.randn(o.shape, generator=g, dtype=o.dtype,
                                     device=dev) for o in outs)
            stages[f"{fwd}_{name}"] = functools.partial(
                getattr(hmm_fb, fwd), *f32(args))
            stages[f"{adj}_{name}"] = functools.partial(
                getattr(hmm_fb, adj), *f32((*args, *outs, *cots)))
    return stages


def _kfwd_stages(torch, dev):
    """The two shared-pair filters alone (``kalman_fwd.filter_shared`` and
    ``backward_shared``) at chip_smoke.py's KFWD_SHAPES config-2 width and
    long T and, at config-2 width, at the other built latent sizes
    (``_d2`` ... ``_d16``), and on the same chains ``bpairs.bidir_fwd``
    over the B forward
    lanes and over the B backward lanes (the pairs expanded per sequence,
    as ``chip_smoke.kalman_fwd_timings`` runs it), on float32 copies of the
    checkout's chip_smoke.py problems."""
    import chip_smoke
    from svae_tpu_torch.ops import bpairs, kalman_fwd
    f32 = lambda xs: tuple(x.float().contiguous() for x in xs)
    stages = {}
    for name in ("config2", "longT"):
        init, pairs, nodes, _ = chip_smoke.kfwd_problem(
            chip_smoke.KFWD_SHAPES[name], 0, dev)
        stages[f"filter_shared_{name}"] = functools.partial(
            kalman_fwd.filter_shared,
            *f32(kalman_fwd.filter_inputs(init, pairs, nodes)))
        stages[f"backward_shared_{name}"] = functools.partial(
            kalman_fwd.backward_shared,
            *f32(kalman_fwd.backward_inputs(pairs, nodes)))
        J0, h0 = bpairs._initial(init, nodes)
        streams = bpairs._streams(pairs, nodes)
        lanes = {"fwd": bpairs._packed(J0, h0, streams),
                 "bwd": bpairs._packed(torch.zeros_like(J0),
                                       torch.zeros_like(h0),
                                       bpairs._reversed(streams))}
        for k, args in lanes.items():
            stages[f"bidir_fwd_shared_{k}_{name}"] = functools.partial(
                bpairs.bidir_fwd, *f32(args))
    # the other built latent sizes at config-2 width
    for d in (2, 3, 4, 8, 16):
        init, pairs, nodes, _ = chip_smoke.kfwd_problem(
            dict(B=B, T=T, d=d, S=1), d, dev)
        stages[f"filter_shared_d{d}"] = functools.partial(
            kalman_fwd.filter_shared,
            *f32(kalman_fwd.filter_inputs(init, pairs, nodes)))
        stages[f"backward_shared_d{d}"] = functools.partial(
            kalman_fwd.backward_shared,
            *f32(kalman_fwd.backward_inputs(pairs, nodes)))
    return stages


def _train_stages(torch, loop, lds, parts, glob, rec, dec, batch, gen):
    """One chunked config-2 train step, one ragged train step at the T=512
    bucket, each on its own copy of the models, and one slds_synth train
    step on its own models."""
    import chip_smoke
    from svae_tpu_torch.data.synthetic import make_switching_dot_data
    from svae_tpu_torch.models import slds
    prior = parts[3]
    copies = lambda: copy.deepcopy((glob, rec, dec))
    g1, r1, d1 = copies()
    run = functools.partial(lds.run_inference, parallel=8)
    opt_init, step = loop.make_train_step(run, *parts[1:], num_samples=S)
    chunked_state = [g1, (r1, d1), opt_init(g1, (r1, d1))]

    def chunked_step():
        chunked_state[:3] = step(*chunked_state, batch, gen)[:3]

    seqs = chip_smoke.ragged_corpus()
    bucket = next(b for b in chip_smoke._ragged_epoch(
        seqs, B, chip_smoke.RAGGED_PAD, batch.device) if b[0].shape[1] == 512)
    g2, r2, d2 = copies()
    ropt_init, rstep = loop.make_train_step(*parts[:3], prior, len(seqs),
                                            num_samples=1, ragged=True)
    ragged_state = [g2, (r2, d2), ropt_init(g2, (r2, d2))]

    def ragged_step():
        ragged_state[:3] = rstep(*ragged_state, bucket, gen)[:3]

    cfg = chip_smoke.SLDS_CONFIG
    sdata = torch.from_numpy(make_switching_dot_data(
        1, cfg["N"], cfg["T"], cfg["width"])).to(batch.device)
    sprior, sglob, srec, sdec = chip_smoke._slds_models(
        batch.device, cfg["K"], cfg["d"], cfg["width"], cfg["hidden"])
    sopt_init, sstep = loop.make_train_step(
        functools.partial(slds.run_inference,
                          num_meanfield_iters=cfg["sweeps"]),
        *parts[1:3], sprior, cfg["N"], num_samples=cfg["S"],
        pgm_step_size=cfg["pgm_step_size"],
        net_step_size=cfg["net_step_size"])
    slds_state = [sglob, (srec, sdec), sopt_init(sglob, (srec, sdec))]

    def slds_step():
        slds_state[:3] = sstep(*slds_state, sdata[:cfg["B"]], gen)[:3]

    return {"train_step_chunked": chunked_step,
            "ragged_train_step_T512": ragged_step,
            "slds_train_step": slds_step}


def worker(root, calls, only=None):
    """Time every stage of the checkout at ``root`` (those whose names
    start with a prefix in ``only``, if given); returns the readings."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    pkg = importlib.import_module("svae_tpu_torch")
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported svae_tpu_torch from {pkg.__file__}, "
                           f"not from {root}")
    from svae_tpu_torch.data.synthetic import make_dot_data
    from svae_tpu_torch.models import lds
    from svae_tpu_torch.nets import decoders, recognition
    from svae_tpu_torch.ops import _build, estep
    from svae_tpu_torch.train import elbo

    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0

    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    prior = lds.init_pgm_param(D, g, device=dev)
    glob = lds.init_pgm_param(D, g, device=dev)
    rec = recognition.init_mlp_recognize(D_OBS, (64,), D, g, device=dev)
    dec = decoders.init_mlp_decode(D, (64,), D_OBS, g, device=dev)
    batch = torch.from_numpy(make_dot_data(
        seed=0, num_seqs=B, T=T, image_width=D_OBS)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        nodes = rec(batch)
    init, mats = lds._expected_potentials(glob, torch.float32)
    parts = (lds.run_inference, recognition.mlp_recognize,
             decoders.mlp_loglike, prior, 50 * B)
    objective = elbo.make_objective(*parts, num_samples=S)

    def value():
        with torch.no_grad():
            return objective(glob, (rec, dec), batch, gen)

    stages = {
        "estep": lambda: estep.lds_estep_stationary(init, mats, nodes, gen,
                                                    S),
        "run_inference": lambda: lds.run_inference(prior, glob, nodes, gen,
                                                   S),
        "posterior_moments": lambda: lds.posterior_moments(glob, nodes),
        "objective_no_grad": value,
    }
    stages.update(_kernel_stages(torch, estep, init, mats, nodes))
    wanted = lambda k: only is None or k.startswith(tuple(only))
    # whether a stage of a family (a name prefix) may be wanted
    family = lambda f: only is None or any(
        f.startswith(p) or p.startswith(f) for p in only)
    if all(importlib.util.find_spec(f"svae_tpu_torch.ops.{m}")
           for m in ("bpairs", "chunked")) and any(
               map(family, ("elem_scan", "bidir", "sampler_bp"))):
        stages.update(_scan_bidir_adj_stages(torch, dev))
    if importlib.util.find_spec("svae_tpu_torch.ops.hmm_fb") and family(
            "hmm_fb"):
        stages.update(_hmm_stages(torch, dev))
    if importlib.util.find_spec("svae_tpu_torch.ops.kalman_fwd") and any(
            map(family, ("filter_shared", "backward_shared",
                         "bidir_fwd_shared"))):
        stages.update(_kfwd_stages(torch, dev))
    stages["empty_kernel"] = lambda: torch.cuda._sleep(0)
    stages = {k: fn for k, fn in stages.items() if wanted(k)}
    readings = {k: _median_ms(fn, calls) for k, fn in stages.items()}
    # the device time of the kernel stages alone, whose event time can be
    # the host's time to issue them (chip_smoke._device_ms: every kernel
    # the call runs, summed)
    import chip_smoke
    device = {}
    for k, fn in stages.items():
        if k.startswith(DEVICE_STAGES):
            ms = chip_smoke._device_ms(fn)
            device[k] = sum(ms.values()) if ms else float("nan")
    # the training loop is imported and built only now, so that every
    # checkout has done the same work when its inference stages are timed
    try:
        loop = importlib.import_module("svae_tpu_torch.train.loop")
    except ModuleNotFoundError:
        loop = None
    if loop is not None and wanted("train_step"):
        opt_init, step = loop.make_train_step(*parts, num_samples=S)
        state = [glob, (rec, dec), opt_init(glob, (rec, dec))]

        def train_step():
            state[0], state[1], state[2], _, _ = step(*state, batch, gen)

        readings["train_step"] = _median_ms(train_step, calls)
    if loop is not None and any(wanted(k) for k in (
            "train_step_chunked", "ragged_train_step_T512",
            "slds_train_step")):
        for k, fn in _train_stages(torch, loop, lds, parts, glob, rec, dec,
                                   batch, gen).items():
            if wanted(k):
                readings[k] = _median_ms(fn, calls)
    return {"root": root, "build_s": build_s, "stages": readings,
            "device": device}


def _summary_line(stage, root, ev, issue, base, root0):
    import numpy as np
    q1, med, q3 = np.percentile(ev, [25, 50, 75])
    line = (f"{stage} {root}: median {med:.4f} ms, quartiles "
            f"{q1:.4f}-{q3:.4f} ms, {len(ev)} runs")
    if issue is not None:
        i1, imed, i3 = np.percentile(issue, [25, 50, 75])
        line += (f"; issue median {imed:.4f} ms, quartiles "
                 f"{i1:.4f}-{i3:.4f} ms")
    if base is not None and len(base) == len(ev):
        faster = sum(b < a for a, b in zip(base, ev))
        line += f"; faster than {root0} in {faster} of {len(ev)} pairs"
    return line


def summarize(runs):
    """Per stage and checkout: median, quartiles and, against the first
    checkout, the pairs won (a pair is one run of each, next to each
    other in the A B B A order), by event time and, for DEVICE_STAGES, by
    device time. Returns the lines."""
    roots = list(dict.fromkeys(r["root"] for r in runs))
    lines = []
    for stage in runs[-1]["stages"]:
        by = {root: [r["stages"][stage] for r in runs
                     if r["root"] == root and stage in r["stages"]]
              for root in roots}
        dev = {root: [r["device"][stage] for r in runs if r["root"] == root
                      and stage in r.get("device", {})] for root in roots}
        for root in roots:
            if by[root]:
                ev, issue = zip(*by[root])
                base = (None if root == roots[0]
                        else [e for e, _ in by[roots[0]]])
                lines.append(_summary_line(stage, root, ev, issue, base,
                                           roots[0]))
            if dev[root]:
                base = None if root == roots[0] else dev[roots[0]]
                lines.append(_summary_line(stage + " (device)", root,
                                           dev[root], None, base, roots[0]))
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="checkout roots to compare")
    ap.add_argument("--calls", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--stages", nargs="+", metavar="PREFIX",
                    help="time only the stages whose names start with one "
                    "of these")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.dirs[0], args.calls, args.stages)))
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA card (this script has no CPU "
                         "path)")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    runs = []
    for root in (args.dirs + args.dirs[::-1]) * args.rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--calls", str(args.calls), root]
            + (["--stages", *args.stages] if args.stages else []),
            capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise SystemExit(f"chip_ab: the run of {root} failed:\n"
                             f"{proc.stdout}{proc.stderr}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(r)
        print(f"== {root}: build {r['build_s']:.1f} s; " + "; ".join(
            f"{k} event {ev:.4f} issue {iss:.4f} ms"
            for k, (ev, iss) in r["stages"].items()))
    print("\n".join(summarize(runs)))
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()
