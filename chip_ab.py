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
outputs and cotangents drawn from one seed) where the checkout has them
and, where the checkout has the training loop, one train step
(``make_train_step``).
Prints one line per run, then for every stage and checkout the median
and quartiles of the event times and of the issue times and, against the
first checkout, how many of the A B / B A pairs each side was faster in
(by event time), and last a JSON object of every reading. There is no CPU path.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

B, T, S, D, D_OBS = 64, 100, 2, 10, 20


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


def worker(root, calls):
    """Time every stage of the checkout at ``root``; returns the readings."""
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
    readings = {k: _median_ms(fn, calls) for k, fn in stages.items()}
    # the training loop is imported and built only now, so that every
    # checkout has done the same work when its inference stages are timed
    try:
        loop = importlib.import_module("svae_tpu_torch.train.loop")
    except ModuleNotFoundError:
        loop = None
    if loop is not None:
        opt_init, step = loop.make_train_step(*parts, num_samples=S)
        state = [glob, (rec, dec), opt_init(glob, (rec, dec))]

        def train_step():
            state[0], state[1], state[2], _, _ = step(*state, batch, gen)

        readings["train_step"] = _median_ms(train_step, calls)
    return {"root": root, "build_s": build_s, "stages": readings}


def summarize(runs):
    """Per stage and checkout: median, quartiles and, against the first
    checkout, the pairs won (a pair is one run of each, next to each
    other in the A B B A order). Returns the lines."""
    import numpy as np
    roots = list(dict.fromkeys(r["root"] for r in runs))
    lines = []
    for stage in runs[-1]["stages"]:
        by = {root: [r["stages"][stage] for r in runs
                     if r["root"] == root and stage in r["stages"]]
              for root in roots}
        for root in roots:
            if not by[root]:
                continue
            ev, issue = zip(*by[root])
            q1, med, q3 = np.percentile(ev, [25, 50, 75])
            i1, imed, i3 = np.percentile(issue, [25, 50, 75])
            line = (f"{stage} {root}: median {med:.4f} ms, quartiles "
                    f"{q1:.4f}-{q3:.4f} ms, {len(ev)} runs; issue median "
                    f"{imed:.4f} ms, quartiles {i1:.4f}-{i3:.4f} ms")
            base = [e for e, _ in by[roots[0]]]
            if root != roots[0] and len(base) == len(ev):
                faster = sum(b < a for a, b in zip(base, ev))
                line += (f"; faster than {roots[0]} in {faster} of "
                         f"{len(ev)} pairs")
            lines.append(line)
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="checkout roots to compare")
    ap.add_argument("--calls", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.dirs[0], args.calls)))
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
             "--calls", str(args.calls), root], capture_output=True,
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
