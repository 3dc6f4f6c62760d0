"""Time variants of a kernel's compile-time constant side by side on one
CUDA card: ``bidir_fwd``'s chains (warps) a block (``kBidirChains``,
svae_tpu_torch/csrc/bpairs.cu), the ring depth of ``sampler_bp_adj``'s
chain pass (``kBpRing``, csrc/sampler_bp_adj.cu) or of ``sampler_bp_fwd``'s
(``kBpFwdRing``, csrc/bpairs.cu; the chain pass the shared-pair sampler
runs too); the ring depth of ``hmm_fb_fwd``
(``kHmmRing``, csrc/hmm_fb.cu), of ``hmm_fb_stat_fwd`` (``kHmmStatRing``)
and of ``hmm_fb_adj``'s chain pass
(``kHmmAdjRing``, csrc/hmm_fb_adj.cu); the shared-pair filters' chains a
block (``kSharedChains``, csrc/kalman_fwd.cu) or, with ``--constant
kSharedRing``, their ring depth.

    python3 chip_variants.py bidir_fwd [--values 1 2 4] [--rounds R]
    python3 chip_variants.py sampler_bp_adj --values 2 3 4
    python3 chip_variants.py sampler_bp_fwd --values 4 8 16
    python3 chip_variants.py hmm_fb_fwd --values 2 4 8
    python3 chip_variants.py hmm_fb_stat_fwd --values 2 4 8
    python3 chip_variants.py hmm_fb_adj --values 2 4 8
    python3 chip_variants.py shared_filters --values 1 2 4
    python3 chip_variants.py shared_filters --constant kSharedRing \
        --values 2 4 8

Each value rewrites the constant's definition (``constexpr int NAME =
N;``) in a copy of svae_tpu_torch/csrc/ under the build directory,
compiles that copy's source alone with nvcc (ops/_build.py's flags), all
values at once, prints what ptxas reports for the kernel's functions at
each d, loads each library with ctypes and times the wrapper on it (median
of 25 CUDA-event timings, and the device time of its kernels under
torch.profiler) on chip_smoke.py's float32 problems at the shapes it runs
at: ragged B=64 batches of T=128 and T=512, the slds_synth x-step's (B=16,
T=80, d=4, S=2) and, for ``bidir_fwd``, one direction's 8 lanes of
T=2048, for ``sampler_bp_fwd`` the shared-pair sampler
(``kalman_fwd.sampler_shared``, the same chain pass) at config-2 width
(B=64, T=100, d=10, S=2) and at B=8, T=2048; the HMM kernels at the slds_synth z-step's shape (B=16, T=80,
K=4) and measure_hmm's (B=128, T=100, K=8), the adjoint on the plain
forward's messages and seeded cotangents, and beside the stationary
forward the streamed one on the same chains (``streamed_*``: the same
chain step, the kernel the stationary one must match bit for bit); the
shared-pair filters (``kalman_fwd.filter_shared`` and ``backward_shared``, both timed) at
config-2 width (B=64, T=100, d=10) and at B=8, T=2048. Each variant is
first held to the float64 plain version. The
variants run in turns (A B C C B A), ``R`` times over, in one process.
Prints the card's name and power limit, one line per reading and a JSON
object of all of them. There is no CPU path.
"""

import argparse
import concurrent.futures
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess

import numpy as np
import torch

import chip_smoke
from svae_tpu_torch.ops import _build, bpairs, hmm_fb, kalman_fwd

OUT = os.path.join(_build.BUILD_DIR, "variants")
_HMM_ADJ = ("svae_hmm_fb_adj_f32", "svae_hmm_fb_adj_weights_f32",
            "svae_hmm_fb_adj_chain_f32", "svae_hmm_fb_adj_dM_f32")
_HMM_ADJ_KERNELS = ("hmm_fb_adj_weights_kernel", "hmm_fb_adj_chain_kernel",
                    "hmm_fb_adj_dM_kernel")
# kernel: (constants, the first the default; source, C entries, ptxas
# functions, the wrappers' kernels under the profiler)
KERNELS = {
    "bidir_fwd": (("kBidirChains",), "bpairs.cu", ("svae_bidir_fwd_f32",),
                  ("bidir_fwd_kernel",), "bidir_fwd_kernel"),
    "sampler_bp_adj": (("kBpRing",), "sampler_bp_adj.cu",
                       [n for n, _, _ in _build.ENTRIES
                        if n.startswith("svae_sampler_bp_adj")],
                       ("sampler_bp_adj_chain_kernel",
                        "sampler_bp_adj_dJc_kernel"), "sampler_bp_adj"),
    "sampler_bp_fwd": (("kBpFwdRing",), "bpairs.cu",
                       [n for n, _, _ in _build.ENTRIES
                        if n.startswith(("svae_sampler_bp_fwd",
                                         "svae_sampler_shared"))],
                       ("sampler_bp_fwd_factor_kernel",
                        "sampler_shared_factor_kernel",
                        "sampler_bp_fwd_chain_kernel"),
                       ("sampler_bp_fwd", "sampler_shared")),
    "hmm_fb_fwd": (("kHmmRing",), "hmm_fb.cu", ("svae_hmm_fb_fwd_f32",),
                   ("hmm_fb_fwd_kernel",), "hmm_fb_fwd"),
    "hmm_fb_stat_fwd": (("kHmmStatRing",), "hmm_fb.cu",
                        ("svae_hmm_fb_fwd_f32", "svae_hmm_fb_stat_fwd_f32"),
                        ("hmm_fb_stat_fwd_kernel", "hmm_fb_fwd_kernel"),
                        ("hmm_fb_stat_fwd", "hmm_fb_fwd")),
    "hmm_fb_adj": (("kHmmAdjRing",), "hmm_fb_adj.cu", _HMM_ADJ,
                   _HMM_ADJ_KERNELS, "hmm_fb_adj"),
    "shared_filters": (("kSharedChains", "kSharedRing"), "kalman_fwd.cu",
                       ("svae_filter_shared_f32", "svae_backward_shared_f32"),
                       ("filter_shared_kernel", "backward_shared_kernel"),
                       ("filter_shared_kernel", "backward_shared_kernel")),
}


def build_variant(kernel, constant, value):
    """The library of the kernel's source with its constant = value, and
    nvcc's report."""
    source = KERNELS[kernel][1]
    root = os.path.join(OUT, f"{constant}_{value}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    src = os.path.join(root, source)
    with open(src) as f:
        text = f.read()
    text, n = re.subn(rf"constexpr int {constant} = \d+;",
                      f"constexpr int {constant} = {value};", text)
    if n != 1:
        raise RuntimeError(f"{constant} is not defined once in {source}")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(root, "libvariant.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.COMPILE_FLAGS,
                           "-shared", "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return so, proc.stdout + proc.stderr


def ptxas_lines(log, functions):
    """Registers and spill stores of the functions in nvcc's report."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            k = re.search(r"([A-Za-z_]+_kernel)ILi(\d+)E", m.group(1))
            name = (f"{k.group(1)}<{k.group(2)}>"
                    if k and k.group(1) in functions else None)
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spill stores")
            name = None
    return out


def _wrapper(kernel, problem):
    """The wrapper a variant of ``kernel`` is timed through at ``problem``
    (a key of ``problems``), and its plain version."""
    if kernel == "shared_filters":
        mod = kalman_fwd
        kernel = ("filter_shared" if problem.startswith("fwd")
                  else "backward_shared")
    elif problem.startswith("shared_"):
        mod, kernel = kalman_fwd, "sampler_shared"
    elif problem.startswith("streamed_"):
        mod, kernel = hmm_fb, "hmm_fb_fwd"
    else:
        mod = hmm_fb if kernel.startswith("hmm_fb") else bpairs
    return getattr(mod, kernel), getattr(mod, kernel + "_plain")


def problems(kernel, device="cuda"):
    """``{shape: the wrapper's float64 arguments}``."""
    if kernel == "shared_filters":
        probs = {}
        for name in ("config2", "longT"):
            init, pairs, nodes, _ = chip_smoke.kfwd_problem(
                chip_smoke.KFWD_SHAPES[name], 0, device)
            probs["fwd_" + name] = kalman_fwd.filter_inputs(init, pairs,
                                                            nodes)
            probs["bwd_" + name] = kalman_fwd.backward_inputs(pairs, nodes)
        return probs
    if kernel.startswith("hmm_fb"):
        probs = {}
        for name in ("slds", "measure_hmm"):
            li, lt, lo, _ = chip_smoke.hmm_problem(
                chip_smoke.HMM_SHAPES[name], 0, device)
            args = chip_smoke.hmm_kernel_args(li, lt, lo)
            if kernel == "hmm_fb_stat_fwd":
                probs["streamed_" + name] = args["hmm_fb_fwd"]
            args = args["hmm_fb_stat_fwd" if kernel == "hmm_fb_stat_fwd"
                        else "hmm_fb_fwd"]
            if kernel == "hmm_fb_adj":
                outs = hmm_fb.hmm_fb_fwd_plain(*args)
                g = torch.Generator(device=device).manual_seed(3)
                args = (*args, *outs, *(
                    torch.randn(o.shape, generator=g, dtype=o.dtype,
                                device=device) for o in outs))
            probs[name] = args
        return probs
    shapes = {"T128": chip_smoke.RAGGED_SHAPES["ragged"],
              "T512": chip_smoke.RAGGED_LONG,
              "slds": chip_smoke.BIDIR_ADJ_SHAPES["slds"]}
    probs = {}
    for name, shape in shapes.items():
        filt, samp, _ = chip_smoke.bpairs_problem(shape, 0, device)
        probs[name] = (filt[:8] if kernel == "bidir_fwd" else
                       samp[:6] if kernel == "sampler_bp_fwd" else samp)
    if kernel == "bidir_fwd":
        probs["one_direction"] = chip_smoke.one_direction_problem(
            chip_smoke.BIDIR_ADJ_SHAPES["one_direction"], 0, device)[:8]
    if kernel == "sampler_bp_fwd":
        for name in ("config2", "longT"):
            probs["shared_" + name] = chip_smoke._kfwd_sampler_problem(
                chip_smoke.kfwd_problem(chip_smoke.KFWD_SHAPES[name], 0,
                                        device), device)
    return probs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--constant", help="the constant to vary (default: the "
                    "kernel's first)")
    ap.add_argument("--values", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants: no CUDA card (this script has no "
                         "CPU path)")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    constants, _, entries, functions, prefix = KERNELS[args.kernel]
    constant = args.constant or constants[0]
    if constant not in constants:
        raise SystemExit(f"chip_variants: {args.kernel} varies {constants}")
    with concurrent.futures.ThreadPoolExecutor(len(args.values)) as pool:
        built = dict(zip(args.values, pool.map(
            lambda v: build_variant(args.kernel, constant, v), args.values)))
    libs = {}
    for v, (so, log) in built.items():
        print(f"{constant}={v}: " + "; ".join(ptxas_lines(log, functions)))
        libs[v] = _build.bind(ctypes.CDLL(so), entries)
    probs = problems(args.kernel)
    f32 = {k: chip_smoke._f32(a) for k, a in probs.items()}
    for v, lib in libs.items():
        _build._lib = lib
        for k, a in probs.items():
            wrapper, plain = _wrapper(args.kernel, k)
            got = wrapper(*f32[k])
            torch.cuda.synchronize()
            want = plain(*a)
            if args.kernel in ("hmm_fb_fwd", "hmm_fb_stat_fwd"):
                err = chip_smoke._rel_err(got, want)[0]
                ok = err <= chip_smoke.TOL_MSG_REL
                if wrapper is hmm_fb.hmm_fb_stat_fwd:
                    chip_smoke.check_hmm_stat_fwd_bitwise(a)
            elif args.kernel in ("bidir_fwd", "shared_filters"):
                err = chip_smoke._max_err(got[:2], want[:2])
                ok = err <= chip_smoke.TOL_ABS
            elif args.kernel == "sampler_bp_fwd":
                err = chip_smoke._max_err((got,), (want,))
                ok = err <= chip_smoke.TOL_ABS
            else:
                err = chip_smoke._rel_err(got, want)[0]
                ok = err <= chip_smoke.TOL_ADJ_REL
            if not ok:
                raise AssertionError(f"{constant}={v} at {k}: error {err}")
    readings = {}
    for _ in range(args.rounds):
        for v in args.values + args.values[::-1]:
            _build._lib = libs[v]
            for k, a in f32.items():
                fn = functools.partial(_wrapper(args.kernel, k)[0], *a)
                ev = chip_smoke._time_ms(fn)
                dev = chip_smoke._device_ms(fn)
                mine = {n: ms for n, ms in dev.items()
                        if n.startswith(prefix)}
                readings.setdefault(f"{k} {constant}={v}", []).append(
                    (ev, sum(mine.values()), mine))
    for key, rs in readings.items():
        ev, dev, parts = zip(*rs)
        per = {n: round(float(np.median([p[n] for p in parts])), 4)
               for n in parts[0]}
        print(f"{args.kernel} {key}: event median {np.median(ev):.4f} ms "
              f"{[round(e, 4) for e in ev]}, device median "
              f"{np.median(dev):.4f} ms {per}")
    print(json.dumps({"readings": readings}))


if __name__ == "__main__":
    main()
