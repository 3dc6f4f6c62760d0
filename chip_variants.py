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
    python3 chip_variants.py wide_dim --values 24

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

``wide_dim`` weighs a kernel instance for a latent size d against the
padding that would serve d without it (``estep.kernel_dim``): each value d
rewrites the instances that the ``*_wide.cu`` sources build
(``SVAE_BUILT_DIMS`` in csrc/estep_common.cuh) to d alone in a copy of
csrc/, compiles those nine sources at once (their seconds and ptxas lines
printed), holds every E-step route of ``chip_smoke.ROUTES`` at d on that
build to its float64 twin (``chip_smoke.check_routes``), then times each
route at config 4's B=8, T=500, S=2 (the forward and, through its
autograd Function, the adjoint, as a train step runs them) on that
instance and, on the package's own build, padded to the next built d
above d, in turns (padded, instance, instance, padded), ``R`` times over.
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
import time

import numpy as np
import torch

import chip_smoke
from svae_tpu_torch.ops import _build, bpairs, estep, hmm_fb, kalman_fwd
from svae_tpu_torch.ops.estep import _check_kernel_args

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


class _WideOnly:
    """A library of the ``*_wide.cu`` sources alone: its C entries by their
    names without the suffix, so that every d the wrappers pass reaches the
    one instance those sources build."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name + _build.WIDE_SUFFIX)


def build_wide(d):
    """The ``*_wide.cu`` sources built for ``d`` alone, one nvcc a source,
    all at once: ``(library, {source: seconds}, nvcc's report)``."""
    root = os.path.join(OUT, f"d{d}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    common = os.path.join(root, "estep_common.cuh")
    with open(common) as f:
        text = f.read()
    text, n = re.subn(r"(#ifdef SVAE_WIDE\n#define SVAE_BUILT_DIMS\(CASE\))"
                      r"[^\n]*", rf"\1 CASE({d})", text)
    if n != 1:
        raise RuntimeError("estep_common.cuh: the wide instance list is "
                           "not defined once")
    with open(common, "w") as f:
        f.write(text)
    srcs = sorted(f for f in os.listdir(root) if f.endswith("_wide.cu"))
    nvcc = _build.nvcc_path()

    def one(src):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *_build.COMPILE_FLAGS, "-c", "-o",
             os.path.join(root, src + ".o"), os.path.join(root, src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        return src, time.perf_counter() - t0, proc.stdout + proc.stderr

    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        done = list(pool.map(one, srcs))
    so = os.path.join(root, "libwide.so")
    subprocess.run([nvcc, "-shared", "-o", so]
                   + [os.path.join(root, s + ".o") for s in srcs],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, ints, ptrs in _build.ENTRIES:
        fn = getattr(lib, name + _build.WIDE_SUFFIX, None)
        if fn is not None:
            fn.argtypes = [i] * ints + [p] * ptrs
            fn.restype = i
    return (_WideOnly(lib), {s: t for s, t, _ in done},
            "".join(log for _, _, log in done))


def _route_call(name, args, g):
    """A call of E-step route ``name`` as a train step makes it: the
    forward through ``estep._forward`` and, where the route has an
    autograd Function, the gradients of its inputs against seeded
    cotangents (the adjoint kernel)."""
    kernel, twin, fn, padding, _ = chip_smoke.ROUTES[name]
    a32 = tuple(a.float().requires_grad_(fn is not None) for a in args)
    with torch.no_grad():
        outs = chip_smoke._tup(twin(*a32))
    cots = [torch.randn(o.shape, generator=g, device=o.device) for o in outs]

    def call():
        with torch.set_grad_enabled(fn is not None):
            got = chip_smoke._tup(estep._forward(kernel, twin, fn, a32,
                                                 padding=padding))
            if fn is not None:
                torch.autograd.grad(got, a32, cots, allow_unused=True)
    return call


def wide_dim(values, rounds):
    """The ``wide_dim`` mode (see the module docstring)."""
    dims, check_defaults = estep.KERNEL_DIMS, _check_kernel_args.__defaults__

    def use(built, lib):
        # a library and the dims it serves, which the wrappers' check and
        # kernel_dim then take
        _build._lib = lib
        estep.KERNEL_DIMS = tuple(sorted(built))
        _check_kernel_args.__defaults__ = (estep.KERNEL_DIMS,
                                           *check_defaults[1:])

    normal = _build.load_library()
    shape = dict(chip_smoke.CONV_SHAPE)
    readings = {}
    for d in values:
        lib, secs, log = build_wide(d)
        print(f"d={d}: nvcc seconds "
              f"{json.dumps({s: round(t, 1) for s, t in secs.items()})}")
        print(f"d={d}: " + "; ".join(
            ln for ln in ptxas_lines(log, ALL_FUNCTIONS)
            if ln.split(":")[0].endswith(f"<{d}>")))
        instance = (set(dims) | {d}, lib)
        padded = ({x for x in dims if x != d}, normal)
        use(*instance)
        print(f"d={d} instance: routes vs float64 twins "
              f"{chip_smoke.check_routes(d, seed=d)}")
        probs = chip_smoke.route_problems(d, 0, "cuda", shape=shape)
        g = torch.Generator(device="cuda").manual_seed(d)
        calls = {name: _route_call(name, a, g) for name, a in probs.items()}
        for _ in range(rounds):
            for tag in ("padded", "instance", "instance", "padded"):
                use(*(instance if tag == "instance" else padded))
                for name, call in calls.items():
                    ev = chip_smoke._time_ms(call)
                    dev = sum(chip_smoke._device_ms(call).values())
                    readings.setdefault(f"{name} d={d} {tag}", []).append(
                        (ev, dev))
        use(dims, normal)
    for key, rs in readings.items():
        ev, dev = zip(*rs)
        print(f"wide_dim {key} [B=8, T=500, S=2]: event median "
              f"{np.median(ev):.4f} ms {[round(e, 4) for e in ev]}, "
              f"device median {np.median(dev):.4f} ms "
              f"{[round(x, 4) for x in dev]}")
    print(json.dumps({"readings": readings}))


# every d-templated kernel function, for the ptxas lines of wide_dim
ALL_FUNCTIONS = tuple(
    f"{k}_kernel" for k in (
        "filter_fwd", "sampler_fwd_factor", "sampler_fwd_chain",
        "filter_adj_factor", "filter_adj_chain", "sampler_adj_factor",
        "sampler_adj_chain", "sampler_adj_dJc", "bidir_fwd",
        "sampler_bp_fwd_factor", "sampler_bp_fwd_chain",
        "sampler_shared_factor", "bidir_adj_factor", "bidir_adj_chain",
        "sampler_bp_adj_factor", "sampler_bp_adj_chain",
        "sampler_bp_adj_dJc", "elem_scan", "elem_scan_adj_factor",
        "elem_scan_adj_chain", "filter_shared", "backward_shared"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS) + ["wide_dim"])
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
    if args.kernel == "wide_dim":
        return wide_dim(args.values, args.rounds)
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
