"""Smoke run of the PyTorch port (svae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises, so the run
exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the E-step kernels from ``svae_tpu_torch/csrc/estep.cu`` with
   ``nvcc`` (seconds, registers and spills);
3. each kernel in float32 against its plain twin in float64 on the same
   inputs, on the card, at the main-path shape and a small odd one;
4. the main path at BASELINE config 2 (LDS-SVAE on 1-D dot videos, B=64,
   T=100, d_latent=10, d_obs=20, S=2, MLP recognizer and decoder of width
   64, random weights from a seed): the MC-ELBO objective on 3 batches and
   ``posterior_moments`` on one, with the launch counters showing both
   kernels ran there; then one batch's ELBO against the float64 twin path
   on the CPU under the same noise;
5. CUDA-event timings (median of 25 runs) of each kernel and its twin,
   and of the E-step on the kernel path and on the twin path.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. There is no CPU path.
"""

import copy
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.ops import _build, estep
from svae_tpu_torch.train import elbo
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map

SHAPES = {"small": dict(B=3, T=7, d=3, S=2),
          "config2": dict(B=64, T=100, d=10, S=2)}
# float32 kernel against float64 twin, after T=100 chained Schur
# complements (the tiers of tests/test_f32_parity.py)
TOL_ABS = 2e-3
TOL_LOGZ_REL = 2e-4
KERNELS = {
    "filter_fwd": "svae_tpu/ops/pallas_estep.py:63",
    "sampler_fwd": "svae_tpu/ops/pallas_estep.py:218",
}
SOURCE = "svae_tpu_torch/csrc/estep.cu"
TIMING_RUNS = 25


def _problem(shape, seed, device):
    """Expected potentials of random config-``shape`` global params and
    recognizer-like diagonal evidence, in float64 on ``device``."""
    B, T, d, S = (shape[k] for k in "BTdS")
    g = torch.Generator().manual_seed(seed)
    glob = lds.init_pgm_param(d, g, dtype=torch.float64, device=device)
    (I1, I2), Ic = niw.expected_gaussian_natparam(glob[0])
    mats = mniw.expected_pair_potential(glob[1])
    f64 = dict(dtype=torch.float64)
    jd = torch.logaddexp(torch.randn((B, T, d), generator=g, **f64),
                         torch.zeros(())) + 0.5
    h = torch.randn((B, T, d), generator=g, **f64)
    eps = torch.randn((S, B, T, d), generator=g, **f64)
    on = lambda x: x.to(device)
    return (I1, I2, Ic), mats, (on(jd), on(h)), on(eps)


def _f32(args):
    return tuple(a.float() for a in args)


def _max_err(got, want):
    return max(float((a.double() - b).abs().max()) for a, b in zip(got, want))


def check_kernels(shape, seed=0, device="cuda"):
    """Both kernels (float32) against their twins (float64) on the same
    inputs at ``shape``; raises past the tolerances. Returns the errors."""
    init, mats, nodes, eps = _problem(shape, seed, device)
    B = shape["B"]
    fin = estep.filter_inputs(init, mats, nodes)
    J, h, ln = estep.filter_fwd(*_f32(fin))
    Jp, hp, lnp = estep.filter_fwd_plain(*fin)
    torch.cuda.synchronize()
    filt_err = _max_err((J, h), (Jp, hp))
    ln_rel = abs(float(ln.double().sum() - lnp.sum())) / abs(float(lnp.sum()))

    # the sampler reads the (float64) forward messages of that filter
    Jf = torch.cat([fin[0][None, :, :B], Jp[:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], hp[:, :, :B]])
    sin, _ = estep.sampler_inputs(mats, Jf, hf, eps)
    x = estep.sampler_fwd(*_f32(sin))
    xp = estep.sampler_fwd_plain(*sin)
    torch.cuda.synchronize()
    samp_err = _max_err((x,), (xp,))

    errs = {"filter_fwd": filt_err, "filter_ln_rel": ln_rel,
            "sampler_fwd": samp_err}
    if not (filt_err <= TOL_ABS and ln_rel <= TOL_LOGZ_REL
            and samp_err <= TOL_ABS):
        raise AssertionError(f"kernel disagrees with its twin at {shape}: "
                             f"{errs}")
    return errs


def _time_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _config2_models(device):
    g = torch.Generator().manual_seed(0)
    prior = lds.init_pgm_param(10, g, device=device)
    glob = lds.init_pgm_param(10, g, device=device)
    rec = recognition.init_mlp_recognize(20, (64,), 10, g, device=device)
    dec = decoders.init_mlp_decode(10, (64,), 20, g, device=device)
    return prior, glob, rec, dec


def _finite(tree, what):
    for leaf in tree_leaves(tree):
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            raise AssertionError(f"non-finite output in {what}")


def main_path(device="cuda"):
    """Phase 4: drive the config-2 main path; returns the launch counts."""
    B, T, S = 64, 100, 2
    N = 50 * B
    data = make_dot_data(seed=0, num_seqs=3 * B, T=T, image_width=20)
    batches = torch.from_numpy(data).to(device).reshape(3, B, T, 20)
    prior, glob, rec, dec = _config2_models(device)
    objective = elbo.make_objective(
        lds.run_inference, recognition.mlp_recognize, decoders.mlp_loglike,
        prior, N, num_samples=S)
    gen = torch.Generator(device=device).manual_seed(1)

    for counter in (estep.filter_fwd, estep.sampler_fwd):
        counter.launches = 0
    for twin in (estep.filter_fwd_plain, estep.sampler_fwd_plain):
        twin.calls = 0
    values = [objective(glob, (rec, dec), batch, gen) for batch in batches]
    with torch.no_grad():
        moments = lds.posterior_moments(glob, rec(batches[0]))
    torch.cuda.synchronize()
    launches = {"filter_fwd": estep.filter_fwd.launches,
                "sampler_fwd": estep.sampler_fwd.launches}
    twin_calls = estep.filter_fwd_plain.calls + estep.sampler_fwd_plain.calls

    print(f"main path: launches {launches}, twin calls {twin_calls}")
    if launches["filter_fwd"] < 4 or launches["sampler_fwd"] < 3:
        raise AssertionError(f"main path missed a kernel: {launches}")
    if twin_calls:
        raise AssertionError("the main path called a plain twin on the card")
    _finite([(v, s, tuple(terms.values())) for v, (s, terms) in values],
            "the objective")
    _finite(moments, "posterior_moments")
    Ex, ExxT, Exnxt, logZ = moments
    if (Ex.shape != (B, T, 10) or ExxT.shape != (B, T, 10, 10)
            or Exnxt.shape != (B, T - 1, 10, 10) or logZ.shape != (B,)):
        raise AssertionError("posterior_moments: wrong shapes")
    cov = ExxT.double() - Ex.double()[..., :, None] * Ex.double()[..., None, :]
    info = torch.linalg.cholesky_ex(cov).info
    if int((info != 0).sum()):
        raise AssertionError("a smoothed covariance is not positive definite")
    for i, (val, (stats, terms)) in enumerate(values):
        print(f"batch {i}: elbo/N {float(val):.6f} "
              + " ".join(f"{k} {float(v):.6f}" for k, v in terms.items()))

    # one batch against the float64 twin path on the CPU, same noise
    eps = torch.randn((S, B, T, 10), generator=gen, device=device)
    run = functools.partial(lds.run_inference, eps=eps)
    obj = elbo.make_objective(run, recognition.mlp_recognize,
                              decoders.mlp_loglike, prior, N, num_samples=S)
    val, (stats, _) = obj(glob, (rec, dec), batches[0], gen)
    cpu64 = lambda t: t.detach().double().cpu()
    run64 = functools.partial(lds.run_inference, eps=cpu64(eps))
    obj64 = elbo.make_objective(run64, recognition.mlp_recognize,
                                decoders.mlp_loglike, tree_map(cpu64, prior),
                                N, num_samples=S)
    nets64 = tuple(copy.deepcopy(m).double().cpu() for m in (rec, dec))
    val64, (stats64, _) = obj64(tree_map(cpu64, glob), nets64,
                                cpu64(batches[0]), None)
    rel = abs(float(val) - float(val64)) / abs(float(val64))
    stat_rel = max(float((cpu64(a) - b).abs().max() / b.abs().max())
                   for a, b in zip(tree_leaves(stats), tree_leaves(stats64)))
    print(f"main path vs float64 CPU twin path: elbo rel {rel:.3e}, "
          f"stats rel {stat_rel:.3e}")
    if not (rel <= TOL_LOGZ_REL and stat_rel <= TOL_LOGZ_REL):
        raise AssertionError("the main path disagrees with the f64 reference")
    return launches


def timings(device="cuda"):
    """Phase 5: kernel and twin times at config 2, float32 on the card."""
    shape = SHAPES["config2"]
    B, S = shape["B"], shape["S"]
    init, mats, nodes, eps = _problem(shape, 0, device)
    init, mats, nodes, eps = (_f32(init), _f32(mats), _f32(nodes),
                              eps.float())
    fin = estep.filter_inputs(init, mats, nodes)
    J, h, _ = estep.filter_fwd(*fin)
    Jf = torch.cat([fin[0][None, :, :B], J[:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], h[:, :, :B]])
    sin, _ = estep.sampler_inputs(mats, Jf, hf, eps)
    gen = torch.Generator(device=device).manual_seed(2)
    t = {
        "filter_fwd": _time_ms(lambda: estep.filter_fwd(*fin)),
        "filter_fwd_plain": _time_ms(lambda: estep.filter_fwd_plain(*fin)),
        "sampler_fwd": _time_ms(lambda: estep.sampler_fwd(*sin)),
        "sampler_fwd_plain": _time_ms(lambda: estep.sampler_fwd_plain(*sin)),
        "estep_kernels": _time_ms(lambda: estep.lds_estep_stationary(
            init, mats, nodes, gen, S)),
        "estep_twins": _time_ms(lambda: estep.lds_estep_stationary(
            init, mats, nodes, gen, S, plain=True)),
    }
    glob = lds.init_pgm_param(shape["d"], torch.Generator().manual_seed(0),
                              device=device)
    t["run_inference"] = _time_ms(lambda: lds.run_inference(
        glob, glob, nodes, gen, S))
    for k, ms in t.items():
        print(f"time {k}: {ms:.4f} ms"
              + (f" = {B / ms * 1e3:.1f} seqs/s" if "estep" in k
                 or k == "run_inference" else ""))
    return t


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (this script has no CPU "
                         "path)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so}")
    with open(so + ".log") as f:
        for line in f:
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print("  ptxas:", line.split(":", 1)[-1].strip())

    errs = {}
    for name, shape in SHAPES.items():
        e = check_kernels(shape)
        print(f"kernels vs twins [{name} {shape}]: {e}")
        for k in KERNELS:
            errs[k] = max(errs.get(k, 0.0), e[k])

    launches = main_path()
    t = timings()
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": KERNELS[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": t[k],
                "plain_ms": t[k + "_plain"]} for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
