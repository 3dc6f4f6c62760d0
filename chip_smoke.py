"""Smoke run of the PyTorch port (svae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises, so the run
exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the E-step kernels from ``svae_tpu_torch/csrc/*.cu`` with ``nvcc``,
   one process per source, all at once (seconds, registers and spills per
   kernel and latent size);
3. each forward kernel in float32 against its plain twin in float64 on the
   same inputs, and each adjoint kernel in float32 against its plain
   adjoint in float64 on the same inputs and random cotangents, on the
   card, at the main-path shape and a small odd one;
4. the inference path at BASELINE config 2 (LDS-SVAE on 1-D dot videos,
   B=64, T=100, d_latent=10, d_obs=20, S=2, MLP recognizer and decoder of
   width 64, random weights from a seed): the MC-ELBO objective on 3
   batches and ``posterior_moments`` on one, with the launch counters
   showing both forward kernels ran there; then one batch's ELBO against
   the float64 twin path on the CPU under the same noise;
4b. the training path at config 2: ``make_fused_train_step(k_steps=8,
   stacked_batch=True)`` over 8 distinct minibatches, then 4 steps of
   ``loop.run``, with the launch counters showing all four kernels ran
   every step and no plain version ran; then one step's ELBO, natural
   gradient and net gradients against the float64 twin path on the CPU
   under the same noise;
3r. each per-sequence-pairs ("bpairs") kernel of the ragged path, forward
   and adjoint, in float32 against its plain version in float64 on the
   same inputs (and random cotangents), at a small odd shape and at a
   ragged one (B=64, T=128, lengths spread over [2, 128]), and at T=512
   (lengths over [2, 512]), all under the same tiers;
4c. ragged training at ``benchmarks/ragged_throughput.py``'s shape: its
   corpus of 512 sequences (lengths uniform in [64, 512], d_obs=20) made
   from a seed, d=10, S=1, MLP recognizer and decoder of width 64, one
   epoch through ``make_loader(pad_multiple=64, drop_remainder=True)`` and
   ``run_loader`` (8 steps), with the launch counters showing the four
   bpairs kernels ran every step, the stationary kernels and every plain
   version not at all; then one step at the T=512 bucket and one at the
   T=128 bucket against the float64 CPU path under the same noise,
   ``posterior_moments(lengths=)``
   on one batch, and the padded-batch theorem on the card (two sequences:
   stats and local KL of the padded batch against the two alone);
5. CUDA-event timings (median of 25 runs, 10 for the plain versions at
   T=128) of each kernel and its plain version, of the E-step on the
   kernel path and on the twin path, of one train step and of the fused
   8-step call; of the bpairs kernels at B=64, T=128 and T=512, of one
   ragged train step per length bucket, and of the bucketed epoch against
   the same corpus padded to T=512.

The line before the last is a JSON object with one entry per kernel (its
launches on the training path that runs it, error, times and bound); the
last line is ``{"ok": true, "device": {...}}``. There is no CPU path.
"""

import copy
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from svae_tpu_torch.data import loader as data_loader
from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.ops import _build, bpairs, estep
from svae_tpu_torch.train import elbo, loop
from svae_tpu_torch.utils.pytree import tree_leaves, tree_map

SHAPES = {"small": dict(B=3, T=7, d=3, S=2),
          "config2": dict(B=64, T=100, d=10, S=2)}
# float32 kernel against float64 twin, after T=100 chained Schur
# complements (the tiers of tests/test_f32_parity.py)
TOL_ABS = 2e-3
TOL_LOGZ_REL = 2e-4
# float32 adjoint against float64 plain adjoint, normwise per output: the
# cotangents run back through the same T=100 chained Schur complements and
# pick up their rounding once more
TOL_ADJ_REL = 1e-3
KERNELS = {
    "filter_fwd": "svae_tpu/ops/pallas_estep.py:63",
    "filter_adj": "svae_tpu/ops/pallas_estep.py:121",
    "sampler_fwd": "svae_tpu/ops/pallas_estep.py:218",
    "sampler_adj": "svae_tpu/ops/pallas_estep.py:252",
    "bidir_fwd": "svae_tpu/ops/pallas_bidir.py:71",
    "bidir_adj": "svae_tpu/ops/pallas_bidir.py:121",
    "sampler_bp_fwd": "svae_tpu/ops/pallas_vjp.py:169",
    "sampler_bp_adj": "svae_tpu/ops/pallas_vjp.py:417",
}
SOURCES = {
    "filter_fwd": "svae_tpu_torch/csrc/estep.cu",
    "filter_adj": "svae_tpu_torch/csrc/filter_adj.cu",
    "sampler_fwd": "svae_tpu_torch/csrc/estep.cu",
    "sampler_adj": "svae_tpu_torch/csrc/sampler_adj.cu",
    "bidir_fwd": "svae_tpu_torch/csrc/bpairs.cu",
    "bidir_adj": "svae_tpu_torch/csrc/bidir_adj.cu",
    "sampler_bp_fwd": "svae_tpu_torch/csrc/bpairs.cu",
    "sampler_bp_adj": "svae_tpu_torch/csrc/sampler_bp_adj.cu",
}
# ragged batches of the bpairs kernels: lengths spread evenly over [2, T]
RAGGED_SHAPES = {"small": dict(B=3, T=7, d=3, S=2),
                 "ragged": dict(B=64, T=128, d=10, S=1)}
RAGGED_LONG = dict(B=64, T=512, d=10, S=1)
# benchmarks/ragged_throughput.py
RAGGED_CORPUS = dict(N=512, T_min=64, T_max=512, d_obs=20)
RAGGED_B, RAGGED_PAD = 64, 64
# the padded-batch theorem in float32: stats and local KL of a padded
# batch against its sequences run alone (tests/test_masking.py's Pallas
# tier)
TOL_PAD_REL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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


def _rel_err(got, want):
    """Worst normwise relative error and worst absolute error over the
    outputs (None outputs skipped)."""
    pairs = [(a.double(), b) for a, b in zip(got, want) if a is not None]
    rel = max(float((a - b).norm() / b.norm()) for a, b in pairs)
    return rel, max(float((a - b).abs().max()) for a, b in pairs)


def adjoint_problem(shape, seed=0, device="cuda"):
    """float64 inputs of both adjoints at ``shape``: the forward twins'
    inputs and outputs and random cotangents of the outputs."""
    init, mats, nodes, eps = _problem(shape, seed, device)
    B = shape["B"]
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype,
                                device=device)
    fin = estep.filter_inputs(init, mats, nodes)
    J, h, ln = estep.filter_fwd_plain(*fin)
    filt = (*fin, J, h, cot(J), cot(h), cot(ln))
    Jf = torch.cat([fin[0][None, :, :B], J[:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], h[:, :, :B]])
    sin, _ = estep.sampler_inputs(mats, Jf, hf, eps)
    x = estep.sampler_fwd_plain(*sin)
    return filt, (*sin, x, cot(x))


def check_adjoints(shape, seed=0, device="cuda"):
    """Both adjoint kernels (float32) against their plain adjoints
    (float64) on the same inputs and cotangents at ``shape``; raises past
    TOL_ADJ_REL. Returns ``{name: (normwise rel, max abs)}``."""
    filt, samp = adjoint_problem(shape, seed, device)
    errs = {}
    got = estep.filter_adj(*_f32(filt))
    torch.cuda.synchronize()
    errs["filter_adj"] = _rel_err(got, estep.filter_adj_plain(*filt))
    got = estep.sampler_adj(*_f32(samp))
    torch.cuda.synchronize()
    errs["sampler_adj"] = _rel_err(got, estep.sampler_adj_plain(*samp))
    if not all(rel <= TOL_ADJ_REL for rel, _ in errs.values()):
        raise AssertionError(f"an adjoint kernel disagrees with its plain "
                             f"version at {shape}: {errs}")
    return errs


def bpairs_problem(shape, seed=0, device="cuda"):
    """float64 inputs of the four bpairs kernels at ``shape``, a ragged
    batch with lengths spread over [2, T]: the bidirectional filter's
    packed inputs, its twin's outputs J, h and random cotangents of J, h,
    ln; the sampler's inputs on the twin's forward messages, its twin's
    output and a random cotangent; and the twin's ln."""
    init, mats, nodes, eps = _problem(shape, seed, device)
    lengths = torch.linspace(2, shape["T"], shape["B"]).round().long().to(
        device)
    jd, h, _ = lds._prepare(nodes, None, lengths, False)
    pairs, bnodes = lds._ragged_chain(mats, (jd, h), lengths)
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype,
                                device=device)
    fin = bpairs.bidir_inputs(init, pairs, bnodes)
    J, h, ln = bpairs.bidir_fwd_plain(*fin)
    filt = (*fin, J, h, cot(J), cot(h), cot(ln))
    Jf, hf = bpairs.messages(fin, J, h)[:2]
    sin, _ = bpairs.sampler_inputs(pairs, Jf, hf, eps)
    x = bpairs.sampler_bp_fwd_plain(*sin)
    return filt, (*sin, x, cot(x)), ln


def check_bpairs(shape, seed=0, device="cuda"):
    """The four bpairs kernels (float32) against their plain versions
    (float64) on the same inputs and cotangents at ``shape``; raises past
    the forward tiers and TOL_ADJ_REL. Returns the
    forward kernels' max abs errors and the log-normalizer's rel error,
    and the adjoints' ``(normwise rel, max abs)``."""
    filt, samp, lnp = bpairs_problem(shape, seed, device)
    J, h, ln = bpairs.bidir_fwd(*_f32(filt[:8]))
    x = bpairs.sampler_bp_fwd(*_f32(samp[:6]))
    torch.cuda.synchronize()
    errs = {"bidir_fwd": _max_err((J, h), filt[8:10]),
            "bidir_ln_rel": abs(float(ln.double().sum() - lnp.sum()))
            / abs(float(lnp.sum())),
            "sampler_bp_fwd": _max_err((x,), samp[6:7])}
    got = bpairs.bidir_adj(*_f32(filt))
    torch.cuda.synchronize()
    errs["bidir_adj"] = _rel_err(got, bpairs.bidir_adj_plain(*filt))
    got = bpairs.sampler_bp_adj(*_f32(samp))
    torch.cuda.synchronize()
    errs["sampler_bp_adj"] = _rel_err(got, bpairs.sampler_bp_adj_plain(*samp))
    ok = (errs["bidir_fwd"] <= TOL_ABS and errs["bidir_ln_rel"] <= TOL_LOGZ_REL
          and errs["sampler_bp_fwd"] <= TOL_ABS
          and errs["bidir_adj"][0] <= TOL_ADJ_REL
          and errs["sampler_bp_adj"][0] <= TOL_ADJ_REL)
    if not ok:
        raise AssertionError(f"a bpairs kernel disagrees with its plain "
                             f"version at {shape}: {errs}")
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
    with torch.no_grad():
        values = [objective(glob, (rec, dec), batch, gen)
                  for batch in batches]
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
    with torch.no_grad():
        val, (stats, _) = obj(glob, (rec, dec), batches[0], gen)
    cpu64 = lambda t: t.detach().double().cpu()
    run64 = functools.partial(lds.run_inference, eps=cpu64(eps))
    obj64 = elbo.make_objective(run64, recognition.mlp_recognize,
                                decoders.mlp_loglike, tree_map(cpu64, prior),
                                N, num_samples=S)
    nets64 = tuple(copy.deepcopy(m).double().cpu() for m in (rec, dec))
    with torch.no_grad():
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


WRAPPERS = (estep.filter_fwd, estep.filter_adj, estep.sampler_fwd,
            estep.sampler_adj)
PLAINS = (estep.filter_fwd_plain, estep.filter_adj_plain,
          estep.sampler_fwd_plain, estep.sampler_adj_plain)
RAGGED_WRAPPERS = (bpairs.bidir_fwd, bpairs.bidir_adj, bpairs.sampler_bp_fwd,
                   bpairs.sampler_bp_adj)
RAGGED_PLAINS = (bpairs.bidir_fwd_plain, bpairs.bidir_adj_plain,
                 bpairs.sampler_bp_fwd_plain, bpairs.sampler_bp_adj_plain)
TRAIN_K = 8


def _reset_counters():
    for w in WRAPPERS + RAGGED_WRAPPERS:
        w.launches = 0
    for p in PLAINS + RAGGED_PLAINS:
        p.calls = 0


def _train_parts(prior, N, S=2, **kw):
    return (lds.run_inference, recognition.mlp_recognize,
            decoders.mlp_loglike, prior, N), dict(num_samples=S, **kw)


def _normwise(a, b):
    a = torch.cat([x.detach().double().cpu().reshape(-1) for x in a])
    b = torch.cat([x.reshape(-1) for x in b])
    return float((a - b).norm() / b.norm())


def train_path(device="cuda", B=64, T=100):
    """Phase 4b: drive the config-2 training path; returns the launch
    counts of its run."""
    S, d_obs = 2, 20
    N = 50 * B
    data = make_dot_data(seed=1, num_seqs=TRAIN_K * B, T=T,
                         image_width=d_obs)
    batches = torch.from_numpy(data).to(device).reshape(TRAIN_K, B, T, d_obs)
    prior, glob, rec, dec = _config2_models(device)
    before = [p.detach().clone() for net in (rec, dec)
              for p in net.parameters()]
    args, kw = _train_parts(prior, N, S)
    opt_init, fused = loop.make_fused_train_step(
        *args, k_steps=TRAIN_K, stacked_batch=True, **kw)
    _, step = loop.make_train_step(*args, **kw)
    state = opt_init(glob, (rec, dec))
    gen = torch.Generator(device=device).manual_seed(3)
    fired = []

    _reset_counters()
    pgm, nets, state, _, terms, elbos = fused(glob, (rec, dec), state,
                                              batches, gen)
    pgm, nets, state, history, gen = loop.run(
        step, pgm, nets, state, batches[:4].reshape(4 * B, T, d_obs), gen,
        num_epochs=1, batch_size=B, callback_every=2,
        callback=lambda i, e, *_: fired.append((i, e)))
    torch.cuda.synchronize()
    steps = TRAIN_K + 4
    launches = {w.__name__: w.launches for w in WRAPPERS}
    plain_calls = {p.__name__: p.calls for p in PLAINS + RAGGED_PLAINS}

    print(f"train path ({steps} steps): launches {launches}, plain calls "
          f"{plain_calls}")
    if any(n < steps for n in launches.values()):
        raise AssertionError(f"a step missed a kernel: {launches}")
    if any(plain_calls.values()):
        raise AssertionError("the train path called a plain version")
    elbos = elbos.tolist() + history
    if not all(np.isfinite(elbos)) or len(elbos) != steps:
        raise AssertionError(f"train path: bad ELBO history {elbos}")
    if [i for i, _ in fired] != [1, 3]:
        raise AssertionError(f"run's callbacks fired at {fired}")
    after = [p.detach() for net in nets for p in net.parameters()]
    net_moved = min(float((a - b).abs().max())
                    for a, b in zip(after, before))
    pgm_moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(pgm), tree_leaves(glob)))
    print(f"train path: elbo/N {' '.join(f'{e:.4f}' for e in elbos)}; "
          f"terms {({k: round(float(v), 4) for k, v in terms.items()})}; "
          f"least net change {net_moved:.3e}, pgm change {pgm_moved:.3e}")
    if not (net_moved > 0.0 and pgm_moved > 0.0):
        raise AssertionError("training left a parameter unchanged")

    # one step's gradients against the float64 twin path on the CPU
    eps = torch.randn((S, B, T, 10), generator=gen, device=device)
    cpu64 = lambda t: t.detach().double().cpu()
    grad = elbo.make_gradfun(functools.partial(lds.run_inference, eps=eps),
                             *args[1:], **kw)
    val, nat, grads, terms = grad(pgm, nets, batches[0], gen)
    grad64 = elbo.make_gradfun(
        functools.partial(lds.run_inference, eps=cpu64(eps)), *args[1:-2],
        tree_map(cpu64, prior), N, **kw)
    nets64 = tuple(copy.deepcopy(m).double().cpu() for m in nets)
    val64, nat64, grads64, terms64 = grad64(tree_map(cpu64, pgm), nets64,
                                            cpu64(batches[0]), None)
    rel = abs(float(val) - float(val64)) / abs(float(val64))
    nat_rel = _normwise(tree_leaves(nat), tree_leaves(nat64))
    grad_rel = [_normwise(g, g64) for g, g64 in zip(grads, grads64)]
    print(f"train step vs float64 CPU twin path: elbo rel {rel:.3e}, "
          f"natgrad rel {nat_rel:.3e}, recognizer grad rel "
          f"{grad_rel[0]:.3e}, decoder grad rel {grad_rel[1]:.3e}, "
          f"net_grad_norm {float(terms['net_grad_norm']):.6f} vs "
          f"{float(terms64['net_grad_norm']):.6f}")
    if not (rel <= TOL_LOGZ_REL and nat_rel <= TOL_ADJ_REL
            and max(grad_rel) <= TOL_ADJ_REL):
        raise AssertionError("the train step disagrees with the f64 "
                             "reference")
    return launches


def ragged_corpus(seed=0):
    """benchmarks/ragged_throughput.py's corpus: N float32 (T_i, d_obs)
    sequences with T_i uniform in [T_min, T_max]."""
    c = RAGGED_CORPUS
    rng = np.random.RandomState(seed)
    return [rng.randn(int(rng.randint(c["T_min"], c["T_max"] + 1)),
                      c["d_obs"]).astype(np.float32) for _ in range(c["N"])]


def _ragged_epoch(seqs, B, pad, device=None):
    """The loader's epoch-0 batches (seed 1), on ``device`` if given."""
    out = data_loader.ragged_epoch_batches(seqs, B, seed=1, pad_multiple=pad,
                                           drop_remainder=True)
    if device is None:
        return list(out)
    return [tuple(torch.from_numpy(a).to(device) for a in b) for b in out]


def _ragged_step_vs_f64(pgm, nets, frames, lengths, gen, args, kw, d):
    """One ragged ``make_gradfun`` step on the card against the float64
    twin path on the CPU under the same noise; raises past the tiers."""
    B, T = frames.shape[:2]
    prior, N = args[-2:]
    eps = torch.randn((1, B, T, d), generator=gen, device=frames.device)
    cpu64 = lambda t: t.detach().double().cpu()
    grad = elbo.make_gradfun(functools.partial(lds.run_inference, eps=eps),
                             *args[1:], **kw)
    val, nat, grads, _ = grad(pgm, nets, (frames, lengths), gen)
    grad64 = elbo.make_gradfun(
        functools.partial(lds.run_inference, eps=cpu64(eps)), *args[1:-2],
        tree_map(cpu64, prior), N, **kw)
    nets64 = tuple(copy.deepcopy(m).double().cpu() for m in nets)
    val64, nat64, grads64, _ = grad64(tree_map(cpu64, pgm), nets64,
                                      (cpu64(frames), lengths.cpu()), None)
    rel = abs(float(val) - float(val64)) / abs(float(val64))
    nat_rel = _normwise(tree_leaves(nat), tree_leaves(nat64))
    grad_rel = [_normwise(g, g64) for g, g64 in zip(grads, grads64)]
    print(f"ragged step (T={T}) vs float64 CPU twin path: elbo rel "
          f"{rel:.3e}, natgrad rel {nat_rel:.3e}, recognizer grad rel "
          f"{grad_rel[0]:.3e}, decoder grad rel {grad_rel[1]:.3e}")
    if not (rel <= TOL_LOGZ_REL and nat_rel <= TOL_ADJ_REL
            and max(grad_rel) <= TOL_ADJ_REL):
        raise AssertionError(f"the ragged step at T={T} disagrees with the "
                             f"f64 reference")


def ragged_path(device="cuda", seqs=None, B=RAGGED_B, pad=RAGGED_PAD):
    """Phase 4c: one epoch of ragged training through the loader and
    ``run_loader``, one step against the float64 CPU path, and
    ``posterior_moments(lengths=)``; returns the launch counts of the
    epoch."""
    seqs = ragged_corpus() if seqs is None else seqs
    N, d = len(seqs), 10
    prior, glob, rec, dec = _config2_models(device)
    args, kw = _train_parts(prior, N, S=1, ragged=True)
    opt_init, step = loop.make_train_step(*args, **kw)
    loader = data_loader.make_loader(seqs, B, seed=1, pad_multiple=pad,
                                     drop_remainder=True, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    fired = []

    _reset_counters()
    pgm, nets, _, history, gen = loop.run_loader(
        step, glob, (rec, dec), opt_init(glob, (rec, dec)), loader, gen,
        num_epochs=1, callback_every=4,
        callback=lambda i, e, *_: fired.append(i))
    torch.cuda.synchronize()
    steps = N // B
    launches = {w.__name__: w.launches for w in RAGGED_WRAPPERS}
    stationary = {w.__name__: w.launches for w in WRAPPERS}
    plain_calls = {p.__name__: p.calls for p in PLAINS + RAGGED_PLAINS}
    epoch = _ragged_epoch(seqs, B, pad)
    print(f"ragged path ({steps} steps, padded T "
          f"{[b[0].shape[1] for b in epoch]}): launches {launches}, "
          f"stationary kernels {stationary}, plain calls {plain_calls}")
    if any(n != steps for n in launches.values()):
        raise AssertionError(f"a ragged step missed a kernel: {launches}")
    if any(stationary.values()):
        raise AssertionError("the ragged path launched a stationary kernel")
    if any(plain_calls.values()):
        raise AssertionError("the ragged path called a plain version")
    if len(history) != steps or not np.isfinite(history).all():
        raise AssertionError(f"ragged path: bad ELBO history {history}")
    if fired != [i - 1 for i in range(1, steps + 1) if i % 4 == 0]:
        raise AssertionError(f"run_loader's callbacks fired at {fired}")
    print(f"ragged path: elbo/N {' '.join(f'{e:.4f}' for e in history)}")

    # one step at the T=128 bucket (else the shortest) and one at the
    # longest against the float64 twin path on the CPU, same noise
    short = min(epoch, key=lambda b: (b[0].shape[1] != 128, b[0].shape[1]))
    longest = max(epoch, key=lambda b: b[0].shape[1])
    for batch in (longest, short):
        frames, lengths = (torch.from_numpy(a).to(device) for a in batch)
        _ragged_step_vs_f64(pgm, nets, frames, lengths, gen, args, kw, d)
    T = frames.shape[1]

    with torch.no_grad():
        moments = lds.posterior_moments(pgm, nets[0](frames), lengths=lengths)
    _finite(moments, "posterior_moments(lengths=)")
    Ex, ExxT, Exnxt, logZ = moments
    if (Ex.shape != (B, T, d) or ExxT.shape != (B, T, d, d)
            or Exnxt.shape != (B, T - 1, d, d) or logZ.shape != (B,)):
        raise AssertionError("posterior_moments(lengths=): wrong shapes")
    cov = ExxT.double() - Ex.double()[..., :, None] * Ex.double()[..., None, :]
    if int((torch.linalg.cholesky_ex(cov).info != 0).sum()):
        raise AssertionError("a smoothed covariance is not positive definite")
    print(f"posterior_moments(lengths=) at T={T}: logZ mean "
          f"{float(logZ.mean()):.4f}")
    return launches


def padded_theorem(device="cuda", lengths=(61, 128), seed=6):
    """Phase 4c: a padded ragged batch of two sequences (bpairs kernels)
    against each sequence alone (stationary kernels), float32 on the card:
    the summed statistics and local KL agree within TOL_PAD_REL. Returns
    the worst stats error (relative to each leaf's largest entry) and the
    local KL's relative error."""
    d, T = 10, max(lengths)
    g = torch.Generator().manual_seed(seed)
    glob = lds.init_pgm_param(d, g, device=device)
    jd = (torch.logaddexp(torch.randn((2, T, d), generator=g),
                          torch.zeros(())) + 0.5).to(device)
    h = torch.randn((2, T, d), generator=g).to(device)  # pads: garbage
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        alone = [lds.run_inference(glob, glob, (jd[i:i + 1, :n],
                                                h[i:i + 1, :n]), gen, 1)
                 for i, n in enumerate(lengths)]
        _, stats, _, lkl = lds.run_inference(
            glob, glob, (jd, h), gen, 1,
            lengths=torch.tensor(lengths, device=device))
    ref = [a + b for a, b in zip(tree_leaves(alone[0][1]),
                                 tree_leaves(alone[1][1]))]
    stat_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(tree_leaves(stats), ref))
    kl_ref = alone[0][3] + alone[1][3]
    kl_rel = abs(float(lkl - kl_ref)) / abs(float(kl_ref))
    print(f"padded-batch theorem (lengths {lengths}, padded to {T}): stats "
          f"rel {stat_rel:.3e}, local KL rel {kl_rel:.3e}")
    if not (stat_rel <= TOL_PAD_REL and kl_rel <= TOL_PAD_REL):
        raise AssertionError("a padded batch disagrees with its sequences")
    return stat_rel, kl_rel


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

    # the adjoints, on float32 copies of the float64 check inputs
    filt, samp = (_f32(a) for a in adjoint_problem(shape, 0, device))
    t["filter_adj"] = _time_ms(lambda: estep.filter_adj(*filt))
    t["filter_adj_plain"] = _time_ms(lambda: estep.filter_adj_plain(*filt))
    t["sampler_adj"] = _time_ms(lambda: estep.sampler_adj(*samp))
    t["sampler_adj_plain"] = _time_ms(lambda: estep.sampler_adj_plain(
        *samp))

    # one train step, and the fused 8-step call on 8 minibatches
    prior, glob, rec, dec = _config2_models(device)
    data = make_dot_data(seed=2, num_seqs=TRAIN_K * B, T=shape["T"],
                         image_width=20)
    batches = torch.from_numpy(data).to(device).reshape(
        TRAIN_K, B, shape["T"], 20)
    args, kw = _train_parts(prior, 50 * B, S)
    opt_init, step = loop.make_train_step(*args, **kw)
    _, fused = loop.make_fused_train_step(*args, k_steps=TRAIN_K,
                                          stacked_batch=True, **kw)
    st = [glob, (rec, dec), opt_init(glob, (rec, dec))]

    def one_step():
        st[0], st[1], st[2], _, _ = step(*st, batches[0], gen)

    def fused_steps():
        st[0], st[1], st[2], *_ = fused(*st, batches, gen)

    t["train_step"] = _time_ms(one_step)
    t["train_fused8"] = _time_ms(fused_steps)
    seqs = {"estep_kernels": B, "estep_twins": B, "run_inference": B,
            "train_step": B, "train_fused8": TRAIN_K * B}
    for k, ms in t.items():
        print(f"time {k}: {ms:.4f} ms"
              + (f" = {seqs[k] / ms * 1e3:.1f} seqs/s" if k in seqs else ""))
    return t


def ragged_timings(device="cuda", seqs=None, B=RAGGED_B, pad=RAGGED_PAD):
    """Phase 5, ragged path: the bpairs kernels at B=64, T=128 and at
    T=512, their plain versions at T=128, one ragged train step per length
    bucket (CUDA events), and the wall time of a bucketed epoch against
    the same corpus padded to T_max (host clock around each epoch, which
    ends in a sync; one untimed epoch of each, then three of each in
    turns)."""
    t = {}
    for tag, shape in (("", RAGGED_SHAPES["ragged"]), ("_T512", RAGGED_LONG)):
        filt, samp, _ = bpairs_problem(shape, 0, device)
        filt, samp = _f32(filt), _f32(samp)
        t["bidir_fwd" + tag] = _time_ms(lambda: bpairs.bidir_fwd(*filt[:8]))
        t["bidir_adj" + tag] = _time_ms(lambda: bpairs.bidir_adj(*filt))
        t["sampler_bp_fwd" + tag] = _time_ms(
            lambda: bpairs.sampler_bp_fwd(*samp[:6]))
        t["sampler_bp_adj" + tag] = _time_ms(
            lambda: bpairs.sampler_bp_adj(*samp))
        if not tag:
            t["bidir_fwd_plain"] = _time_ms(
                lambda: bpairs.bidir_fwd_plain(*filt[:8]), runs=10)
            t["bidir_adj_plain"] = _time_ms(
                lambda: bpairs.bidir_adj_plain(*filt), runs=10)
            t["sampler_bp_fwd_plain"] = _time_ms(
                lambda: bpairs.sampler_bp_fwd_plain(*samp[:6]), runs=10)
            t["sampler_bp_adj_plain"] = _time_ms(
                lambda: bpairs.sampler_bp_adj_plain(*samp), runs=10)

    seqs = ragged_corpus() if seqs is None else seqs
    prior, glob, rec, dec = _config2_models(device)
    args, kw = _train_parts(prior, len(seqs), S=1, ragged=True)
    opt_init, step = loop.make_train_step(*args, **kw)
    st = [glob, (rec, dec), opt_init(glob, (rec, dec))]
    gen = torch.Generator(device=device).manual_seed(6)
    buckets = {}
    for b in _ragged_epoch(seqs, B, pad, device):
        buckets.setdefault(b[0].shape[1], b)
    seqs_per_s = {}
    for T in sorted(buckets):
        def one_step(batch=buckets[T]):
            st[0], st[1], st[2], _, _ = step(*st, batch, gen)
        t[f"ragged_step_T{T}"] = _time_ms(one_step, runs=10)
        seqs_per_s[f"ragged_step_T{T}"] = B

    walls = {RAGGED_PAD: [], RAGGED_CORPUS["T_max"]: []}
    # one untimed epoch of each, then three of each in turns
    order = [RAGGED_PAD, RAGGED_CORPUS["T_max"]] * 2 + \
        [RAGGED_CORPUS["T_max"], RAGGED_PAD] * 2
    for i, pm in enumerate(order):
        loader = data_loader.make_loader(seqs, B, seed=1, pad_multiple=pm,
                                         drop_remainder=True, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st[0], st[1], st[2], _, _ = loop.run_loader(step, *st, loader, gen,
                                                    num_epochs=1)
        torch.cuda.synchronize()
        if i >= 2:
            walls[pm].append((time.perf_counter() - t0) * 1e3)
    t["ragged_epoch_bucketed_wall"] = float(np.median(walls[RAGGED_PAD]))
    t["ragged_epoch_pad512_wall"] = float(np.median(
        walls[RAGGED_CORPUS["T_max"]]))
    epoch_seqs = len(seqs) // B * B
    seqs_per_s.update({"ragged_epoch_bucketed_wall": epoch_seqs,
                       "ragged_epoch_pad512_wall": epoch_seqs})
    for k, ms in t.items():
        print(f"time {k}: {ms:.4f} ms"
              + (f" = {seqs_per_s[k] / ms * 1e3:.1f} seqs/s"
                 if k in seqs_per_s else ""))
    print(f"ragged epoch walls (ms): bucketed {walls[RAGGED_PAD]}, padded "
          f"to {RAGGED_CORPUS['T_max']} {walls[RAGGED_CORPUS['T_max']]}")
    return t


def bound(name, B, T, d, S):
    """The least time (ms) the card could take for one call of kernel
    ``name`` at this shape, and what sets it: the larger of its bytes
    (each input the function needs read once, each output it returns
    written once; not the kernels' per-lane or per-direction partials,
    which their wrappers sum) over the HBM rate and its float32 operations
    over the peak rate. A symmetric input (J0, A, C, P3, the filtered J
    and Jf) counts its lower triangle, tri = d(d+1)/2 floats, which is all
    the function needs of it; an output counts in full, as returned.
    Operations count 2 per multiply-add of the kernel's per-step algebra
    (csrc/*.cu), times the T-1 steps of every chain; the chains run no
    early exit."""
    dd, T1, NL, SB = d * d, T - 1, 2 * B, S * B
    tri = d * (d + 1) // 2
    if name == "filter_fwd":
        chains = NL
        # chol d^3/3, z d^2, Y = L^-1 D^T d^3, J' d^2 (d+1), h' 2 d^2
        step = d ** 3 / 3 + d ** 3 + d * d * (d + 1) + 3 * d * d
        # in: J0, h0, A, C, D of both directions, jd, n2; out: J, h, ln
        floats = (tri + d) * NL + 2 * (2 * tri + dd) + 2 * T * d * B + \
            T1 * (dd + d) * NL + NL
    elif name == "filter_adj":
        chains = NL
        # chol, z, Y as forward; Gs Y^T 2 d^3; Y g 2 d^2; Z d^2 (d+1);
        # R = L^-T Z d^3; lower M-bar d^3 / 3; hbar d^2; the parameter
        # sums: d solves for dD d^3, the rest 5 d^2
        step = (d ** 3 / 3 + d * d + d ** 3 + 2 * d ** 3 + 2 * d * d
                + d * d * (d + 1) + d ** 3 + d ** 3 / 3 + d * d
                + d ** 3 + 5 * d * d)
        # in: J0, h0, A, D (C is not read), jd, n2, the forward's J, h as
        # the pre-step messages of steps 1..T-2, their cotangents, dln;
        # out: dJ0, dh0, dA, dC, dD, djd, dn2
        floats = ((tri + d) * NL + 2 * (tri + dd) + 2 * T * d * B
                  + (T1 - 1) * (tri + d) * NL + T1 * (dd + d) * NL + NL
                  + (dd + d) * NL + 6 * dd + 2 * T * d * B)
    elif name == "sampler_fwd":
        chains = SB
        # chol d^3/3, P2^T x 2 d^2, two solves 2 d^2
        step = d ** 3 / 3 + 4 * d * d
        # in: P2, P3, Jf, hf, eps, xT; out: x
        floats = dd + tri + T1 * (tri + d) * B + T1 * d * SB + d * SB + \
            T1 * d * SB
    elif name == "sampler_adj":
        chains = SB
        # chol; b 2 d^2; four solves 4 d^2; R = L^-T P d^3; S = R L^-1 d^3;
        # dJc 4 d^2; dP2 and P2 bbar 4 d^2
        step = d ** 3 / 3 + 2 * d ** 3 + 14 * d * d
        # in: P2, P3, Jf, hf, xT, x (steps 1..T-2), dx (not the noise: x
        # determines it); out: dP2, dP3, dJf, dhf (summed over the
        # samples), dxT
        floats = (dd + tri + 2 * dd + T1 * (tri + d) * B
                  + T1 * (dd + d) * B + (2 * T1 - 1) * d * SB + 2 * d * SB)
    elif name == "bidir_fwd":
        chains = NL
        step = d ** 3 / 3 + d ** 3 + d * d * (d + 1) + 3 * d * d
        # in: J0, h0, the A, C, D, e, f, pc streams; out: J, h, ln
        floats = ((tri + d) * NL + T1 * (2 * tri + dd + 2 * d + 1) * NL
                  + T1 * (dd + d) * NL + NL)
    elif name == "bidir_adj":
        chains = NL
        # chol, z, Y as forward; G and Gs 2 d^2; Gs Y^T 2 d^3; Y g 2 d^2;
        # Z d^2 (d+1); dD d solves d^3; R = L^-T Z d^3; lower M-bar d^3/3;
        # hbar d^2
        step = (d ** 3 / 3 + d * d + d ** 3 + 2 * d * d + 2 * d ** 3
                + 2 * d * d + d * d * (d + 1) + d ** 3 + d ** 3
                + d ** 3 / 3 + d * d)
        # in: J0, h0, A, D, f (C, e, pc are not read), the forward's J, h
        # as the pre-step messages of steps 1..T-2, their cotangents, dln;
        # out: dJ0, dh0, dA, dC, dD, de, df, dpc
        floats = ((tri + d) * NL + T1 * (tri + dd + d) * NL
                  + (T1 - 1) * (tri + d) * NL + T1 * (dd + d) * NL + NL
                  + (dd + d) * NL + T1 * (3 * dd + 2 * d + 1) * NL)
    elif name == "sampler_bp_fwd":
        chains = SB
        step = d ** 3 / 3 + 4 * d * d
        # in: P2, P3, Jf, hf per sequence, eps, xT; out: x
        floats = T1 * (dd + 2 * tri + d) * B + 2 * T1 * d * SB + d * SB
    elif name == "sampler_bp_adj":
        chains = SB
        step = d ** 3 / 3 + 2 * d ** 3 + 14 * d * d
        # in: P2, P3, Jf, hf, xT, x (steps 1..T-2), dx (not the noise: x
        # determines it); out: dP2, dP3, dJf, dhf (summed over the
        # samples), dxT
        floats = (T1 * (dd + 2 * tri + d) * B + T1 * (3 * dd + d) * B
                  + (2 * T1 - 1) * d * SB + 2 * d * SB)
    else:
        raise KeyError(name)
    flop_ms = chains * T1 * step / PEAK_F32_FLOPS * 1e3
    byte_ms = 4 * floats / PEAK_BYTES * 1e3
    return (max(flop_ms, byte_ms),
            "operations" if flop_ms > byte_ms else "bytes")


def report_build(so):
    """Per-source compile seconds and, per kernel and latent size, the
    registers and spill bytes ptxas reported."""
    with open(so + ".log") as f:
        log = f.read()
    for src, secs in re.findall(r"== (\S+): ([\d.]+) s", log):
        print(f"  nvcc {src}: {secs} s")
    name = None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)ILi(\d+)E", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas {name}: {m.group(1)} registers, {spill} bytes "
                  f"spill stores")
            name = None


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
    report_build(so)

    errs = {}
    for name, shape in SHAPES.items():
        e = check_kernels(shape)
        print(f"kernels vs twins [{name} {shape}]: {e}")
        a = check_adjoints(shape)
        print(f"adjoints vs plain adjoints [{name} {shape}] (normwise rel, "
              f"max abs): {a}")
        for k in ("filter_fwd", "sampler_fwd"):
            errs[k] = max(errs.get(k, 0.0), e[k])
        for k in ("filter_adj", "sampler_adj"):
            errs[k] = max(errs.get(k, 0.0), a[k][1])
    for name, shape in {**RAGGED_SHAPES, "T512": RAGGED_LONG}.items():
        e = check_bpairs(shape)
        print(f"bpairs kernels vs plain versions [{name} {shape}, lengths "
              f"over [2, {shape['T']}]] (forward max abs; adjoints normwise "
              f"rel, max abs): {e}")
        for k in ("bidir_fwd", "sampler_bp_fwd"):
            errs[k] = max(errs.get(k, 0.0), e[k])
        for k in ("bidir_adj", "sampler_bp_adj"):
            errs[k] = max(errs.get(k, 0.0), e[k][1])

    main_path()
    launches = train_path()
    launches.update(ragged_path())
    padded_theorem()
    t = timings()
    t.update(ragged_timings())
    print(f"chip_smoke wall since the build began: "
          f"{time.perf_counter() - t0:.1f} s")
    kernels = []
    for k in KERNELS:
        shape = (SHAPES["config2"] if k in [w.__name__ for w in WRAPPERS]
                 else RAGGED_SHAPES["ragged"])
        bound_ms, bound_by = bound(k, shape["B"], shape["T"], shape["d"],
                                   shape["S"])
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": KERNELS[k], "launches": launches[k],
            "max_abs_err": errs[k], "ms": t[k], "plain_ms": t[k + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
