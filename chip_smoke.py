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
   card, at the main-path shape and a small odd one; the forward kernels,
   the forward sampler's passes (``estep.sampler_fwd_factor``,
   ``sampler_fwd_chain``), the adjoints and each of their passes
   (``estep.filter_adj_factor``, ``filter_adj_chain``,
   ``sampler_adj_factor``, ``sampler_adj_chain``, ``sampler_adj_dJc``)
   against its own plain version there and at every built latent size;
   the stiff case (node precisions over [1e-2, 1e3] at config-2 width: each
   forward kernel, the per-sequence sampler and the element scan among
   them, within twice the float32 plain version's error against float64,
   normwise per step and per lane) and a non-SPD step, whose outputs must
   come back non-finite in the lanes it reaches and nowhere else;
4. the inference path at BASELINE config 2 (LDS-SVAE on 1-D dot videos,
   B=64, T=100, d_latent=10, d_obs=20, S=2, MLP recognizer and decoder of
   width 64, random weights from a seed): the MC-ELBO objective on 3
   batches and ``posterior_moments`` on one, with the launch counters
   showing both forward kernels ran there (``sampler_fwd``'s one C call
   launching its two passes) and no plain version; then one batch's ELBO
   against the float64 twin path on the CPU under the same noise;
4b. the training path at config 2: ``make_fused_train_step(k_steps=8,
   stacked_batch=True)`` over 8 distinct minibatches, then 4 steps of
   ``loop.run``, with the launch counters showing all four kernels ran
   every step and no plain version ran; then one step's ELBO, natural
   gradient and net gradients against the float64 twin path on the CPU
   under the same noise;
3r. each per-sequence-pairs ("bpairs") kernel of the ragged path, forward
   and adjoint, in float32 against its plain version in float64 on the
   same inputs (and random cotangents), and each pass of
   ``sampler_bp_fwd`` (``bpairs.sampler_bp_fwd_factor``,
   ``sampler_bp_fwd_chain``), of ``bidir_adj``
   (``bpairs.bidir_adj_factor``, ``bidir_adj_chain``) and of
   ``sampler_bp_adj`` (``bpairs.sampler_bp_adj_factor``,
   ``sampler_bp_adj_chain``, ``sampler_bp_adj_dJc``) against its own,
   at a small odd shape and at a ragged one (B=64, T=128, lengths spread
   over [2, 128]), and at T=512 (lengths over [2, 512]), all under the
   same tiers; ``bidir_fwd``, ``sampler_bp_fwd``, ``bidir_adj`` and their
   passes also at the slds_synth x-step's lanes (B=16, T=80, d=4; the
   sampler's 32 lanes, S=2) and (the filters) over one direction's
   lanes of B=8, T=2048, and ``bidir_fwd`` with C's upper triangle
   perturbed and with one lane's step made indefinite (its J, h and ln
   non-finite from there, every other lane finite);
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
3h. each HMM forward-backward kernel (``ops/hmm_fb.py``: streamed and
   stationary, forward and adjoint), each pass of the streamed adjoint
   (``hmm_fb.hmm_fb_adj_weights``, ``hmm_fb_adj_chain``,
   ``hmm_fb_adj_dM``) and of the stationary one
   (``hmm_fb.hmm_fb_stat_adj_weights``, whose weights must equal the
   streamed pass's on LT + lo bit for bit, ``hmm_fb_adj_chain``,
   ``hmm_fb_stat_adj_sums``) in float32 against its plain version
   in float64 on the same inputs and random cotangents, the stationary
   forward's messages bit for bit against the streamed kernel's on
   LT + lo, and ``hmm_posterior`` on the card against the float64 CPU
   path: at a small odd shape, at the slds_synth sweep shape (B=16, T=80,
   K=4; stationary, time-varying with ragged pair weights, and a forced
   near-forbidden switch), at bench.py measure_hmm's (B=128, T=100, K=8)
   and at every built K, 1 to 32 (B=37, T=9: a partial last warp); then
   ``hmm_posterior(kernel="stationary")`` with its gradient, the path that
   runs the stationary kernels, against float64, and its outputs bit for
   bit against ``kernel="streamed"``; then the four kernels at
   measure_hmm's B and T with K=16 and K=32 against their plain versions,
   with their event, device and plain ms and bounds;
4s. SLDS-SVAE training at the slds_synth preset (svae_tpu/config.py
   SLDSConfig, examples/slds_synth.py: ``make_switching_dot_data`` with
   N=256, T=80, 16-pixel frames, K=4, d_latent=4, MLP width 64, 12
   mean-field sweeps, S=2, B=16, Adam at 1e-3, natural-gradient step 0.5;
   random weights from a seed): one epoch of 16 steps through ``loop.run``
   with the launch counters showing each step's schedule (13 launches of
   the bpairs filter and of the HMM pass, 2 of each adjoint, one sampler
   and its adjoint) and nothing else; ``most_likely_states`` on 8
   sequences (segmentation purity printed, not gated); one step and one
   ragged step against the float64 CPU path; the SLDS padded-batch theorem
   on the card;
5. CUDA-event timings (median of 25 runs, 10 for the plain versions at
   T=128) of each kernel and its plain version (the forward sampler's and
   the adjoints' passes too, and the forward kernels' and the adjoints'
   device time by kernel under torch.profiler), of the E-step on the
   kernel path and on the twin path, of one train step and of the fused
   8-step call; of the bpairs kernels at B=64, T=128 and T=512, of one
   ragged train step per length bucket, and of the bucketed epoch against
   the same corpus padded to T=512; of the HMM kernels and their plain
   versions at the slds_synth and measure_hmm shapes (device time too,
   and the streamed adjoint's passes alone and within the whole), of
   ``slds.run_inference`` at bench.py measure_slds's shape (B=16, T=50,
   K=4, d=3, 10 sweeps, S=2) on the kernels and on the twins, of one
   slds_synth train step and of its epoch (host clock); of the two
   chain-element scan kernels and their plain versions, of one chunked
   (``parallel=8``) config-2 train step against the sequential one, and of
   ``posterior_moments(parallel=C)`` at bench_longT's shape against
   ``parallel=False``; the passes of ``sampler_bp_fwd``,
   ``elem_scan_adj``, ``bidir_adj``, ``sampler_bp_adj``,
   ``hmm_fb_stat_adj`` and ``sampler_shared`` alone, and
   each one's device time within the whole; ``elem_scan``'s device time at
   its three shapes; ``bidir_fwd``'s, ``sampler_bp_fwd``'s and
   ``sampler_bp_adj``'s device time at the
   ragged shapes, the slds_synth x-step's and (``bidir_fwd``) over one
   direction's lanes at T=2048;
3c. the chain-element scan kernel of the chunked parallel-in-time E-step
   (``ops/chunked.py``) in float32 against its plain version in float64
   on the same leaves, its adjoint against the float64 plain adjoint
   under random cotangents and each pass of the adjoint
   (``chunked.elem_scan_adj_factor``, ``elem_scan_adj_chain``) against
   its own plain version, normwise per element field: at a small odd
   shape (d=3, 5 lanes of 4 steps), at the config-2 fold (B=64, T=100,
   C=8: 512 lanes of 13 steps), at the long-T fold (B=8, T=2048, C=64:
   512 lanes of 32 steps) and at the config-2 chunk totals' shape (64
   lanes of 8 steps);
4p. the chunked E-step in training: 8 config-2 steps through ``loop.run``
   with ``run_inference(parallel=8)`` (pallas_chunked's default chunk
   count), the launch counters showing 4 launches of the scan kernel and 4
   of its adjoint a step and nothing else; one step against the float64
   CPU path; then ``posterior_moments(parallel=C)`` at bench_longT's shape
   (B=8, d=10, T=512 and 2048, C in {32, 64, 128} with 2C <= T) against
   float64, with the float32 plain path's error beside the kernels' (no
   float32 tier is stated past T=100: the kernels' error may be at most
   twice the plain path's), and against ``parallel=False``;
3k. the three forward-only shared-pair kernels (``ops/kalman_fwd.py``:
   the forward and backward information filters and the sampler, reading
   each step's pair row once for the batch) and each pass of the sampler
   (``kalman_fwd.sampler_shared_factor``, ``bpairs.sampler_bp_fwd_chain``)
   in float32 against their plain versions in float64 on the same inputs,
   at a small odd shape, at config-2 width (B=64, T=100, d=10, S=2) and at
   B=8, T=2048, the config-2 expected pairs varied in time by a seeded
   factor; the two filters also at B=37, at T=2 at every built d and with
   the pair and node blocks' upper triangles perturbed (phase 3 holds the
   three in the stiff and non-SPD cases);
4k. each entry point of ``ops/kalman_fwd.py`` at config-2 width, the
   counters set to 0 before it and read after it: ``lds_estep`` launches
   each of the three kernels once, ``lds_filter_bpairs`` the bpairs
   filter once, and no plain version runs; ``lds_estep`` against
   ``bpairs.lds_estep`` on the same chain and noise and against float64;
   then ``bpairs.lds_filter`` and ``bpairs.lds_backward`` (the bpairs
   filter and its adjoint over one direction's B lanes), values and
   gradients against float64, on per-sequence and shared pairs, one launch
   of each kernel a call; with the timings of phase 5 (the three kernels,
   the one-direction launches and the routes that could have served the
   shared-pair functions, both E-steps, at config-2 width and T=2048);
4g. GMM-SVAE at BASELINE config 1 (bench.py measure_gmm: pinwheel
   N=1000, K=8, d_latent=2, 25 mean-field sweeps, S=2, MLP width 40, full
   batch; random weights from a seed; torch ops, no kernel): the first
   step's ELBO and statistics against the float64 CPU path under the same
   noise, 8 steps of ``loop.run``, one ``make_fused_train_step`` call of 8
   steps and ``classify``, every output finite; the ms of a step (CUDA
   events), its device ms and device ops (torch.profiler), and the fused
   call's;
4f. the forecast and state-sampling APIs, each with the counters set to 0
   before it and read after it: ``lds.predict`` at config 2 (50 steps)
   launches ``filter_fwd`` and ``sampler_fwd`` once each,
   ``slds.sample_states`` at slds_synth (12 sweeps) launches ``bidir_fwd``
   and ``hmm_fb_fwd`` 13 times each and ``slds.predict`` those and
   ``sampler_bp_fwd`` once, and nothing else runs; their window samples
   against the float64 CPU path under the same noise (abs <= 2e-3), the
   discrete paths on >= 99% of entries, the rollouts where the z paths
   agree; the event ms of each call;
4v. the serving path: ``lds.make_online_filter`` at config 2 (the seeded
   globals and MLP recognizer of phase 4, 64 streams of T=100 dot frames)
   a frame at a time in float32, the summed log-evidence against the
   stationary E-step's logZ (kernel #1) within rel 2e-4 and the filtered
   means against float64 ``kalman.lds_filter`` within abs 2e-3;
   ``streaming.make_window_filter`` at W=16 and W=64 bit for bit the
   single frames; ``slds.make_online_filter`` (GPB2) at slds_synth's
   globals on 16 streams of T=80: weights summing to 1 within 1e-6,
   covariances positive definite, the outputs against its float64 CPU run
   within abs 2e-3, and at K=1 against the LDS filter; the event ms of a
   step for 1 and 64 streams, of a frame in windows of 64, a step's
   device ms and ops, and the switching filter's step;
4q. ``slds.run_inference`` at slds_synth (B=16, 12 sweeps, S=2) in
   float32 at ``parallel=True`` and ``parallel=8`` against
   ``parallel=False`` under the same noise (local KL and statistics rel
   <= 2e-4, samples abs <= 2e-3) and one ``make_gradfun`` step each
   (ELBO rel <= 2e-4, natural and net gradients normwise <= 1e-3), the
   counters showing #19 and #20 at ``parallel=8`` and no bpairs or HMM
   kernel on either parallel route; ``most_likely_states(parallel=True)``
   on >= 99% of entries; a train step's event ms, device ms and ops at
   ``parallel=8`` and ``parallel=False``;
4e. the conv-LDS at BASELINE config 4 (the ``conv_lds`` preset of
   ``svae_tpu_torch.config``: N=128, B=8, T=500, d_latent=16, 16x16
   frames, stride-2 convs of (16, 32) channels, decoder width 128, S=2,
   Adam at 1e-3; random weights from the preset's seed) through
   ``examples.conv_lds.main`` and ``train.experiment.run``: one epoch (16
   steps) with a checkpoint directory and a metrics file, the counters
   showing #1-#4 launched once a step at d=16 and nothing else; a 2-epoch
   run preempted after epoch 1 and resumed against the uninterrupted run
   (the largest ELBO gap printed, rel <= 1e-3); one batch's ELBO, natural
   gradient and net gradients on the kernels and on the float32 plain
   path against the float64 CPU path (TF32 off), each held to its T=100
   tier or to twice the float32 plain path's error (the long-T rule); a
   bf16 step's gap to the float32 step; a step's event ms, busy ms,
   device ops and idle share; #1-#4 alone at the config-4 shape (B=8,
   T=500, d=16, S=2), each against float64 beside its float32 plain
   version, with event, device and plain ms and bound (printed as their
   own JSON line before the kernels line); then every example script at
   its ``*_smoke`` preset on the card, its history finite (``bigdata_dp``
   launched as ``python -m``, a process of its own);
4d. BASELINE config 5 (the ``bigdata_dp`` preset: T=50, d_latent=8,
   16-pixel frames, MLP width 64, global batch 256, S=2, Adam at 1e-3),
   every rank a process of its own, spawned and joined with a timeout, so
   that this process never holds a process group: ``examples.bigdata_dp``
   on a one-rank NCCL group, its corpus cut to 20 global batches, the
   counters showing #1-#4 once a step at the d=8 builds and nothing else;
   the first DP step against ``loop.make_train_step`` on the same batch and
   noise; the DP step's and ``make_train_step``'s event ms, device ms and
   device ops, and the one all_reduce's bytes and event ms; then two ranks
   on the one card over gloo: the DP step on the meshes (data=2, mc=1) and
   (data=1, mc=2) against the single-process step on the global batch,
   the replicas' fingerprints equal over both axes, and
   ``lds_smoother_timeshard`` (one sequence, T=512, d=10, float64) against
   ``kalman.lds_smoother`` on the card at rtol 1e-8.

The line before the last is a JSON object with one entry per kernel (the
passes of ``sampler_fwd``, ``sampler_bp_fwd``, ``elem_scan_adj``,
``bidir_adj``, ``sampler_bp_adj``, ``hmm_fb_adj``, ``hmm_fb_stat_adj``
and ``sampler_shared`` too, each with its function's launches, since one
C call launches each pass once; the two chain passes that a second
function shares count the first's;
its launches on the path that runs it: the training paths, phase 3h's
stationary ``hmm_posterior`` for the stationary HMM kernels and phase 4k's
``kalman_fwd.lds_estep`` for the shared-pair kernels; error, times and
bound; the Pallas kernels it replaces, and those whose function it also
serves); the last line is ``{"ok": true, "device": {...}}``. There is
no CPU path.
"""

import contextlib
import copy
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from svae_tpu_torch.config import PRESETS
from svae_tpu_torch.data import loader as data_loader
from svae_tpu_torch.data.synthetic import (make_dot_data, make_pinwheel,
                                           make_switching_dot_data)
from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.models import gmm, lds, slds, streaming
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.ops import (_build, bpairs, chunked, estep, hmm,
                                hmm_fb, kalman, kalman_fwd)
from svae_tpu_torch.examples import conv_lds
from svae_tpu_torch.train import checkpoint as ckpt_lib
from svae_tpu_torch.train import elbo, loop
from svae_tpu_torch.utils.psd import f32_linalg
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
# the stiff case of the forward kernels: node precisions spread over
# [1e-2, 1e3] at config-2 width, where no float32 tier is stated; each
# kernel's error against float64 may be at most STIFF_FACTOR times the
# float32 plain version's on the same device
STIFF_JD = (1e-2, 1e3)
STIFF_FACTOR = 2.0
KERNELS = {
    "filter_fwd": "svae_tpu/ops/pallas_estep.py:63",
    "filter_adj": "svae_tpu/ops/pallas_estep.py:121",
    "sampler_fwd": "svae_tpu/ops/pallas_estep.py:218",
    "sampler_fwd_factor": "svae_tpu/ops/pallas_estep.py:218",
    "sampler_fwd_chain": "svae_tpu/ops/pallas_estep.py:218",
    "sampler_adj": "svae_tpu/ops/pallas_estep.py:252",
    "bidir_fwd": "svae_tpu/ops/pallas_bidir.py:71",
    "bidir_adj": "svae_tpu/ops/pallas_bidir.py:121",
    "bidir_adj_factor": "svae_tpu/ops/pallas_bidir.py:121",
    "bidir_adj_chain": "svae_tpu/ops/pallas_bidir.py:121",
    "sampler_bp_fwd": "svae_tpu/ops/pallas_vjp.py:169",
    "sampler_bp_fwd_factor": "svae_tpu/ops/pallas_vjp.py:169",
    "sampler_bp_fwd_chain": "svae_tpu/ops/pallas_vjp.py:169",
    "sampler_bp_adj": "svae_tpu/ops/pallas_vjp.py:417",
    "sampler_bp_adj_factor": "svae_tpu/ops/pallas_vjp.py:417",
    "sampler_bp_adj_chain": "svae_tpu/ops/pallas_vjp.py:417",
    "sampler_bp_adj_dJc": "svae_tpu/ops/pallas_vjp.py:417",
    "hmm_fb_fwd": "svae_tpu/ops/pallas_hmm.py:51",
    "hmm_fb_adj": "svae_tpu/ops/pallas_hmm.py:257",
    "hmm_fb_adj_weights": "svae_tpu/ops/pallas_hmm.py:257",
    "hmm_fb_adj_chain": "svae_tpu/ops/pallas_hmm.py:257",
    "hmm_fb_adj_dM": "svae_tpu/ops/pallas_hmm.py:257",
    "hmm_fb_stat_fwd": "svae_tpu/ops/pallas_hmm.py:110",
    "hmm_fb_stat_adj": "svae_tpu/ops/pallas_hmm.py:173",
    "hmm_fb_stat_adj_weights": "svae_tpu/ops/pallas_hmm.py:173",
    "hmm_fb_stat_adj_sums": "svae_tpu/ops/pallas_hmm.py:173",
    "elem_scan": "svae_tpu/ops/pallas_chunked.py:192",
    "elem_scan_adj": "svae_tpu/ops/pallas_chunked.py:208",
    "elem_scan_adj_factor": "svae_tpu/ops/pallas_chunked.py:208",
    "elem_scan_adj_chain": "svae_tpu/ops/pallas_chunked.py:208",
    "filter_shared": "svae_tpu/ops/pallas_kalman.py:76",
    "backward_shared": "svae_tpu/ops/pallas_kalman.py:242",
    "sampler_shared": "svae_tpu/ops/pallas_kalman.py:415",
    "sampler_shared_factor": "svae_tpu/ops/pallas_kalman.py:415",
}
# the Pallas kernels that a ported kernel serves beside its own: their
# functions, over one direction's lanes or both (ROADMAP Queue 2)
SERVES = {
    "bidir_fwd": ("svae_tpu/ops/pallas_vjp.py:77",
                  "svae_tpu/ops/pallas_vjp.py:127",
                  "svae_tpu/ops/pallas_vjp.py:221",
                  "svae_tpu/ops/pallas_kalman.py:564"),
    "bidir_adj": ("svae_tpu/ops/pallas_vjp.py:304",
                  "svae_tpu/ops/pallas_vjp.py:365",
                  "svae_tpu/ops/pallas_vjp.py:470"),
}
SERVES["bidir_adj_factor"] = SERVES["bidir_adj_chain"] = SERVES["bidir_adj"]
# the chain passes that a second function's C call launches too: the
# shared-pair sampler's (#23) and the stationary HMM adjoint's (#17)
SERVES["sampler_bp_fwd_chain"] = ("svae_tpu/ops/pallas_kalman.py:415",)
SERVES["hmm_fb_adj_chain"] = ("svae_tpu/ops/pallas_hmm.py:173",)
SOURCES = {
    "filter_fwd": "svae_tpu_torch/csrc/estep.cu",
    "filter_adj": "svae_tpu_torch/csrc/filter_adj.cu",
    "sampler_fwd": "svae_tpu_torch/csrc/estep.cu",
    "sampler_fwd_factor": "svae_tpu_torch/csrc/estep.cu",
    "sampler_fwd_chain": "svae_tpu_torch/csrc/estep.cu",
    "sampler_adj": "svae_tpu_torch/csrc/sampler_adj.cu",
    "bidir_fwd": "svae_tpu_torch/csrc/bpairs.cu",
    "bidir_adj": "svae_tpu_torch/csrc/bidir_adj.cu",
    "bidir_adj_factor": "svae_tpu_torch/csrc/bidir_adj.cu",
    "bidir_adj_chain": "svae_tpu_torch/csrc/bidir_adj.cu",
    "sampler_bp_fwd": "svae_tpu_torch/csrc/bpairs.cu",
    "sampler_bp_fwd_factor": "svae_tpu_torch/csrc/bpairs.cu",
    "sampler_bp_fwd_chain": "svae_tpu_torch/csrc/bpairs.cu",
    "sampler_bp_adj": "svae_tpu_torch/csrc/sampler_bp_adj.cu",
    "sampler_bp_adj_factor": "svae_tpu_torch/csrc/sampler_bp_adj.cu",
    "sampler_bp_adj_chain": "svae_tpu_torch/csrc/sampler_bp_adj.cu",
    "sampler_bp_adj_dJc": "svae_tpu_torch/csrc/sampler_bp_adj.cu",
    "hmm_fb_fwd": "svae_tpu_torch/csrc/hmm_fb.cu",
    "hmm_fb_adj": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "hmm_fb_adj_weights": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "hmm_fb_adj_chain": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "hmm_fb_adj_dM": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "hmm_fb_stat_fwd": "svae_tpu_torch/csrc/hmm_fb.cu",
    "hmm_fb_stat_adj": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "hmm_fb_stat_adj_weights": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "hmm_fb_stat_adj_sums": "svae_tpu_torch/csrc/hmm_fb_adj.cu",
    "elem_scan": "svae_tpu_torch/csrc/elem_scan.cu",
    "elem_scan_adj": "svae_tpu_torch/csrc/elem_scan_adj.cu",
    "elem_scan_adj_factor": "svae_tpu_torch/csrc/elem_scan_adj.cu",
    "elem_scan_adj_chain": "svae_tpu_torch/csrc/elem_scan_adj.cu",
    "filter_shared": "svae_tpu_torch/csrc/kalman_fwd.cu",
    "backward_shared": "svae_tpu_torch/csrc/kalman_fwd.cu",
    "sampler_shared": "svae_tpu_torch/csrc/bpairs.cu",
    "sampler_shared_factor": "svae_tpu_torch/csrc/bpairs.cu",
}
# ragged batches of the bpairs kernels: lengths spread evenly over [2, T]
RAGGED_SHAPES = {"small": dict(B=3, T=7, d=3, S=2),
                 "ragged": dict(B=64, T=128, d=10, S=1)}
RAGGED_LONG = dict(B=64, T=512, d=10, S=1)
# the other shapes bidir_adj runs at: the slds_synth x-step (2B = 32 lanes,
# T=80, d=4; svae_tpu/config.py SLDSConfig) and one direction's B lanes of
# bench_longT's B=8, T=2048 (the backward of bpairs.lds_filter and
# lds_backward, rows 6 and 8 of PERF.md's table)
BIDIR_ADJ_SHAPES = {"slds": dict(B=16, T=80, d=4, S=2),
                    "one_direction": dict(B=8, T=2048, d=10, S=1)}
# benchmarks/ragged_throughput.py
RAGGED_CORPUS = dict(N=512, T_min=64, T_max=512, d_obs=20)
RAGGED_B, RAGGED_PAD = 64, 64
# the HMM forward-backward kernels: a small odd shape, the slds_synth
# mean-field's z-step (svae_tpu/config.py SLDSConfig: B=16, T=80, K=4) and
# bench.py's measure_hmm shape
HMM_SHAPES = {"small": dict(B=3, T=7, K=3), "slds": dict(B=16, T=80, K=4),
              "measure_hmm": dict(B=128, T=100, K=8)}
# float32 message kernels against float64 plain versions, normwise per
# output: the log-normalizer tier carried to log-space messages (node
# marginals of hmm_posterior are held to TOL_ABS, the adjoints to
# TOL_ADJ_REL)
TOL_MSG_REL = 2e-4
# SLDS-SVAE training at the slds_synth preset (svae_tpu_torch.config
# PRESETS, examples/slds_synth.py): K=4 states, d_latent=4, T=80, 16-pixel
# frames, MLP width 64, 12 mean-field sweeps, S=2, B=16 of N=256, Adam at
# 1e-3, natural-gradient step 0.5
_SLDS = PRESETS["slds_synth"]
SLDS_CONFIG = dict(K=_SLDS.K, d=_SLDS.d_latent, T=_SLDS.T,
                   width=_SLDS.image_width, N=_SLDS.num_seqs,
                   hidden=_SLDS.hidden[0], sweeps=_SLDS.meanfield_iters,
                   S=_SLDS.train.num_samples, B=_SLDS.train.batch_size,
                   net_step_size=_SLDS.train.net_step_size,
                   pgm_step_size=_SLDS.train.pgm_step_size)
# GMM-SVAE at BASELINE config 1 (the gmm_pinwheel preset, bench.py
# measure_gmm): pinwheel N=1000 (5 arms), K=8, d_latent=2, 25 mean-field
# sweeps, S=2, MLP width 40, full-batch SVI
_GMM = PRESETS["gmm_pinwheel"]
GMM_CONFIG = dict(N=_GMM.num_classes * _GMM.num_per_class, K=_GMM.K,
                  d=_GMM.d_latent, sweeps=_GMM.meanfield_iters,
                  S=_GMM.train.num_samples, hidden=_GMM.hidden[0])
# the forecast horizon of lds.predict and slds.predict (phase 4f)
FORECAST_STEPS = 50
# bench.py measure_slds: the SLDS E-step alone
MEASURE_SLDS = dict(B=16, T=50, K=4, d=3, sweeps=10, S=2)
# the padded-batch theorem in float32: stats and local KL of a padded
# batch against its sequences run alone (tests/test_masking.py's Pallas
# tier)
TOL_PAD_REL = 1e-4
# the chain-element scan kernels: a small odd shape, the config-2 fold
# (B=64, T=100 in C=8 chunks: 512 lanes of 13 steps), the long-T fold
# (bench_longT's B=8, T=2048 in C=64 chunks: 512 lanes of 32 steps) and
# the config-2 chunk totals' shape (the scans of ops/chunked.py's pass 2:
# B=64 lanes of C=8 steps)
ELEM_SHAPES = {"small": dict(B=5, T=5, d=3, C=1),
               "config2": dict(B=64, T=100, d=10, C=8),
               "longT": dict(B=8, T=2048, d=10, C=64),
               "totals": dict(B=64, T=9, d=10, C=1)}
ELEM_FIELDS = ("J11", "J12", "J22", "h1", "h2", "c")
# the chunk count of the chunked train path: pallas_chunked's default
CHUNKS = 8
# benchmarks/bench_longT.py's shape for posterior_moments(parallel=C)
LONG_T = dict(B=8, d=10, Ts=(512, 2048), chunks=(32, 64, 128))
# the forward-only shared-pair kernels (ops/kalman_fwd.py): a small odd
# shape, config-2 width and a long T; the config-2 expected pairs are varied
# in time (a seeded factor in [0.9, 1.1] on the whole pair potential and
# another on its transition matrix) so that every step reads its own row
KFWD_SHAPES = {"small": dict(B=3, T=7, d=3, S=2),
               "config2": dict(B=64, T=100, d=10, S=2),
               "longT": dict(B=8, T=2048, d=10, S=2)}
# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TIMING_RUNS = 25
# the plain versions' timings: each call takes 1-1,400 ms, so fewer runs
PLAIN_RUNS = 5


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


def _ln_rel(ln, lnp):
    """Relative error of the summed log-normalizer increments."""
    return abs(float(ln.double().sum() - lnp.sum())) / abs(float(lnp.sum()))


def _sampler_problem(fin, filtered, mats, eps, B):
    """The sampler's inputs on the forward lanes of a filter's output."""
    Jf = torch.cat([fin[0][None, :, :B], filtered[0][:, :, :B]])
    hf = torch.cat([fin[1][None, :, :B], filtered[1][:, :, :B]])
    return estep.sampler_inputs(mats, Jf, hf, eps)[0]


def sampler_problem(shape, seed=0, device="cuda"):
    """float64 inputs of the sampler at ``shape``, on the forward messages
    of the float64 filter twin."""
    init, mats, nodes, eps = _problem(shape, seed, device)
    fin = estep.filter_inputs(init, mats, nodes)
    return _sampler_problem(fin, estep.filter_fwd_plain(*fin), mats, eps,
                            shape["B"])


def check_sampler_fwd_passes(sin):
    """Each pass of the forward sampler (float32 kernel) against its own
    plain version (float64) on the same float64 sampler inputs ``sin``, the
    chain fed the plain factor pass's output; raises past TOL_ABS. Returns
    ``{pass: max abs error}`` over the pass's outputs."""
    P2, P3, Jf, hf, eps, xT = sin
    Wc = estep.sampler_fwd_factor(*_f32((P3, Jf, hf, eps)))
    Wcp = estep.sampler_fwd_factor_plain(P3, Jf, hf, eps)
    x = estep.sampler_fwd_chain(*_f32((*Wcp, P2, xT)))
    xp = estep.sampler_fwd_chain_plain(*Wcp, P2, xT)
    torch.cuda.synchronize()
    errs = {"sampler_fwd_factor": _max_err(Wc, Wcp),
            "sampler_fwd_chain": _max_err((x,), (xp,))}
    if not all(v <= TOL_ABS for v in errs.values()):
        raise AssertionError(f"a sampler pass disagrees with its plain "
                             f"version: {errs}")
    return errs


def check_kernels(shape, seed=0, device="cuda"):
    """The forward kernels (float32) against their twins (float64) on the
    same inputs at ``shape``: the filter, the sampler and each of its two
    passes, each pass fed the plain output of the pass before it; raises
    past the tolerances. Returns the max abs errors and the filter's summed
    log-normalizer rel (``filter_fwd_ln_rel``)."""
    init, mats, nodes, eps = _problem(shape, seed, device)
    B = shape["B"]
    fin = estep.filter_inputs(init, mats, nodes)
    Jp, hp, lnp = estep.filter_fwd_plain(*fin)
    J, h, ln = estep.filter_fwd(*_f32(fin))
    torch.cuda.synchronize()
    errs = {"filter_fwd": _max_err((J, h), (Jp, hp)),
            "filter_fwd_ln_rel": _ln_rel(ln, lnp)}

    # the sampler reads the (float64) forward messages of that filter
    sin = _sampler_problem(fin, (Jp, hp), mats, eps, B)
    x = estep.sampler_fwd(*_f32(sin))
    xp = estep.sampler_fwd_plain(*sin)
    torch.cuda.synchronize()
    errs["sampler_fwd"] = _max_err((x,), (xp,))
    errs.update(check_sampler_fwd_passes(sin))
    if not all(v <= (TOL_LOGZ_REL if k.endswith("_ln_rel") else TOL_ABS)
               for k, v in errs.items()):
        raise AssertionError(f"kernel disagrees with its twin at {shape}: "
                             f"{errs}")
    return errs


# the forward kernels' entries in the errors of check_kernels
FWD_ERRS = ("filter_fwd", "sampler_fwd", "sampler_fwd_factor",
            "sampler_fwd_chain")


def _stiff_jd(jd, seed):
    """Node precisions of ``jd``'s shape spread log-uniformly over
    [1e-2, 1e3] (STIFF_JD), from ``seed``, on ``jd``'s device."""
    g = torch.Generator().manual_seed(seed + 1)
    lo, hi = (math.log10(v) for v in STIFF_JD)
    return (10.0 ** (lo + (hi - lo) * torch.rand(
        jd.shape, generator=g, dtype=torch.float64))).to(jd.device)


def stiff_problem(shape=SHAPES["config2"], seed=12, device="cuda"):
    """``_problem`` with the node precisions spread log-uniformly over
    [1e-2, 1e3] (STIFF_JD): float64 filter inputs, the mats and the noise."""
    init, mats, (jd, h), eps = _problem(shape, seed, device)
    return (estep.filter_inputs(init, mats, (_stiff_jd(jd, seed), h)), mats,
            eps)


def _step_rel(got, want):
    """Worst relative error of one step's block over the steps and lanes:
    ``got`` and ``want`` are (T-1, k, lanes), the norm taken over k. (A
    step's J can hold a node precision of 1e3 on its diagonal, so a max abs
    error over all entries reads that entry's float32 rounding and nothing
    of the steps whose precisions are small.)"""
    err = (got.double() - want).norm(dim=1) / want.norm(dim=1)
    return float(err.max())


def _lane_rel(ln, lnp):
    """Worst relative error of a chain's log-normalizer over the lanes.
    (The summed increments' error is a signed sum over the lanes, which
    can cancel to far below any one lane's error.)"""
    return float(((ln.double() - lnp).abs() / lnp.abs()).max())


def check_stiff(shape=SHAPES["config2"], seed=12, device="cuda", d=None):
    """The stiff case: node precisions over [1e-2, 1e3] at ``shape`` (the
    per-sequence sampler at RAGGED_SHAPES["ragged"], the element scan at
    the config-2 fold of ELEM_SHAPES, the shared-pair filters and sampler
    at KFWD_SHAPES["config2"]; each at latent size ``d`` where given). The
    forward kernels' explicit eliminations and inverses against float64,
    beside the float32 plain
    versions' error on the same device: each kernel's error may be at most
    STIFF_FACTOR times the float32 plain version's. The errors are
    normwise per step and lane (``_step_rel``) for the filters' J and h,
    the samples and each element field but c, and per lane (``_lane_rel``)
    for the filters' ln and, normwise over the steps, the elements' c
    (``_elem_stiff``).
    Returns ``{name: (kernel error, float32 plain error)}``."""
    at = lambda sh: sh if d is None else dict(sh, d=d)
    shape = at(shape)
    fin, mats, eps = stiff_problem(shape, seed, device)
    B = shape["B"]
    want = estep.filter_fwd_plain(*fin)
    plain32 = estep.filter_fwd_plain(*_f32(fin))
    got = estep.filter_fwd(*_f32(fin))
    errs = {}
    for i, name in enumerate(("filter_fwd_J", "filter_fwd_h")):
        errs[name] = (_step_rel(got[i], want[i]),
                      _step_rel(plain32[i], want[i]))
    errs["filter_fwd_ln"] = (_lane_rel(got[2], want[2]),
                             _lane_rel(plain32[2], want[2]))
    sin = _sampler_problem(fin, want, mats, eps, B)
    xp = estep.sampler_fwd_plain(*sin)
    x = estep.sampler_fwd(*_f32(sin))
    torch.cuda.synchronize()
    errs["sampler_fwd"] = (_step_rel(x, xp), _step_rel(
        estep.sampler_fwd_plain(*_f32(sin)), xp))
    samp = bpairs_problem(at(RAGGED_SHAPES["ragged"]), seed, device,
                          stiff=True)[1][:6]
    xp = bpairs.sampler_bp_fwd_plain(*samp)
    x = bpairs.sampler_bp_fwd(*_f32(samp))
    torch.cuda.synchronize()
    errs["sampler_bp_fwd"] = (_step_rel(x, xp), _step_rel(
        bpairs.sampler_bp_fwd_plain(*_f32(samp)), xp))
    errs.update(_elem_stiff(elem_problem(at(ELEM_SHAPES["config2"]), seed,
                                         device, stiff=True)))
    errs.update(_kfwd_stiff(kfwd_problem(at(KFWD_SHAPES["config2"]), seed,
                                         device, stiff=True), device))
    if not all(k <= STIFF_FACTOR * p for k, p in errs.values()):
        raise AssertionError(f"a forward kernel's error in the stiff case "
                             f"passes {STIFF_FACTOR}x the float32 plain "
                             f"version's: {errs}")
    return errs


def _kfwd_stiff(problem, device):
    """``check_stiff``'s errors of the shared-pair kernels on the float64
    ``(init, pairs, nodes, eps)``: ``{"<filter>_<output>": (kernel error,
    float32 plain error)}``, J and h normwise per step and lane, the
    forward's ln per lane; and ``sampler_shared``'s samples normwise per
    step and lane, on the float64 filter's messages."""
    init, pairs, nodes, _ = problem
    errs = {}
    for name, args in (("filter_shared",
                        kalman_fwd.filter_inputs(init, pairs, nodes)),
                       ("backward_shared",
                        kalman_fwd.backward_inputs(pairs, nodes))):
        kernel = getattr(kalman_fwd, name)
        plain = getattr(kalman_fwd, name + "_plain")
        want, plain32 = plain(*args), plain(*_f32(args))
        got = kernel(*_f32(args))
        torch.cuda.synchronize()
        for i, out in enumerate(("J", "h")):
            errs[f"{name}_{out}"] = (_step_rel(got[i], want[i]),
                                     _step_rel(plain32[i], want[i]))
        if name == "filter_shared":
            errs["filter_shared_ln"] = (_lane_rel(got[2], want[2]),
                                        _lane_rel(plain32[2], want[2]))
    sin = _kfwd_sampler_problem(problem, device)
    xp = kalman_fwd.sampler_shared_plain(*sin)
    x = kalman_fwd.sampler_shared(*_f32(sin))
    torch.cuda.synchronize()
    errs["sampler_shared"] = (_step_rel(x, xp), _step_rel(
        kalman_fwd.sampler_shared_plain(*_f32(sin)), xp))
    return errs


def _elem_stiff(leaves):
    """``check_stiff``'s errors of the element scan on float64 ``leaves``:
    ``{"elem_scan_<field>": (kernel error, float32 plain error)}``,
    normwise per step and lane over each field's rows, but per lane over
    the steps for c (a prefix's constant can pass through zero), and only
    where the float64 reference is not zero (the pad leaves' J12, h1 and
    h2 are, and so are those of the prefixes that end in them)."""
    want = chunked.elem_scan_plain(leaves)
    got = chunked.elem_scan(leaves.float())
    torch.cuda.synchronize()
    plain = chunked.elem_scan_plain(leaves.float())
    d = chunked._dim(leaves.shape[1])
    rows = np.cumsum([0] + [d * d] * 3 + [d] * 2 + [1])
    errs = {}
    for f, a, b in zip(ELEM_FIELDS, rows[:-1], rows[1:]):
        w = want[:, a:b]
        axis = 0 if f == "c" else 1
        norm = w.norm(dim=axis)
        nz = norm > 0
        rel = lambda x: float(((x[:, a:b].double() - w).norm(dim=axis)[nz]
                               / norm[nz]).max())
        errs["elem_scan_" + f] = (rel(got), rel(plain))
    return errs


def check_non_spd(device="cuda", seed=13, d=3):
    """A step whose precision is not positive definite must come back
    non-finite, in the lanes it reaches and no others, at latent size
    ``d``: the filter and the two shared-pair filters with a large negative
    node precision at one frame of one sequence, the three samplers with
    one step's Jf of one sequence made indefinite, the element scan with
    one combine's M of one lane made indefinite. Returns the count of
    non-finite outputs of each."""
    shape = dict(B=4, T=9, d=d, S=2)
    B = shape["B"]
    b0, f0, t0 = 1, 4, 3  # the sequence, its filter frame, its sampler step
    init, mats, (jd, h), eps = _problem(shape, seed, device)
    fin_spd = estep.filter_inputs(init, mats, (jd, h))
    jd = jd.clone()
    jd[b0, f0] = -1e4
    fin = estep.filter_inputs(init, mats, (jd, h))
    bad = torch.zeros(2 * B, dtype=torch.bool)
    bad[[b0, B + b0]] = True
    counts = {}
    lanes_bad = lambda X: ~torch.isfinite(X).reshape(-1, X.shape[-1]).all(0)
    J, hh, ln = estep.filter_fwd(*_f32(fin))
    got = [lanes_bad(X).cpu() for X in (J, hh, ln[None])]
    if not all(bool((g == bad).all()) for g in got):
        raise AssertionError(f"filter_fwd: a non-SPD step did not poison "
                             f"exactly its lanes: {got}")
    counts["filter_fwd"] = int(sum((~torch.isfinite(X)).sum()
                                   for X in (J, hh, ln)))
    P2, P3, Jf, hf, eps_s, xT = _f32(_sampler_problem(
        fin_spd, estep.filter_fwd_plain(*fin_spd), mats, eps, B))
    Jf = Jf.clone()
    Jf[t0, ::d + 1, b0] = -1e4
    x = estep.sampler_fwd(P2, P3, Jf, hf, eps_s, xT)
    torch.cuda.synchronize()
    want = torch.zeros(x.shape, dtype=torch.bool)
    want[:t0 + 1, :, b0::B] = True
    if not bool((~torch.isfinite(x).cpu() == want).all()):
        raise AssertionError("sampler_fwd: a non-SPD step did not poison "
                             "exactly the samples it reaches")
    counts["sampler_fwd"] = int((~torch.isfinite(x)).sum())

    # the per-sequence sampler: step t0's Jf of sequence b0 indefinite, so
    # Jc_t0 of b0: that step's and every earlier step's samples of b0
    P2, P3, Jf, hf, eps_s, xT = _f32(bpairs_problem(shape, seed,
                                                    device)[1][:6])
    Jf = Jf.clone()
    Jf[t0, ::d + 1, b0] = -1e4
    x = bpairs.sampler_bp_fwd(P2, P3, Jf, hf, eps_s, xT)
    torch.cuda.synchronize()
    if not bool((~torch.isfinite(x).cpu() == want).all()):
        raise AssertionError("sampler_bp_fwd: a non-SPD step did not poison "
                             "exactly the samples it reaches")
    counts["sampler_bp_fwd"] = int((~torch.isfinite(x)).sum())

    # the element scan: combine j0 of lane n0 with an indefinite M (its
    # leaf's J11), which poisons that element of the lane and every later
    # one, and nothing else
    leaves = elem_problem(dict(B=4, T=9, d=d, C=2), seed, device).float()
    n0, j0 = 5, 2
    leaves[j0, ::d + 1, n0][:d] = -1e4
    out = chunked.elem_scan(leaves)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(out).all(1).cpu()
    want = torch.zeros(bad.shape, dtype=torch.bool)
    want[j0:, n0] = True
    if not bool((bad == want).all()):
        raise AssertionError("elem_scan: an indefinite combine did not "
                             "poison exactly its lane's elements from there "
                             "on")
    counts["elem_scan"] = int((~torch.isfinite(out)).sum())
    counts.update(_kfwd_non_spd(shape, b0, f0, seed, device))
    counts["sampler_shared"] = _kfwd_sampler_non_spd(shape, b0, t0, seed,
                                                     device)
    return counts


def _kfwd_sampler_non_spd(shape, b0, t0, seed, device):
    """``check_non_spd``'s case of the shared-pair sampler: step t0's Jf of
    sequence b0 made indefinite (its diagonal -1e4), so Jc_t0 of b0 is, and
    its samples at that step and every earlier one, in every sample s
    (lanes s*B + b0), must come back non-finite and every other entry
    finite. Returns the count of non-finite samples."""
    B, d = shape["B"], shape["d"]
    P2, P3, Jf, hf, eps, xT = _f32(_kfwd_sampler_problem(
        kfwd_problem(shape, seed, device), device))
    Jf = Jf.clone()
    Jf[t0, ::d + 1, b0] = -1e4
    x = kalman_fwd.sampler_shared(P2, P3, Jf, hf, eps, xT)
    torch.cuda.synchronize()
    want = torch.zeros(x.shape, dtype=torch.bool)
    want[:t0 + 1, :, b0::B] = True
    if not bool((~torch.isfinite(x).cpu() == want).all()):
        raise AssertionError("sampler_shared: a non-SPD step did not poison "
                             "exactly the samples it reaches")
    return int((~torch.isfinite(x)).sum())


def _kfwd_non_spd(shape, b0, f0, seed, device):
    """``check_non_spd``'s case of the shared-pair filters: node f0 of
    sequence b0 with a large negative precision (N1 += 5e3 I), whose step
    poisons the forward's rows t >= f0 (frames f0+1 on, where the next M
    is indefinite) and its ln, and the backward's rows t <= f0-1 (the step
    that adds the node into M and every later one), of lane b0 alone.
    Returns the count of non-finite outputs of each."""
    init, pairs, (N1, N2), _ = kfwd_problem(shape, seed, device)
    N1 = N1.clone()
    N1[b0, f0] += 5e3 * torch.eye(shape["d"], dtype=N1.dtype, device=device)
    T1, B = shape["T"] - 1, shape["B"]
    rows = torch.arange(T1, device=device)[:, None]
    lane = torch.arange(B, device=device)[None, :] == b0
    counts = {}
    for name, args, bad in (
            ("filter_shared", kalman_fwd.filter_inputs(init, pairs, (N1, N2)),
             (rows >= f0) & lane),
            ("backward_shared", kalman_fwd.backward_inputs(pairs, (N1, N2)),
             (rows <= f0 - 1) & lane)):
        outs = getattr(kalman_fwd, name)(*_f32(args))
        torch.cuda.synchronize()
        got = [~torch.isfinite(X).all(1) for X in outs[:2]]
        ok = all(bool((g == bad).all()) for g in got)
        if name == "filter_shared":
            ok = ok and bool((~torch.isfinite(outs[2]) == lane[0]).all())
        if not ok:
            raise AssertionError(f"{name}: a non-SPD step did not poison "
                                 f"exactly the rows of its lane it reaches")
        counts[name] = int(sum((~torch.isfinite(X)).sum() for X in outs))
    return counts


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


def check_adjoint_passes(filt, samp):
    """Each pass of the two adjoints (float32 kernel) against its own
    plain version (float64) on the same float64 inputs, each pass fed the
    plain output of the pass before it. Returns ``{pass: (normwise rel, max
    abs)}`` over the pass's outputs."""
    errs = {}

    def held(name, kernel, plain, *args):
        want = plain(*args)
        got = kernel(*_f32(args))
        torch.cuda.synchronize()
        pair = (got, want) if isinstance(want, tuple) else ((got,), (want,))
        errs[name] = _rel_err(*pair)
        return want

    fac = held("filter_adj_factor", estep.filter_adj_factor,
               estep.filter_adj_factor_plain, *filt[:9])
    held("filter_adj_chain", estep.filter_adj_chain,
         estep.filter_adj_chain_plain, fac, *filt[9:])
    P2, P3, Jf, hf, eps, xT, x, dx = samp
    W = held("sampler_adj_factor", estep.sampler_adj_factor,
             estep.sampler_adj_factor_plain, P3, Jf)
    dhf = held("sampler_adj_chain", estep.sampler_adj_chain,
               estep.sampler_adj_chain_plain, W, P2, xT, x, dx)[0]
    held("sampler_adj_dJc", estep.sampler_adj_dJc,
         estep.sampler_adj_dJc_plain, P2, P3, Jf, hf, eps, xT, x, dhf)
    return errs


def check_adjoints(shape, seed=0, device="cuda"):
    """Both adjoint kernels (float32) against their plain adjoints
    (float64) on the same inputs and cotangents at ``shape``, then each of
    their passes against its own plain version; raises past TOL_ADJ_REL.
    Returns ``{name: (normwise rel, max abs)}``."""
    filt, samp = adjoint_problem(shape, seed, device)
    errs = {}
    got = estep.filter_adj(*_f32(filt))
    torch.cuda.synchronize()
    errs["filter_adj"] = _rel_err(got, estep.filter_adj_plain(*filt))
    got = estep.sampler_adj(*_f32(samp))
    torch.cuda.synchronize()
    errs["sampler_adj"] = _rel_err(got, estep.sampler_adj_plain(*samp))
    errs.update(check_adjoint_passes(filt, samp))
    if not all(rel <= TOL_ADJ_REL for rel, _ in errs.values()):
        raise AssertionError(f"an adjoint kernel disagrees with its plain "
                             f"version at {shape}: {errs}")
    return errs


def bpairs_problem(shape, seed=0, device="cuda", stiff=False):
    """float64 inputs of the four bpairs kernels at ``shape``, a ragged
    batch with lengths spread over [2, T]: the bidirectional filter's
    packed inputs, its twin's outputs J, h and random cotangents of J, h,
    ln; the sampler's inputs on the twin's forward messages, its twin's
    output and a random cotangent; and the twin's ln. ``stiff``: node
    precisions over STIFF_JD."""
    init, mats, nodes, eps = _problem(shape, seed, device)
    if stiff:
        nodes = (_stiff_jd(nodes[0], seed), nodes[1])
    lengths = torch.linspace(2, shape["T"], shape["B"]).round().long().to(
        device)
    jd, h, _ = lds._prepare(nodes, None, lengths)
    pairs, bnodes = lds._chain(mats, (jd, h), lengths)
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
    (float64) on the same inputs and cotangents at ``shape``, and each pass
    of the sampler and of the two adjoints against its own; raises past the
    forward tiers and
    TOL_ADJ_REL. Returns the forward kernels' max abs errors and the
    log-normalizer's rel error, and the adjoints' and passes' ``(normwise
    rel, max abs)``."""
    filt, samp, lnp = bpairs_problem(shape, seed, device)
    J, h, ln = bpairs.bidir_fwd(*_f32(filt[:8]))
    x = bpairs.sampler_bp_fwd(*_f32(samp[:6]))
    torch.cuda.synchronize()
    errs = {"bidir_fwd": _max_err((J, h), filt[8:10]),
            "bidir_ln_rel": abs(float(ln.double().sum() - lnp.sum()))
            / abs(float(lnp.sum())),
            "sampler_bp_fwd": _max_err((x,), samp[6:7])}
    errs.update(check_sampler_bp_fwd_passes(samp[:6]))
    errs.update(check_bidir_adj(filt))
    got = bpairs.sampler_bp_adj(*_f32(samp))
    torch.cuda.synchronize()
    errs["sampler_bp_adj"] = _rel_err(got, bpairs.sampler_bp_adj_plain(*samp))
    errs.update(check_sampler_bp_adj_passes(samp))
    ok = (errs["bidir_fwd"] <= TOL_ABS and errs["bidir_ln_rel"] <= TOL_LOGZ_REL
          and all(errs[k] <= TOL_ABS for k in SAMPLER_BP_FWD_ERRS)
          and all(errs[k][0] <= TOL_ADJ_REL for k in SAMPLER_BP_ERRS))
    if not ok:
        raise AssertionError(f"a bpairs kernel disagrees with its plain "
                             f"version at {shape}: {errs}")
    return errs


SAMPLER_BP_ERRS = ("sampler_bp_adj", "sampler_bp_adj_factor",
                   "sampler_bp_adj_chain", "sampler_bp_adj_dJc")
SAMPLER_BP_FWD_ERRS = ("sampler_bp_fwd", "sampler_bp_fwd_factor",
                       "sampler_bp_fwd_chain")


def check_sampler_bp_fwd_passes(sin):
    """Each pass of ``sampler_bp_fwd`` (float32 kernel) against its own
    plain version (float64) on ``sin`` (``sampler_bp_fwd``'s float64
    arguments), the chain fed the plain factor pass's output. Returns
    ``{pass: max abs error}`` over the pass's outputs; the callers hold
    them to TOL_ABS."""
    P2, P3, Jf, hf, eps, xT = sin
    Qc = bpairs.sampler_bp_fwd_factor(*_f32((P2, P3, Jf, hf, eps)))
    Qcp = bpairs.sampler_bp_fwd_factor_plain(P2, P3, Jf, hf, eps)
    x = bpairs.sampler_bp_fwd_chain(*_f32((*Qcp, xT)))
    xp = bpairs.sampler_bp_fwd_chain_plain(*Qcp, xT)
    torch.cuda.synchronize()
    return {"sampler_bp_fwd_factor": _max_err(Qc, Qcp),
            "sampler_bp_fwd_chain": _max_err((x,), (xp,))}


def check_sampler_bp_fwd(seed=0, device="cuda"):
    """``sampler_bp_fwd`` and each of its passes against their plain
    versions where check_bpairs does not hold them: at the slds_synth
    x-step's lanes (BIDIR_ADJ_SHAPES["slds"]: B=16, S=2, T=80, d=4).
    Raises past TOL_ABS; returns ``{name: max abs error}``."""
    sin = bpairs_problem(BIDIR_ADJ_SHAPES["slds"], seed, device)[1][:6]
    x = bpairs.sampler_bp_fwd(*_f32(sin))
    torch.cuda.synchronize()
    errs = {"sampler_bp_fwd": _max_err((x,), (bpairs.sampler_bp_fwd_plain(
        *sin),))}
    errs.update(check_sampler_bp_fwd_passes(sin))
    if not all(v <= TOL_ABS for v in errs.values()):
        raise AssertionError(f"sampler_bp_fwd or a pass of it disagrees "
                             f"with its plain version at the slds_synth "
                             f"lanes: {errs}")
    return errs


def check_sampler_bp_adj_passes(samp):
    """Each pass of ``sampler_bp_adj`` (float32 kernel) against its own
    plain version (float64) on ``samp`` (``sampler_bp_adj``'s float64
    arguments), each pass fed the plain output of the pass before it.
    Returns ``{pass: (normwise rel, max abs)}``; check_bpairs holds them to
    TOL_ADJ_REL."""
    P2, P3, Jf, hf, eps, xT, x, dx = samp
    errs = {}
    W = bpairs.sampler_bp_adj_factor_plain(P3, Jf)
    got = bpairs.sampler_bp_adj_factor(*_f32((P3, Jf)))
    torch.cuda.synchronize()
    errs["sampler_bp_adj_factor"] = _rel_err((got,), (W,))
    bbar, dxT = bpairs.sampler_bp_adj_chain_plain(W, P2, dx)
    got = bpairs.sampler_bp_adj_chain(*_f32((W, P2, dx)))
    torch.cuda.synchronize()
    errs["sampler_bp_adj_chain"] = _rel_err(got, (bbar, dxT))
    got = bpairs.sampler_bp_adj_dJc(*_f32((P2, P3, Jf, hf, eps, xT, x, bbar)))
    torch.cuda.synchronize()
    errs["sampler_bp_adj_dJc"] = _rel_err(got, bpairs.sampler_bp_adj_dJc_plain(
        P2, P3, Jf, hf, eps, xT, x, bbar))
    return errs


def check_bidir_adj(filt):
    """``bidir_adj`` (float32 kernels) against its plain adjoint (float64)
    on ``filt`` (``bidir_adj``'s float64 arguments), then each of its
    passes against its own plain version, each pass fed the plain output
    of the pass before it; raises past TOL_ADJ_REL. Returns ``{name:
    (normwise rel, max abs)}``."""
    errs = {}
    got = bpairs.bidir_adj(*_f32(filt))
    torch.cuda.synchronize()
    errs["bidir_adj"] = _rel_err(got, bpairs.bidir_adj_plain(*filt))
    fac = bpairs.bidir_adj_factor_plain(*filt[:10])
    got = bpairs.bidir_adj_factor(*_f32(filt[:10]))
    torch.cuda.synchronize()
    errs["bidir_adj_factor"] = _rel_err((got,), (fac,))
    got = bpairs.bidir_adj_chain(*_f32((fac, *filt[10:])))
    torch.cuda.synchronize()
    errs["bidir_adj_chain"] = _rel_err(
        got, bpairs.bidir_adj_chain_plain(fac, *filt[10:]))
    if not all(rel <= TOL_ADJ_REL for rel, _ in errs.values()):
        raise AssertionError(f"bidir_adj or a pass of it disagrees with its "
                             f"plain version: {errs}")
    return errs


def one_direction_problem(shape, seed=0, device="cuda"):
    """float64 arguments of ``bidir_adj`` over one direction's B lanes (the
    forward filter's, as ``bpairs.lds_filter`` runs it) of a batch of
    full-length chains at ``shape``: the packed inputs, the twin's outputs
    J, h and random cotangents of J, h, ln."""
    init, mats, nodes, _ = _problem(shape, seed, device)
    pairs, bnodes = lds._chain(mats, nodes)
    fin = bpairs._packed(*bpairs._initial(init, bnodes),
                         bpairs._streams(pairs, bnodes))
    J, h, ln = bpairs.bidir_fwd_plain(*fin)
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype,
                                device=device)
    return (*fin, J, h, cot(J), cot(h), cot(ln))


def check_bidir_fwd(seed=0, device="cuda"):
    """``bidir_fwd`` (float32 kernel) against its plain version (float64)
    where check_bpairs does not hold it: at BIDIR_ADJ_SHAPES (the
    slds_synth x-step's 32 lanes, and one direction's 8 lanes at T=2048),
    on a ragged batch whose C has its upper triangle perturbed (the kernel
    writes C_t - D_t X_D with C read in full, and carries C's lower
    triangle, as the plain version does), all within TOL_ABS and
    TOL_LOGZ_REL (the summed ln; at T=2048 per lane); and with one lane's
    step made indefinite, whose J, h from that step on and ln must come back
    non-finite, and every other lane's output finite. Raises if not;
    returns ``{case: (max abs, ln rel)}`` and the non-finite counts."""
    def held(name, args, per_lane=False):
        J, h, ln = bpairs.bidir_fwd(*_f32(args))
        torch.cuda.synchronize()
        Jp, hp, lnp = bpairs.bidir_fwd_plain(*args)
        err = _max_err((J, h), (Jp, hp))
        ln_rel = (float(((ln.double() - lnp).abs() / lnp.abs()).max())
                  if per_lane else abs(float(ln.double().sum() - lnp.sum()))
                  / abs(float(lnp.sum())))
        if not (err <= TOL_ABS and ln_rel <= TOL_LOGZ_REL):
            raise AssertionError(f"bidir_fwd disagrees with its plain "
                                 f"version [{name}]: max abs {err}, ln rel "
                                 f"{ln_rel}")
        out[name] = (err, ln_rel)

    out = {}
    held("slds", bpairs_problem(BIDIR_ADJ_SHAPES["slds"], seed,
                                device)[0][:8])
    held("one_direction", one_direction_problem(
        BIDIR_ADJ_SHAPES["one_direction"], seed, device)[:8], per_lane=True)
    args = list(bpairs_problem(RAGGED_SHAPES["small"], seed, device)[0][:8])
    T1, dd, NL = args[3].shape
    d = args[1].shape[0]
    upper = torch.triu(torch.ones(d, d, device=device), 1).reshape(dd, 1)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    args[3] = args[3] + 0.3 * upper * torch.randn(
        args[3].shape, generator=g, dtype=args[3].dtype, device=device)
    held("asymmetric_C", args)

    # lane l0's step t0 made indefinite: M = J + A_t0 - 1e4 I
    l0, t0 = NL - 1, T1 // 2
    A = args[2].clone()
    A[t0, ::d + 1, l0] -= 1e4
    args[2] = A
    J, h, ln = bpairs.bidir_fwd(*_f32(args))
    torch.cuda.synchronize()
    bad = ~torch.isfinite(J).all(1), ~torch.isfinite(h).all(1)
    want = torch.zeros((T1, NL), dtype=torch.bool, device=device)
    want[t0:, l0] = True
    lane = torch.zeros(NL, dtype=torch.bool, device=device)
    lane[l0] = True
    if not (bool((bad[0] == want).all()) and bool((bad[1] == want).all())
            and bool((~torch.isfinite(ln) == lane).all())):
        raise AssertionError("bidir_fwd: an indefinite step did not poison "
                             "exactly its lane's J, h from that step on and "
                             "its ln")
    out["non_spd"] = int((~torch.isfinite(J)).sum() + (~torch.isfinite(h))
                         .sum())
    return out


def check_bidir_adj_shapes(seed=0, device="cuda"):
    """``bidir_adj`` and its passes (check_bidir_adj) at BIDIR_ADJ_SHAPES:
    both directions' lanes of a ragged slds_synth-shaped batch and one
    direction's lanes at bench_longT's length. Returns ``{shape: errs}``."""
    out = {}
    for name, shape in BIDIR_ADJ_SHAPES.items():
        if name == "one_direction":
            filt = one_direction_problem(shape, seed, device)
        else:
            filt = bpairs_problem(shape, seed, device)[0]
        out[name] = check_bidir_adj(filt)
    return out


def hmm_problem(shape, seed=0, device="cuda", case="stationary"):
    """float64 inputs of ``hmm_posterior`` at ``shape``: ``(log_init (K,),
    log_trans, log_obs (B, T, K), pair_weights)``. ``case``:

    * ``"stationary"``: random (K, K) log_trans, observations 3 N(0, 1);
    * ``"ragged"``: time-varying (B, T-1, K, K) log_trans with uniform rows
      at the pad transitions of lengths spread over [2, T], the pads'
      observations zeroed and ``pair_weights`` marking the real
      transitions, as the SLDS z-step of a ragged batch builds them;
    * ``"forced"``: sticky transitions whose 0 -> 1 entry is -100, and
      observations (0 on state 0 before a frame spread over [T/4, 3T/4]
      and on state 1 from it, -100 elsewhere) that force every sequence
      through that transition once: a route through a third state costs
      16 nats more.

    ``pair_weights`` is None but for ``"ragged"``."""
    B, T, K = (shape[k] for k in "BTK")
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    li = torch.randn(K, generator=g, **f64).log_softmax(-1)
    lt = torch.randn((K, K), generator=g, **f64).log_softmax(-1)
    lo = 3.0 * torch.randn((B, T, K), generator=g, **f64)
    w = None
    if case == "ragged":
        lengths = torch.linspace(2, T, B).round()
        w = (torch.arange(1, T)[None] < lengths[:, None]).double()
        wm = w[..., None, None]
        lt = (wm * torch.randn((B, T - 1, K, K), generator=g,
                               **f64).log_softmax(-1)
              + (1.0 - wm) * -math.log(K))
        lo = torch.cat([lo[:, :1], lo[:, 1:] * w[..., None]], 1)
    elif case == "forced":
        eye = torch.eye(K, **f64)
        lt = torch.log(0.999 * eye + 0.001 / (K - 1) * (1.0 - eye))
        lt[0, 1] = -100.0
        li = torch.log(torch.tensor([1.0 - 0.001 * (K - 1)]
                                    + [0.001] * (K - 1), **f64))
        lo = torch.full((B, T, K), -100.0, **f64)
        switch = torch.linspace(T // 4, 3 * T // 4, B).round().long()
        for b, s in enumerate(switch.tolist()):
            lo[b, :s, 0] = 0.0
            lo[b, s:, 1] = 0.0
    on = lambda x: None if x is None else x.to(device)
    return on(li), on(lt), on(lo), on(w)


HMM_RUNS = (("hmm_fb_fwd", "hmm_fb_adj"),
            ("hmm_fb_stat_fwd", "hmm_fb_stat_adj"))
# the passes of hmm_fb_adj, which its one C call launches in this order
HMM_ADJ_PASSES = ("hmm_fb_adj_weights", "hmm_fb_adj_chain", "hmm_fb_adj_dM")
# and of hmm_fb_stat_adj: its own weight and sums passes around
# hmm_fb_adj's chain pass
HMM_STAT_ADJ_PASSES = ("hmm_fb_stat_adj_weights", "hmm_fb_adj_chain",
                       "hmm_fb_stat_adj_sums")


def hmm_kernel_args(li, lt, lo):
    """The packed arguments of the streamed and, for a (K, K) ``lt``, the
    stationary forward kernel, keyed by the forward's name."""
    a0 = (li + lo[:, 0]).T.contiguous()
    args = {"hmm_fb_fwd": (a0, hmm_fb._pack(lt + lo[:, 1:, None, :]))}
    if lt.dim() == 2:
        args["hmm_fb_stat_fwd"] = (a0, lt.contiguous(),
                                   hmm_fb._pack(lo[:, 1:]))
    return args


def hmm_stat_as_streamed(a0, LT, lo):
    """The streamed forward's float32 arguments (a0, M) for the stationary
    forward's (a0, LT, lo): M_t(i, j) = LT(i, j) + lo_t(j) formed in
    float32 and packed, the elements the stationary kernels form."""
    a32, LT32, lo32 = _f32((a0, LT, lo))
    T1, K, B = lo.shape
    M32 = (LT32[None, :, :, None] + lo32[:, None]).reshape(T1, K * K, B)
    return a32, M32.contiguous()


def check_hmm_stat_fwd_bitwise(args):
    """``hmm_fb_stat_fwd`` (float32 kernel) on the stationary forward's
    float64 ``args`` against ``hmm_fb_fwd``'s kernel on the packed LT + lo
    (hmm_stat_as_streamed): the two run the same chain step on the same
    elements, so their messages must agree bit for bit; raises if not."""
    got = hmm_fb.hmm_fb_stat_fwd(*_f32(args))
    want = hmm_fb.hmm_fb_fwd(*hmm_stat_as_streamed(*args))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("hmm_fb_stat_fwd: not hmm_fb_fwd's messages on "
                             "LT + lo bit for bit")


def check_hmm_adj_passes(adj_args):
    """Each pass of ``hmm_fb_adj`` (float32 kernel) against its own plain
    version (float64) on ``adj_args`` (``hmm_fb_adj``'s float64
    arguments), each pass fed the plain output of the pass before it.
    Returns ``{pass: (normwise rel, max abs)}``; check_hmm holds them to
    TOL_ADJ_REL."""
    a0, M, alpha, beta, dalpha, dbeta = adj_args
    errs = {}
    W, V = hmm_fb.hmm_fb_adj_weights_plain(a0, M, alpha, beta)
    got = hmm_fb.hmm_fb_adj_weights(*_f32((a0, M, alpha, beta)))
    torch.cuda.synchronize()
    errs["hmm_fb_adj_weights"] = _rel_err(got, (W, V))
    g, h, da0 = hmm_fb.hmm_fb_adj_chain_plain(W, V, dalpha, dbeta)
    got = hmm_fb.hmm_fb_adj_chain(*_f32((W, V, dalpha, dbeta)))
    torch.cuda.synchronize()
    errs["hmm_fb_adj_chain"] = _rel_err(got, (g, h, da0))
    got = hmm_fb.hmm_fb_adj_dM(*_f32((W, V, g, h)))
    torch.cuda.synchronize()
    errs["hmm_fb_adj_dM"] = _rel_err(
        (got,), (hmm_fb.hmm_fb_adj_dM_plain(W, V, g, h),))
    return errs


def check_hmm_stat_adj_passes(adj_args):
    """Each pass of ``hmm_fb_stat_adj`` (float32 kernel) against its own
    plain version (float64) on ``adj_args`` (``hmm_fb_stat_adj``'s float64
    arguments), each pass fed the plain output of the pass before it; and
    the weight pass's outputs against ``hmm_fb_adj_weights``' kernel on the
    float32 elements LT + lo_t, which they must equal bit for bit (the same
    adds and exps). Returns ``{pass: (normwise rel, max abs)}`` with the
    chain pass under ``hmm_fb_stat_adj_chain``; check_hmm holds them to
    TOL_ADJ_REL."""
    a0, LT, lo, alpha, beta, dalpha, dbeta = adj_args
    errs = {}
    W, V = hmm_fb.hmm_fb_stat_adj_weights_plain(a0, LT, lo, alpha, beta)
    got = hmm_fb.hmm_fb_stat_adj_weights(*_f32((a0, LT, lo, alpha, beta)))
    a32, M32 = hmm_stat_as_streamed(a0, LT, lo)
    streamed = hmm_fb.hmm_fb_adj_weights(a32, M32, *_f32((alpha, beta)))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, streamed)):
        raise AssertionError("hmm_fb_stat_adj_weights: not the streamed "
                             "weights on LT + lo bit for bit")
    errs["hmm_fb_stat_adj_weights"] = _rel_err(got, (W, V))
    g, h, da0 = hmm_fb.hmm_fb_adj_chain_plain(W, V, dalpha, dbeta)
    got = hmm_fb.hmm_fb_adj_chain(*_f32((W, V, dalpha, dbeta)))
    torch.cuda.synchronize()
    errs["hmm_fb_stat_adj_chain"] = _rel_err(got, (g, h, da0))
    got = hmm_fb.hmm_fb_stat_adj_sums(*_f32((W, V, g, h)))
    torch.cuda.synchronize()
    errs["hmm_fb_stat_adj_sums"] = _rel_err(
        got, hmm_fb.hmm_fb_stat_adj_sums_plain(W, V, g, h))
    return errs


HMM_STAT_ADJ_ERRS = ("hmm_fb_stat_adj_weights", "hmm_fb_stat_adj_chain",
                     "hmm_fb_stat_adj_sums")


def check_hmm(shape, case="stationary", seed=0, device="cuda"):
    """The HMM kernels (float32) against their plain versions (float64) on
    the same inputs and random cotangents at ``shape`` and ``case`` (see
    :func:`hmm_problem`), each pass of ``hmm_fb_adj`` against its own
    (check_hmm_adj_passes) and, for a stationary (K, K) transition matrix,
    ``hmm_fb_stat_fwd`` bit for bit against ``hmm_fb_fwd`` on LT + lo
    (check_hmm_stat_fwd_bitwise) and each pass of ``hmm_fb_stat_adj``
    against its own (check_hmm_stat_adj_passes), and ``hmm_posterior`` on
    the card (float32, every kernel choice) against the float64 CPU path;
    raises past TOL_MSG_REL, TOL_ADJ_REL (the adjoints and the passes) and
    TOL_ABS (node marginals), or if a forced switch's pair count leaves
    (0.9, 1.1). Returns ``{kernel or pass: (normwise rel, max abs)}`` and
    the node marginals' max abs error."""
    li, lt, lo, w = hmm_problem(shape, seed, device, case)
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    cot = lambda x: torch.randn(x.shape, generator=g, dtype=x.dtype,
                                device=device)
    errs = {}
    for fwd, adj in HMM_RUNS:
        args = hmm_kernel_args(li, lt, lo).get(fwd)
        if args is None:
            continue
        got = getattr(hmm_fb, fwd)(*_f32(args))
        want = getattr(hmm_fb, fwd + "_plain")(*args)
        torch.cuda.synchronize()
        errs[fwd] = _rel_err(got, want)
        if fwd == "hmm_fb_stat_fwd":
            check_hmm_stat_fwd_bitwise(args)
        adj_args = (*args, *want, cot(want[0]), cot(want[1]))
        got = getattr(hmm_fb, adj)(*_f32(adj_args))
        torch.cuda.synchronize()
        errs[adj] = _rel_err(got, getattr(hmm_fb, adj + "_plain")(*adj_args))
        if adj == "hmm_fb_adj":
            errs.update(check_hmm_adj_passes(adj_args))
        else:
            errs.update(check_hmm_stat_adj_passes(adj_args))

    cpu = lambda x: None if x is None else x.cpu()
    f32 = lambda x: None if x is None else x.float()
    ref = hmm_fb.hmm_posterior(cpu(li), cpu(lt), cpu(lo), pair_weights=cpu(w))
    node_err, forced = 0.0, []
    for kernel in (("auto", "stationary") if lt.dim() == 2 else ("auto",)):
        out = hmm_fb.hmm_posterior(f32(li), f32(lt), f32(lo),
                                   pair_weights=f32(w), kernel=kernel)
        _finite(out, f"hmm_posterior(kernel={kernel!r}) [{case}]")
        node_err = max(node_err,
                       float((out[1].double().cpu() - ref[1]).abs().max()))
        if case == "forced":
            forced += out[2][:, 0, 1].tolist()
    errs["node"] = node_err
    ok = (all(errs[f][0] <= TOL_MSG_REL and errs[a][0] <= TOL_ADJ_REL
              for f, a in HMM_RUNS if f in errs)
          and all(errs[k][0] <= TOL_ADJ_REL for k in HMM_ADJ_PASSES)
          and all(errs[k][0] <= TOL_ADJ_REL for k in HMM_STAT_ADJ_ERRS
                  if k in errs)
          and node_err <= TOL_ABS)
    if case == "forced":
        errs["forced_pair_count"] = (min(forced), max(forced))
        ok = ok and 0.9 < min(forced) and max(forced) < 1.1
    if not ok:
        raise AssertionError(f"an HMM kernel disagrees with its plain "
                             f"version at {shape} [{case}]: {errs}")
    return errs


def hmm_gradients(li, lt, lo, kernel):
    """Gradients of the summed log-normalizer with respect to the three
    inputs of ``hmm_posterior``: the expected statistics (init marginals,
    summed pair marginals, node marginals). A loss of the marginals
    themselves is no yardstick here: their derivatives are covariances,
    differences of nearly equal terms, and the same algebra on the plain
    versions in float32 misses the float64 gradient by 1e-2 at this
    shape."""
    ins = [x.detach().clone().requires_grad_() for x in (li, lt, lo)]
    logZ = hmm_fb.hmm_posterior(*ins, kernel=kernel)[0]
    return torch.autograd.grad(logZ.sum(), ins)


def hmm_stationary_path(device="cuda"):
    """Phase 3h: ``hmm_posterior(kernel="stationary")`` and its gradient
    at the slds_synth sweep shape on the card, the path that runs the
    stationary kernels: the counters show one launch of each and nothing
    else; the gradients agree with the float64 CPU path within
    TOL_ADJ_REL; then, uncounted, its outputs equal those of
    ``kernel="streamed"`` bit for bit. Returns the launch counts."""
    li, lt, lo, _ = hmm_problem(HMM_SHAPES["slds"], 1, device)
    _reset_counters()
    got = hmm_gradients(*_f32((li, lt, lo)), "stationary")
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in HMM_WRAPPERS}
    plain_calls = {p.__name__: p.calls for p in HMM_PLAINS}
    rel = _normwise(got, hmm_gradients(li.cpu(), lt.cpu(), lo.cpu(),
                                       "stationary"))
    print(f"hmm_posterior(kernel='stationary') with its gradient: launches "
          f"{launches}, plain calls {plain_calls}; gradients vs float64 "
          f"normwise rel {rel:.3e}")
    if (launches != {"hmm_fb_fwd": 0, "hmm_fb_adj": 0, "hmm_fb_stat_fwd": 1,
                     "hmm_fb_stat_adj": 1} or any(plain_calls.values())
            or rel > TOL_ADJ_REL):
        raise AssertionError("the stationary HMM path went wrong")
    # the stationary kernel's messages are the streamed kernel's on LT + lo
    # bit for bit, and the marginals are formed alike from them
    with torch.no_grad():
        outs = [hmm_fb.hmm_posterior(*_f32((li, lt, lo)), kernel=kernel)
                for kernel in ("stationary", "streamed")]
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(*outs)):
        raise AssertionError("hmm_posterior(kernel='stationary') is not "
                             "kernel='streamed' bit for bit")
    return launches


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


def _plain_ms(fn):
    """Median CUDA-event time of a plain version's ``fn()`` in ms, over
    PLAIN_RUNS calls after one."""
    return _time_ms(fn, runs=PLAIN_RUNS, warmup=1)


def _device_spans(fn, calls=20, warmup=3, tries=3):
    """The device records of ``calls`` calls of ``fn()`` under
    torch.profiler, ``{kernel name: [ms of each record]}`` (a port kernel
    by its function name, a PyTorch kernel by the first 40 characters of
    its name). In a process that opens many profiler sessions, a session
    can lose some of its device records (a 2.5 ms kernel read 1.9 ms a
    call in one), or all of them: a session with no device record is taken
    again, up to ``tries`` sessions; after that the result is empty and
    said to be not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            m = re.search(r"(\w+_kernel)<", e.name)
            name = m.group(1) if m else e.name[:40]
            spans.setdefault(name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
        if spans:
            return spans
    print(f"device time not measured: torch.profiler recorded no device "
          f"event in {tries} sessions")
    return {}


def _device_ms(fn, calls=20, warmup=3, tries=3):
    """Device time per call of ``fn()`` by kernel, under torch.profiler:
    ``{kernel name: ms}`` (see _device_spans). Unlike _time_ms, it does not
    count the host's time to launch the call. Since a session can lose
    some of its records, a kernel's time a call is the mean of its records
    times its launches a call, the count of its records over ``calls``
    rounded."""
    spans = _device_spans(fn, calls, warmup, tries)
    return {k: float(np.mean(v)) * max(1, round(len(v) / calls))
            for k, v in spans.items()}


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

    counters = (estep.filter_fwd, estep.sampler_fwd)
    twins = (estep.filter_fwd_plain, estep.sampler_fwd_plain) + \
        FWD_PASS_PLAINS
    for counter in counters:
        counter.launches = 0
    for twin in twins:
        twin.calls = 0
    with torch.no_grad():
        values = [objective(glob, (rec, dec), batch, gen)
                  for batch in batches]
        moments = lds.posterior_moments(glob, rec(batches[0]))
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    twin_calls = sum(t.calls for t in twins)

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
HMM_WRAPPERS = (hmm_fb.hmm_fb_fwd, hmm_fb.hmm_fb_adj, hmm_fb.hmm_fb_stat_fwd,
                hmm_fb.hmm_fb_stat_adj)
HMM_PLAINS = (hmm_fb.hmm_fb_fwd_plain, hmm_fb.hmm_fb_adj_plain,
              hmm_fb.hmm_fb_stat_fwd_plain, hmm_fb.hmm_fb_stat_adj_plain)
# the HMM adjoint's passes one by one (check_hmm_adj_passes, phase 5); the
# model paths launch the three kernels through hmm_fb_adj's one C call
HMM_PASS_WRAPPERS = tuple(getattr(hmm_fb, k) for k in HMM_ADJ_PASSES)
HMM_PASS_PLAINS = tuple(getattr(hmm_fb, k + "_plain")
                        for k in HMM_ADJ_PASSES)
# the stationary adjoint's own passes (check_hmm_stat_adj_passes, phase
# 5); its chain pass is hmm_fb_adj_chain, and hmm_fb_stat_adj's one C call
# launches all three
HMM_STAT_PASS_WRAPPERS = (hmm_fb.hmm_fb_stat_adj_weights,
                          hmm_fb.hmm_fb_stat_adj_sums)
HMM_STAT_PASS_PLAINS = (hmm_fb.hmm_fb_stat_adj_weights_plain,
                        hmm_fb.hmm_fb_stat_adj_sums_plain)
CHUNK_WRAPPERS = (chunked.elem_scan, chunked.elem_scan_adj)
CHUNK_PLAINS = (chunked.elem_scan_plain, chunked.elem_scan_adj_plain)
KFWD_WRAPPERS = (kalman_fwd.filter_shared, kalman_fwd.backward_shared,
                 kalman_fwd.sampler_shared)
KFWD_PLAINS = (kalman_fwd.filter_shared_plain,
               kalman_fwd.backward_shared_plain,
               kalman_fwd.sampler_shared_plain)
# the adjoints' passes one by one (check_adjoint_passes, phase 5); the
# model path launches the same kernels through filter_adj and sampler_adj
PASS_WRAPPERS = (estep.filter_adj_factor, estep.filter_adj_chain,
                 estep.sampler_adj_factor, estep.sampler_adj_chain,
                 estep.sampler_adj_dJc)
PASS_PLAINS = (estep.filter_adj_factor_plain, estep.filter_adj_chain_plain,
               estep.sampler_adj_factor_plain, estep.sampler_adj_chain_plain,
               estep.sampler_adj_dJc_plain)
# the forward sampler's two passes one by one (check_sampler_fwd_passes,
# phase 5); the model path launches both kernels through sampler_fwd's one
# C call, one launch of each a call (LAUNCHED_BY)
FWD_PASS_WRAPPERS = (estep.sampler_fwd_factor, estep.sampler_fwd_chain)
FWD_PASS_PLAINS = (estep.sampler_fwd_factor_plain,
                   estep.sampler_fwd_chain_plain)
# the passes of the element scan's, the bidirectional filter's and the
# per-sequence sampler's adjoints one by one (check_elem_scan,
# check_bidir_adj, check_sampler_bp_adj_passes, phase 5); the model paths
# launch the kernels of each through its adjoint's one C call
CHUNK_PASS_WRAPPERS = (chunked.elem_scan_adj_factor,
                       chunked.elem_scan_adj_chain)
CHUNK_PASS_PLAINS = (chunked.elem_scan_adj_factor_plain,
                     chunked.elem_scan_adj_chain_plain)
RAGGED_PASS_WRAPPERS = (bpairs.bidir_adj_factor, bpairs.bidir_adj_chain)
RAGGED_PASS_PLAINS = (bpairs.bidir_adj_factor_plain,
                      bpairs.bidir_adj_chain_plain)
SAMPLER_BP_PASS_WRAPPERS = (bpairs.sampler_bp_adj_factor,
                            bpairs.sampler_bp_adj_chain,
                            bpairs.sampler_bp_adj_dJc)
SAMPLER_BP_PASS_PLAINS = (bpairs.sampler_bp_adj_factor_plain,
                          bpairs.sampler_bp_adj_chain_plain,
                          bpairs.sampler_bp_adj_dJc_plain)
# the per-sequence sampler's two passes one by one
# (check_sampler_bp_fwd_passes, phase 5); the model paths launch both
# kernels through sampler_bp_fwd's one C call
SAMPLER_BP_FWD_PASS_WRAPPERS = (bpairs.sampler_bp_fwd_factor,
                                bpairs.sampler_bp_fwd_chain)
SAMPLER_BP_FWD_PASS_PLAINS = (bpairs.sampler_bp_fwd_factor_plain,
                              bpairs.sampler_bp_fwd_chain_plain)
# the shared-pair sampler's factor pass (check_sampler_shared_passes,
# phase 5); its chain pass is sampler_bp_fwd_chain, and sampler_shared's
# one C call launches both
KFWD_PASS_WRAPPERS = (kalman_fwd.sampler_shared_factor,)
KFWD_PASS_PLAINS = (kalman_fwd.sampler_shared_factor_plain,)
LAUNCHED_BY = {**{w.__name__: estep.sampler_fwd.__name__
                  for w in FWD_PASS_WRAPPERS},
               **{w.__name__: chunked.elem_scan_adj.__name__
                  for w in CHUNK_PASS_WRAPPERS},
               **{w.__name__: bpairs.bidir_adj.__name__
                  for w in RAGGED_PASS_WRAPPERS},
               **{w.__name__: bpairs.sampler_bp_adj.__name__
                  for w in SAMPLER_BP_PASS_WRAPPERS},
               **{w.__name__: bpairs.sampler_bp_fwd.__name__
                  for w in SAMPLER_BP_FWD_PASS_WRAPPERS},
               **{w.__name__: hmm_fb.hmm_fb_adj.__name__
                  for w in HMM_PASS_WRAPPERS},
               **{w.__name__: hmm_fb.hmm_fb_stat_adj.__name__
                  for w in HMM_STAT_PASS_WRAPPERS},
               **{w.__name__: kalman_fwd.sampler_shared.__name__
                  for w in KFWD_PASS_WRAPPERS}}
ALL_WRAPPERS = (WRAPPERS + PASS_WRAPPERS + FWD_PASS_WRAPPERS
                + RAGGED_WRAPPERS + RAGGED_PASS_WRAPPERS
                + SAMPLER_BP_PASS_WRAPPERS + SAMPLER_BP_FWD_PASS_WRAPPERS
                + HMM_WRAPPERS + HMM_PASS_WRAPPERS + HMM_STAT_PASS_WRAPPERS
                + CHUNK_WRAPPERS + CHUNK_PASS_WRAPPERS + KFWD_WRAPPERS
                + KFWD_PASS_WRAPPERS)
ALL_PLAINS = (PLAINS + PASS_PLAINS + FWD_PASS_PLAINS + RAGGED_PLAINS
              + RAGGED_PASS_PLAINS + SAMPLER_BP_PASS_PLAINS
              + SAMPLER_BP_FWD_PASS_PLAINS + HMM_PLAINS + HMM_PASS_PLAINS
              + HMM_STAT_PASS_PLAINS + CHUNK_PLAINS + CHUNK_PASS_PLAINS
              + KFWD_PLAINS + KFWD_PASS_PLAINS)
TRAIN_K = 8


def _reset_counters():
    for w in ALL_WRAPPERS:
        w.launches = 0
    for p in ALL_PLAINS:
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
    plain_calls = {p.__name__: p.calls
                   for p in PLAINS + FWD_PASS_PLAINS + RAGGED_PLAINS}

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
        _step_vs_f64(lds.run_inference, pgm, nets, (frames, lengths), gen,
                     prior, N, 1, d, f"ragged step (T={frames.shape[1]})",
                     ragged=True)
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


def _slds_models(device, K, d, width, hidden, seed=0):
    g = torch.Generator().manual_seed(seed)
    prior = slds.init_pgm_param(K, d, g, device=device)
    glob = slds.init_pgm_param(K, d, g, device=device)
    rec = recognition.init_mlp_recognize(width, (hidden,), d, g,
                                         device=device)
    dec = decoders.init_mlp_decode(d, (hidden,), width, g, device=device)
    return prior, glob, rec, dec


def _step_vs_f64(run, pgm, nets, batch, gen, prior, N, S, d, label,
                 ragged=False):
    """One ``make_gradfun`` step of ``run`` (a ``run_inference``) on the
    card against the float64 twin path on the CPU under the same noise;
    raises past the tiers. Returns the ELBO's relative error and the
    natural gradient's and the net gradients' normwise errors."""
    frames = batch[0] if ragged else batch
    B, T = frames.shape[:2]
    eps = torch.randn((S, B, T, d), generator=gen, device=frames.device)
    cpu64 = lambda t: t.detach().double().cpu()
    nets_fns = (recognition.mlp_recognize, decoders.mlp_loglike)
    grad = elbo.make_gradfun(functools.partial(run, eps=eps), *nets_fns,
                             prior, N, num_samples=S, ragged=ragged)
    val, nat, grads, _ = grad(pgm, nets, batch, gen)
    grad64 = elbo.make_gradfun(functools.partial(run, eps=cpu64(eps)),
                               *nets_fns, tree_map(cpu64, prior), N,
                               num_samples=S, ragged=ragged)
    nets64 = tuple(copy.deepcopy(m).double().cpu() for m in nets)
    batch64 = (cpu64(frames), batch[1].cpu()) if ragged else cpu64(frames)
    val64, nat64, grads64, _ = grad64(tree_map(cpu64, pgm), nets64,
                                      batch64, None)
    rel = abs(float(val) - float(val64)) / abs(float(val64))
    nat_rel = _normwise(tree_leaves(nat), tree_leaves(nat64))
    grad_rel = [_normwise(g, g64) for g, g64 in zip(grads, grads64)]
    print(f"{label} vs float64 CPU twin path: elbo rel {rel:.3e}, natgrad "
          f"rel {nat_rel:.3e}, recognizer grad rel {grad_rel[0]:.3e}, "
          f"decoder grad rel {grad_rel[1]:.3e}")
    if not (rel <= TOL_LOGZ_REL and nat_rel <= TOL_ADJ_REL
            and max(grad_rel) <= TOL_ADJ_REL):
        raise AssertionError(f"{label} disagrees with the f64 reference")
    return rel, nat_rel, max(grad_rel)


def segmentation_purity(pred, true):
    """examples/slds_synth.py's score: each predicted state mapped to its
    majority true regime, the fraction of frames so explained."""
    pred, true = np.asarray(pred).ravel(), np.asarray(true).ravel()
    return sum(np.bincount(true[pred == k]).max()
               for k in np.unique(pred)) / pred.size


def slds_path(device="cuda", cfg=SLDS_CONFIG):
    """Phase 4s: one epoch of SLDS-SVAE training at the slds_synth preset
    through ``loop.run``, the launch counters showing the schedule's
    launches of the SLDS path's six kernels every step and nothing else;
    the MAP segmentation of 8 sequences (purity printed, not gated); one
    step and one ragged step against the float64 CPU path. Returns the
    launch counts of the epoch."""
    K, d, T, B, S = (cfg[k] for k in ("K", "d", "T", "B", "S"))
    N = cfg["N"]
    data, states = make_switching_dot_data(0, N, T, cfg["width"],
                                           return_states=True)
    data = torch.from_numpy(data).to(device)
    prior, glob, rec, dec = _slds_models(device, K, d, cfg["width"],
                                         cfg["hidden"])
    run = functools.partial(slds.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
        num_samples=S, pgm_step_size=cfg["pgm_step_size"],
        net_step_size=cfg["net_step_size"])
    gen = torch.Generator(device=device).manual_seed(7)

    _reset_counters()
    pgm, nets, _, history, gen = loop.run(
        step, glob, (rec, dec), opt_init(glob, (rec, dec)), data, gen,
        num_epochs=1, batch_size=B)
    torch.cuda.synchronize()
    steps = N // B
    # per step: every sweep and the final half-sweeps run one filter pass
    # and one HMM pass; the differentiated ones (the last sweep and the
    # final half-sweeps) one adjoint each; one sample draw and its adjoint
    fwd, adj = cfg["sweeps"] + 1, 2
    want = {"bidir_fwd": fwd, "bidir_adj": adj, "sampler_bp_fwd": 1,
            "sampler_bp_adj": 1, "hmm_fb_fwd": fwd, "hmm_fb_adj": adj,
            "hmm_fb_stat_fwd": 0, "hmm_fb_stat_adj": 0}
    launches = {w.__name__: w.launches
                for w in RAGGED_WRAPPERS + HMM_WRAPPERS}
    stationary = {w.__name__: w.launches for w in WRAPPERS}
    plain_calls = {p.__name__: p.calls
                   for p in PLAINS + RAGGED_PLAINS + HMM_PLAINS}
    print(f"slds path ({steps} steps of B={B}, T={T}, K={K}, d={d}, "
          f"{cfg['sweeps']} sweeps): launches {launches} (per step "
          f"{ {k: v / steps for k, v in launches.items()} }), stationary "
          f"LDS kernels {stationary}, plain calls {plain_calls}")
    if launches != {k: steps * v for k, v in want.items()}:
        raise AssertionError(f"the SLDS path's launches are not the "
                             f"schedule's {want} a step: {launches}")
    if any(stationary.values()) or any(plain_calls.values()):
        raise AssertionError("the SLDS path launched a stationary LDS "
                             "kernel or called a plain version")
    if len(history) != steps or not np.isfinite(history).all():
        raise AssertionError(f"slds path: bad ELBO history {history}")
    print(f"slds path: elbo/N {' '.join(f'{e:.4f}' for e in history)}")

    with torch.no_grad():
        paths = slds.most_likely_states(pgm, nets[0](data[:8]),
                                        num_meanfield_iters=cfg["sweeps"])
    paths = paths.cpu().numpy()
    if paths.shape != (8, T) or paths.min() < 0 or paths.max() >= K:
        raise AssertionError(f"most_likely_states: bad paths {paths.shape}")
    purity = segmentation_purity(paths, states[:8])
    print(f"slds segmentation purity {purity:.3f} (K={K} states vs 2 true "
          f"regimes, 8 sequences, one epoch)")

    _step_vs_f64(run, pgm, nets, data[:B], gen, prior, N, S, d, "slds step")
    lengths = torch.linspace(T // 4, T, B, device=device).round().long()
    _step_vs_f64(run, pgm, nets, (data[B:2 * B], lengths), gen, prior, N, S,
                 d, "ragged slds step", ragged=True)
    return launches


def slds_padded_theorem(device="cuda", lengths=(37, 80), seed=8,
                        cfg=SLDS_CONFIG):
    """Phase 4s: a padded SLDS batch of two sequences against each
    sequence alone, float32 on the card, 12 sweeps: the summed statistics
    and local KL agree within TOL_PAD_REL. Returns the worst stats error
    (relative to each leaf's largest entry) and the local KL's relative
    error."""
    K, d, T = cfg["K"], cfg["d"], max(lengths)
    g = torch.Generator().manual_seed(seed)
    glob = slds.init_pgm_param(K, d, g, device=device)
    jd = (torch.logaddexp(torch.randn((2, T, d), generator=g),
                          torch.zeros(())) + 0.5).to(device)
    h = torch.randn((2, T, d), generator=g).to(device)  # pads: garbage
    gen = torch.Generator(device=device).manual_seed(seed)
    run = functools.partial(slds.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    with torch.no_grad():
        alone = [run(glob, glob, (jd[i:i + 1, :n], h[i:i + 1, :n]), gen, 1)
                 for i, n in enumerate(lengths)]
        _, stats, _, lkl = run(glob, glob, (jd, h), gen, 1,
                               lengths=torch.tensor(lengths, device=device))
    ref = [a + b for a, b in zip(tree_leaves(alone[0][1]),
                                 tree_leaves(alone[1][1]))]
    stat_rel = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(tree_leaves(stats), ref))
    kl_ref = alone[0][3] + alone[1][3]
    kl_rel = abs(float(lkl - kl_ref)) / abs(float(kl_ref))
    print(f"slds padded-batch theorem (lengths {lengths}, padded to {T}): "
          f"stats rel {stat_rel:.3e}, local KL rel {kl_rel:.3e}")
    if not (stat_rel <= TOL_PAD_REL and kl_rel <= TOL_PAD_REL):
        raise AssertionError("a padded SLDS batch disagrees with its "
                             "sequences")
    return stat_rel, kl_rel


def _device_totals(fn, calls=5):
    """Device ms and device ops per call of ``fn()`` under torch.profiler
    (NaN where no record came back)."""
    spans = _device_spans(fn, calls=calls, warmup=1)
    if not spans:
        return math.nan, math.nan
    return (sum(map(sum, spans.values())) / calls,
            sum(map(len, spans.values())) / calls)


def gmm_path(device="cuda", cfg=GMM_CONFIG):
    """Phase 4g: GMM-SVAE at BASELINE config 1, full batch: 8 steps of
    ``loop.run`` and one ``make_fused_train_step`` call of TRAIN_K steps,
    then ``classify`` of the data; the first step's ELBO and statistics
    against the float64 CPU path under the same noise (rel <=
    TOL_LOGZ_REL); every output finite; ms a step (CUDA events), device
    ms and device ops a step (torch.profiler). No kernel runs here: the
    JAX package's GMM path is XLA ops, and the port's is torch ops."""
    N, K, d, S = (cfg[k] for k in ("N", "K", "d", "S"))
    data = torch.from_numpy(make_pinwheel(seed=0, num_classes=5,
                                          num_per_class=N // 5)).to(device)
    g = torch.Generator().manual_seed(0)
    prior = gmm.init_pgm_param(K, d, g, device=device)
    glob = gmm.init_pgm_param(K, d, g, random_scale=2.0, device=device)
    rec = recognition.init_mlp_recognize(2, (cfg["hidden"],), d, g,
                                         device=device)
    dec = decoders.init_mlp_decode(d, (cfg["hidden"],), 2, g, device=device)
    run = functools.partial(gmm.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    parts = (run, recognition.mlp_recognize, decoders.mlp_loglike, prior, N)
    gen = torch.Generator(device=device).manual_seed(8)

    # the first step against float64 on the CPU, same noise
    eps = torch.randn((S, N, d), generator=gen, device=device)
    cpu64 = lambda t: t.detach().double().cpu()
    obj = elbo.make_objective(functools.partial(run, eps=eps), *parts[1:],
                              num_samples=S)
    obj64 = elbo.make_objective(functools.partial(run, eps=cpu64(eps)),
                                *parts[1:3], tree_map(cpu64, prior), N,
                                num_samples=S)
    with torch.no_grad():
        val, (stats, _) = obj(glob, (rec, dec), data, gen)
        val64, (stats64, _) = obj64(
            tree_map(cpu64, glob),
            tuple(copy.deepcopy(m).double().cpu() for m in (rec, dec)),
            cpu64(data), None)
    rel = abs(float(val) - float(val64)) / abs(float(val64))
    stat_rel = max(float((cpu64(a) - b).abs().max() / b.abs().max())
                   for a, b in zip(tree_leaves(stats), tree_leaves(stats64)))
    print(f"gmm first step vs float64 CPU path: elbo rel {rel:.3e}, stats "
          f"rel {stat_rel:.3e}")
    if not (rel <= TOL_LOGZ_REL and stat_rel <= TOL_LOGZ_REL):
        raise AssertionError("the GMM step disagrees with the f64 reference")

    opt_init, step = loop.make_train_step(*parts, num_samples=S)
    _, fused = loop.make_fused_train_step(*parts, k_steps=TRAIN_K,
                                          num_samples=S)
    pgm, nets, state, history, gen = loop.run(
        step, glob, (rec, dec), opt_init(glob, (rec, dec)), data, gen,
        num_epochs=8, batch_size=N, shuffle=False)
    pgm, nets, state, _, terms, elbos = fused(pgm, nets, state, data, gen)
    with torch.no_grad():
        probs = gmm.classify(pgm, nets[0](data), cfg["sweeps"])
    elbos = history + elbos.tolist()
    _finite([pgm, tuple(terms.values()), probs], "the GMM path")
    if len(elbos) != 8 + TRAIN_K or not np.isfinite(elbos).all():
        raise AssertionError(f"gmm path: bad ELBO history {elbos}")
    if (probs.shape != (N, K) or float((probs.sum(-1) - 1).abs().max())
            > 1e-4):
        raise AssertionError("gmm classify: rows are not distributions")
    print(f"gmm path ({8 + TRAIN_K} steps, N={N}, K={K}, d={d}, "
          f"{cfg['sweeps']} sweeps, S={S}): elbo/N "
          f"{' '.join(f'{e:.4f}' for e in elbos)}; clusters used "
          f"{int(probs.argmax(-1).unique().numel())} of {K}")

    st = [pgm, nets, state]

    def one_step():
        st[0], st[1], st[2], _, _ = step(*st, data, gen)

    ms = _time_ms(one_step, runs=10)
    dev_ms, ops = _device_totals(one_step)
    fused_ms = _time_ms(lambda: fused(*st, data, gen), runs=5, warmup=1)
    print(f"time gmm_train_step: {ms:.4f} ms = {1e3 / ms:.1f} steps/s; "
          f"device {dev_ms:.4f} ms in {ops:.1f} device ops a step (idle "
          f"{1 - dev_ms / ms:.1%}); fused {TRAIN_K}-step call "
          f"{fused_ms:.4f} ms = {TRAIN_K * 1e3 / fused_ms:.1f} steps/s")
    return dict(gmm_train_step=ms, gmm_train_step_device=dev_ms,
                gmm_train_step_ops=ops, gmm_fused=fused_ms)


# the kernels the forecast APIs launch: the stationary filter and sampler
# (#1, #3) for lds.predict, the bpairs filter and sampler (#13, #9) and the
# HMM forward (#15) for the SLDS APIs
FORECAST_WRAPPERS = (estep.filter_fwd, estep.sampler_fwd, bpairs.bidir_fwd,
                     bpairs.sampler_bp_fwd, hmm_fb.hmm_fb_fwd)


def _forecast_launches(fn, want):
    """Run ``fn()`` with the counters at 0; raise unless the forecast
    kernels' launches are ``want`` (others 0) and no plain version ran."""
    _reset_counters()
    out = fn()
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in ALL_WRAPPERS if w.launches}
    plain = sum(p.calls for p in ALL_PLAINS)
    full = {w.__name__: want.get(w.__name__, 0) for w in FORECAST_WRAPPERS}
    if launches != {k: v for k, v in full.items() if v} or plain:
        raise AssertionError(f"launches {launches} (plain calls {plain}), "
                             f"want {want}")
    return out, launches


def _agree(a, b):
    """The share of equal entries of two discrete paths."""
    return float((a.cpu() == b.cpu()).double().mean())


def forecast_path(device="cuda", cfg=SLDS_CONFIG, steps=FORECAST_STEPS):
    """Phase 4f: ``lds.predict`` at config 2 (B=64, T=100, d=10, S=2) and
    ``slds.sample_states`` and ``slds.predict`` at slds_synth (B=16, T=80,
    K=4, d=4, 12 sweeps), ``steps`` forecast steps, each with the counters
    at 0: its launches of #1, #3 (lds) or #13, #15, #9 (slds) and nothing
    else; the window samples against the float64 CPU path under the same
    noise (abs <= TOL_ABS), the discrete paths agreeing on >= 99% of their
    entries (a flip needs a near tie), the rollout agreeing where its z
    path does; every output finite; the event ms of each call, and its
    device ms and device ops."""
    cpu64 = lambda t: t.detach().double().cpu()
    gen = torch.Generator(device=device).manual_seed(9)
    out = {}

    B, T, d, S = 64, 100, 10, 2
    _, glob, rec, _ = _config2_models(device)
    data = torch.from_numpy(make_dot_data(seed=3, num_seqs=B, T=T,
                                          image_width=20)).to(device)
    with torch.no_grad():
        pots = rec(data)
    eps = torch.randn((S, B, T, d), generator=gen, device=device)
    step_eps = torch.randn((steps, S, B, d), generator=gen, device=device)
    call = lambda: lds.predict(glob, pots, gen, steps, S, eps=eps,
                               step_eps=step_eps)
    with torch.no_grad():
        x, launches = _forecast_launches(
            call, {"filter_fwd": 1, "sampler_fwd": 1})
        x64 = lds.predict(tree_map(cpu64, glob), tree_map(cpu64, pots), None,
                          steps, S, eps=cpu64(eps), step_eps=cpu64(step_eps))
        ms = _time_ms(call, runs=10)
        busy = _device_totals(call)
    _finite(x, "lds.predict")
    err = (cpu64(x) - x64).abs()
    window, roll = float(err[:, :, :T].max()), float(err[:, :, T:].max())
    print(f"lds.predict [B={B}, T={T}, d={d}, S={S}, {steps} steps]: "
          f"launches {launches}; vs float64 CPU: window max abs "
          f"{window:.3e}, rollout max abs {roll:.3e}; {ms:.4f} ms, device "
          f"{busy[0]:.4f} ms in {busy[1]:.1f} device ops")
    if x.shape != (B, S, T + steps, d) or max(window, roll) > TOL_ABS:
        raise AssertionError("lds.predict disagrees with the f64 reference")
    out["lds_predict"] = ms

    K, d, T, B, S = (cfg[k] for k in ("K", "d", "T", "B", "S"))
    _, glob, rec, _ = _slds_models(device, K, d, cfg["width"], cfg["hidden"])
    data = torch.from_numpy(make_switching_dot_data(
        2, B, T, cfg["width"])).to(device)
    with torch.no_grad():
        pots = rec(data)
    g0 = hmm.gumbel((B, S, K), gen, torch.float32, device)
    gs = hmm.gumbel((B, T - 1, S, K), gen, torch.float32, device)
    noise = dict(eps=torch.randn((S, B, T, d), generator=gen, device=device),
                 gumbel_noise=(g0, gs),
                 step_eps=torch.randn((steps, S, B, d), generator=gen,
                                      device=device),
                 step_gumbel=hmm.gumbel((steps, S, B, K), gen, torch.float32,
                                        device))
    noise64 = {k: tree_map(cpu64, v) for k, v in noise.items()}
    sweeps = cfg["sweeps"]
    mf = {"bidir_fwd": sweeps + 1, "hmm_fb_fwd": sweeps + 1}
    glob64, pots64 = tree_map(cpu64, glob), tree_map(cpu64, pots)

    states = lambda: slds.sample_states(glob, pots, gen, S, sweeps,
                                        gumbel_noise=noise["gumbel_noise"])
    z, launches = _forecast_launches(states, mf)
    z64 = slds.sample_states(glob64, pots64, None, S, sweeps,
                             gumbel_noise=noise64["gumbel_noise"])
    agree = _agree(z, z64)
    ms = _time_ms(states, runs=10)
    busy = _device_totals(states)
    print(f"slds.sample_states [B={B}, T={T}, K={K}, d={d}, S={S}, "
          f"{sweeps} sweeps]: launches {launches}; paths agree with float64 "
          f"CPU on {agree:.2%} of entries; {ms:.4f} ms, device "
          f"{busy[0]:.4f} ms in {busy[1]:.1f} device ops")
    if z.shape != (B, S, T) or agree < 0.99:
        raise AssertionError("slds.sample_states disagrees with the f64 "
                             "reference")
    out["slds_sample_states"] = ms

    pred = lambda: slds.predict(glob, pots, gen, steps, S, sweeps, **noise)
    (x, z), launches = _forecast_launches(pred, dict(mf, sampler_bp_fwd=1))
    x64, z64 = slds.predict(glob64, pots64, None, steps, S, sweeps,
                            **noise64)
    ms = _time_ms(pred, runs=10)
    busy = _device_totals(pred)
    _finite(x, "slds.predict")
    agree = _agree(z, z64)
    same = (z.cpu() == z64).all(-1)                       # (B, S)
    err = (cpu64(x) - x64).abs()
    window = float(err[:, :, :T].max())
    roll = float(err[:, :, T:][same].max()) if bool(same.any()) else 0.0
    print(f"slds.predict [{steps} steps]: launches {launches}; z paths "
          f"agree with float64 CPU on {agree:.2%} of entries ({int(same.sum())}"
          f" of {same.numel()} whole); window max abs {window:.3e}, rollout "
          f"max abs {roll:.3e} where z agrees; {ms:.4f} ms, device "
          f"{busy[0]:.4f} ms in {busy[1]:.1f} device ops")
    if (x.shape != (B, S, T + steps, d) or agree < 0.99
            or max(window, roll) > TOL_ABS):
        raise AssertionError("slds.predict disagrees with the f64 reference")
    out["slds_predict"] = ms
    return out


# the serving path (phase 4v): 64 streams of config 2's T=100 frames, served
# a frame or a window at a time; the switching filter at slds_synth's
# globals on 16 streams of its T=80 frames
STREAMS = dict(B=64, T=100, windows=(16, 64), slds_B=16)
# the regime weights sum to 1 to float32 rounding after the filter's
# renormalization
TOL_WEIGHTS = 1e-6


def _filter_run(init_fn, step_fn, pots):
    """Every frame of ``pots`` (B, T, d) through an online filter a frame
    at a time: the per-frame outputs stacked on axis 1, and the last
    state."""
    jd, h = pots
    state, out = init_fn((jd[:, 0], h[:, 0]))
    outs = [out]
    for t in range(1, jd.shape[1]):
        state, out = step_fn(state, (jd[:, t], h[:, t]))
        outs.append(out)
    return tuple(torch.stack(o, 1) for o in zip(*outs)), state


def _windows(init_fn, step_fn, pots, W):
    """The frames of ``pots`` through ``streaming.make_window_filter`` in
    windows of W (the last one shorter): the outputs concatenated, and the
    last state."""
    win_init, win_step = streaming.make_window_filter(init_fn, step_fn)
    jd, h = pots
    state, out = win_init((jd[:, :W], h[:, :W]))
    outs = [out]
    for t0 in range(W, jd.shape[1], W):
        state, out = win_step(state, (jd[:, t0:t0 + W], h[:, t0:t0 + W]))
        outs.append(out)
    return tuple(torch.cat(o, 1) for o in zip(*outs)), state


def _max_abs(a, b):
    """:func:`_max_err` of tensors on two devices, on the CPU."""
    return _max_err([x.detach().cpu() for x in a],
                    [y.double().cpu() for y in b])


def streaming_path(device="cuda", cfg=STREAMS, scfg=SLDS_CONFIG):
    """Phase 4v: the serving path. At config 2 (the seeded globals and MLP
    recognizer of phase 4, d=10), 64 streams of T=100 dot frames through
    ``lds.make_online_filter`` a frame at a time in float32: the summed
    log-evidence of each stream against the stationary E-step's logZ
    (kernel #1) within TOL_LOGZ_REL, the filtered means against float64
    ``kalman.lds_filter`` on the CPU within TOL_ABS; the window filter at
    W=16 and W=64 equal to the single frames bit for bit. Then
    ``slds.make_online_filter`` (GPB2) at slds_synth's globals (K=4, d=4)
    on 16 streams of T=80: weights summing to 1 within TOL_WEIGHTS,
    covariances positive definite, log-evidence finite, every output
    against its float64 CPU run within TOL_ABS; at K=1 against the LDS
    filter on the same globals within TOL_ABS. Prints the event ms of a
    step for 1 and for 64 streams, the ms a frame at W=64, a step's device
    ms and ops, and the switching filter's step. Returns the timings."""
    B, T = cfg["B"], cfg["T"]
    _, glob, rec, _ = _config2_models(device)
    frames = torch.from_numpy(make_dot_data(seed=3, num_seqs=B, T=T,
                                            image_width=20)).to(device)
    cpu64 = lambda t: t.detach().double().cpu()
    with torch.no_grad():
        pots = rec(frames)
        init_fn, step_fn = lds.make_online_filter(glob)
        _reset_counters()
        (mean, cov, logev), state = _filter_run(init_fn, step_fn, pots)
        torch.cuda.synchronize()
        launched = {w.__name__: w.launches for w in ALL_WRAPPERS
                    if w.launches}
        logZ = lds.posterior_moments(glob, pots)[3]
        glob64, pots64 = tree_map(cpu64, glob), tree_map(cpu64, pots)
        init, pairs = lds.expected_chain_potentials(glob64, T)
        _, Jf, hf = kalman.lds_filter(
            init, pairs, (-0.5 * torch.diag_embed(pots64[0]), pots64[1]))
        mean64 = torch.linalg.solve(Jf, hf)
    _finite((mean, cov, logev), "lds online filter")
    ev_rel = float(((logev.sum(1).double() - logZ.double()).abs()
                    / logZ.double().abs()).max())
    mean_err = _max_abs((mean,), (mean64,))
    print(f"lds online filter [{B} streams, T={T}, d=10]: launches "
          f"{launched}; summed logev vs the E-step's logZ (kernel #1) max "
          f"rel {ev_rel:.3e}; filtered means vs float64 lds_filter max abs "
          f"{mean_err:.3e}")
    if ev_rel > TOL_LOGZ_REL or mean_err > TOL_ABS:
        raise AssertionError("the LDS online filter disagrees with the "
                             "E-step or the float64 filter")
    with torch.no_grad():
        for W in cfg["windows"]:
            got, st = _windows(init_fn, step_fn, pots, W)
            same = (all(torch.equal(a, b) for a, b in zip(
                got, (mean, cov, logev)))
                and all(torch.equal(a, b) for a, b in zip(st, state)))
            print(f"window filter W={W}: outputs and state bit for bit the "
                  f"single frames': {same}")
            if not same:
                raise AssertionError(f"the window filter at W={W} is not "
                                     f"the single-frame steps bit for bit")

    t = {}
    with torch.no_grad():
        frame = tuple(p[:, T // 2] for p in pots)
        one = (tuple(s[:1] for s in state), tuple(p[:1] for p in frame))
        t["lds_online_step_1"] = _time_ms(lambda: step_fn(*one))
        t["lds_online_step_64"] = _time_ms(lambda: step_fn(state, frame))
        _, win_step = streaming.make_window_filter(init_fn, step_fn)
        W = max(cfg["windows"])
        win = tuple(p[:, :W] for p in pots)
        t["lds_online_window_frame"] = _time_ms(
            lambda: win_step(state, win), runs=10) / W
        busy, ops = _device_totals(lambda: step_fn(state, frame))
    print(f"lds online filter step: {t['lds_online_step_1']:.4f} ms for 1 "
          f"stream, {t['lds_online_step_64']:.4f} ms for {B} streams "
          f"(device {busy:.4f} ms in {ops:.1f} device ops); "
          f"{t['lds_online_window_frame']:.4f} ms a frame in windows of "
          f"{W} for {B} streams")

    # the switching filter (GPB2) at slds_synth's globals
    K, d, Ts, Bs = scfg["K"], scfg["d"], scfg["T"], cfg["slds_B"]
    _, sglob, srec, _ = _slds_models(device, K, d, scfg["width"],
                                     scfg["hidden"])
    sframes = torch.from_numpy(make_switching_dot_data(
        4, Bs, Ts, scfg["width"])).to(device)
    with torch.no_grad():
        spots = srec(sframes)
        sfilt = slds.make_online_filter(sglob)
        outs, sstate = _filter_run(*sfilt, spots)
        torch.cuda.synchronize()
        outs64, _ = _filter_run(
            *slds.make_online_filter(tree_map(cpu64, sglob),
                                     dtype=torch.float64),
            tree_map(cpu64, spots))
    w, smean, scov, slogev = outs
    _finite(outs, "slds online filter")
    w_sum = float((w.double().sum(-1) - 1.0).abs().max())
    psd = int((torch.linalg.cholesky_ex(scov.double()).info != 0).sum())
    gpb2_err = _max_abs(outs, outs64)
    # K=1: the switching filter is the LDS filter
    g = torch.Generator().manual_seed(9)
    glob1 = slds.init_pgm_param(1, d, g, device=device)
    with torch.no_grad():
        one_state, _ = _filter_run(*slds.make_online_filter(glob1), spots)
        lds_out, _ = _filter_run(*lds.make_online_filter(
            (glob1[2], tuple(x[0] for x in glob1[3]))), spots)
    k1_err = _max_abs(one_state[1:], lds_out)
    print(f"slds online filter (GPB2) [{Bs} streams, T={Ts}, K={K}, d={d}]: "
          f"weights sum to 1 within {w_sum:.3e}, {psd} covariances not "
          f"positive definite, vs float64 CPU max abs {gpb2_err:.3e}; K=1 "
          f"vs the LDS filter max abs {k1_err:.3e}")
    if (w_sum > TOL_WEIGHTS or psd or gpb2_err > TOL_ABS
            or k1_err > TOL_ABS):
        raise AssertionError("the SLDS online filter failed a check")
    with torch.no_grad():
        frame = tuple(p[:, Ts // 2] for p in spots)
        t["slds_online_step_16"] = _time_ms(lambda: sfilt[1](sstate, frame))
        busy, ops = _device_totals(lambda: sfilt[1](sstate, frame))
    print(f"slds online filter step: {t['slds_online_step_16']:.4f} ms for "
          f"{Bs} streams (device {busy:.4f} ms in {ops:.1f} device ops)")
    return t


# SLDS_CONFIG's run_inference on the parallel-in-time routes (phase 4q)
SLDS_PARALLEL = (True, CHUNKS)


def slds_parallel_path(device="cuda", cfg=SLDS_CONFIG):
    """Phase 4q: ``slds.run_inference`` at slds_synth (B=16, T=80, K=4,
    d=4, 12 sweeps, S=2; seeded weights, switching dot frames) in float32
    at ``parallel=True`` (the log-depth trees of ``ops.kalman`` and
    ``ops.hmm``, torch ops) and at ``parallel=8`` (the x-steps on the
    element-scan kernels #19/#20) against ``parallel=False`` (the bpairs
    and HMM kernels) under the same noise: local KL and the statistics
    (each leaf's max abs error over its largest entry) within
    TOL_LOGZ_REL, samples within TOL_ABS; one ``make_gradfun`` step
    each, the ELBO within TOL_LOGZ_REL and the natural and net gradients
    normwise within TOL_ADJ_REL; the counters of each run: #19 and #20 at
    ``parallel=8``, no bpairs or HMM kernel on either parallel route, no
    plain version; ``most_likely_states(parallel=True)`` against
    ``parallel=False`` on >= 99% of entries. Prints the train step's event
    ms, device ms and device ops at ``parallel=8`` and ``False``. Returns
    the timings."""
    K, d, T, B, S, N = (cfg[k] for k in ("K", "d", "T", "B", "S", "N"))
    data = torch.from_numpy(make_switching_dot_data(
        5, B, T, cfg["width"])).to(device)
    prior, glob, rec, dec = _slds_models(device, K, d, cfg["width"],
                                         cfg["hidden"])
    run = functools.partial(slds.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    gen = torch.Generator(device=device).manual_seed(11)
    eps = torch.randn((S, B, T, d), generator=gen, device=device)
    with torch.no_grad():
        pots = rec(data)
    sequential = RAGGED_WRAPPERS + HMM_WRAPPERS
    outs, grads, launches = {}, {}, {}
    for parallel in (False,) + SLDS_PARALLEL:
        _reset_counters()
        with torch.no_grad():
            outs[parallel] = run(prior, glob, pots, None, S,
                                 parallel=parallel, eps=eps)
        grad = elbo.make_gradfun(
            functools.partial(run, parallel=parallel, eps=eps),
            recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
            num_samples=S)
        grads[parallel] = grad(glob, (rec, dec), data, gen)[:3]
        torch.cuda.synchronize()
        launches[parallel] = {w.__name__: w.launches for w in ALL_WRAPPERS
                              if w.launches}
        plain = sum(p.calls for p in ALL_PLAINS)
        if plain:
            raise AssertionError(f"slds parallel={parallel} called a plain "
                                 f"version")
    print(f"slds run_inference and make_gradfun launches by route: "
          f"{launches}")
    if (launches[CHUNKS].get("elem_scan", 0) < 1
            or launches[CHUNKS].get("elem_scan_adj", 0) < 1
            or any(w.__name__ in launches[p] for w in sequential
                   for p in SLDS_PARALLEL)):
        raise AssertionError("the parallel SLDS routes did not run their "
                             "kernels alone")
    ref, ref_grad = outs[False], grads[False]
    for parallel in SLDS_PARALLEL:
        samples, stats, _, lkl = outs[parallel]
        kl_rel = abs(float(lkl) - float(ref[3])) / abs(float(ref[3]))
        err = _max_abs((samples,), (ref[0],))
        # the statistics are sums over the batch's frames: each leaf's
        # error relative to its largest entry, as phase 4 holds them
        stat_rel = max(_max_abs((a,), (b,)) / float(b.abs().max())
                       for a, b in zip(tree_leaves(stats),
                                       tree_leaves(ref[1])))
        val, nat, net = grads[parallel]
        val_rel = abs(float(val) - float(ref_grad[0])) / abs(
            float(ref_grad[0]))
        cpu = lambda tree: [x.detach().double().cpu()
                            for x in tree_leaves(tree)]
        nat_rel = _normwise(tree_leaves(nat), cpu(ref_grad[1]))
        net_rel = max(_normwise(g, cpu(g0)) for g, g0 in zip(net,
                                                           ref_grad[2]))
        print(f"slds parallel={parallel} vs parallel=False: local KL rel "
              f"{kl_rel:.3e}, samples max abs {err:.3e}, statistics rel "
              f"{stat_rel:.3e}; elbo rel {val_rel:.3e}, natgrad rel "
              f"{nat_rel:.3e}, net grad rel {net_rel:.3e}")
        if (max(kl_rel, stat_rel, val_rel) > TOL_LOGZ_REL or err > TOL_ABS
                or max(nat_rel, net_rel) > TOL_ADJ_REL):
            raise AssertionError(f"slds parallel={parallel} disagrees with "
                                 f"parallel=False")
    with torch.no_grad():
        paths = [slds.most_likely_states(glob, pots, cfg["sweeps"],
                                         parallel=p) for p in (True, False)]
    agree = _agree(*paths)
    print(f"most_likely_states(parallel=True) vs parallel=False: "
          f"{agree:.2%} of entries agree")
    if agree < 0.99:
        raise AssertionError("most_likely_states(parallel=True) disagrees")

    t = {}
    for parallel in (CHUNKS, False):
        opt_init, step = loop.make_train_step(
            functools.partial(run, parallel=parallel),
            recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
            num_samples=S, pgm_step_size=cfg["pgm_step_size"],
            net_step_size=cfg["net_step_size"])
        nets = tuple(copy.deepcopy(m) for m in (rec, dec))
        st = [glob, nets, opt_init(glob, nets)]

        def one_step():
            st[0], st[1], st[2], _, _ = step(*st, data, gen)

        key = f"slds_train_step_parallel_{parallel}"
        t[key] = _time_ms(one_step, runs=5, warmup=1)
        # two calls: the profiler's host cost grows with the 16,000 ops of
        # a parallel=8 step
        busy, ops = _device_totals(one_step, calls=2)
        print(f"slds_synth train step, parallel={parallel}: {t[key]:.4f} "
              f"ms, device {busy:.4f} ms in {ops:.1f} device ops")
    return t


# BASELINE config 4 (svae_tpu_torch.config.PRESETS["conv_lds"]): the
# conv-LDS's E-step shape, and the ELBO tier there. The float32 tiers of
# tests/test_f32_parity.py were set at T=100; past it the long-T rule of
# PERF.md §2 holds a kernel path to at most twice the float32 plain path's
# error on the same inputs where that plain error is itself past the tier
CONV_SHAPE = dict(B=PRESETS["conv_lds"].train.batch_size,
                  T=PRESETS["conv_lds"].T, d=PRESETS["conv_lds"].d_latent,
                  S=PRESETS["conv_lds"].train.num_samples)
CONV_KERNELS = ("filter_fwd", "filter_adj", "sampler_fwd", "sampler_adj")


def _within(err, plain_err, tier):
    """The tier, or the long-T rule: at most twice the float32 plain
    version's error on the same inputs."""
    return err <= max(tier, 2.0 * plain_err)


@contextlib.contextmanager
def _stationary_twins():
    """``lds.run_inference``'s stationary E-step on its plain twins on
    whatever device the tensors lie (``lds_estep_stationary(plain=True)``,
    the switch that exists for these comparisons)."""
    saved = estep.lds_estep_stationary
    estep.lds_estep_stationary = functools.partial(saved, plain=True)
    try:
        yield
    finally:
        estep.lds_estep_stationary = saved


def conv_lds_path(device="cuda", preset="conv_lds"):
    """Phase 4e: the conv-LDS (BASELINE config 4: N=128, B=8, T=500,
    d_latent=16, 16x16 frames, conv channels (16, 32), kernel 3, decoder
    width 128, S=2, Adam at 1e-3; random weights from the preset's seed)
    through ``examples.conv_lds.main`` and ``experiment.run``. Returns
    ``(launches of the epoch, timings)``."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_conv_")
    try:
        return _conv_lds_path(PRESETS[preset], tmp, device, preset)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _conv_lds_path(cfg, tmp, device, preset):
    def _conv_main(argv):
        return conv_lds.main(["--device", device, "--preset", preset]
                             + argv)

    tc = cfg.train
    steps = cfg.num_seqs // tc.batch_size
    # one epoch with a checkpoint directory and a metrics file
    ckdir, mpath = os.path.join(tmp, "ck"), os.path.join(tmp, "m.jsonl")
    _reset_counters()
    t0 = time.perf_counter()
    hist = _conv_main(["--train.num_epochs", "1", "--train.checkpoint_dir",
                       ckdir, "--train.metrics_path", mpath])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in WRAPPERS}
    plain_calls = {p.__name__: p.calls for p in ALL_PLAINS if p.calls}
    other = {w.__name__: w.launches for w in ALL_WRAPPERS
             if w.launches and w not in WRAPPERS + PASS_WRAPPERS
             + FWD_PASS_WRAPPERS}
    print(f"conv_lds (config 4) epoch through experiment.run ({steps} "
          f"steps, {wall:.1f} s with the data and the checkpoint): "
          f"launches a step "
          f"{ {k: v / steps for k, v in launches.items()} }, plain calls "
          f"{plain_calls}, other kernels {other}")
    if any(v != steps for v in launches.values()) or plain_calls or other:
        raise AssertionError(f"the conv_lds epoch did not run #1-#4 once a "
                             f"step: {launches} {plain_calls} {other}")
    if len(hist) != steps or not np.isfinite(hist).all():
        raise AssertionError(f"conv_lds: bad ELBO history {hist}")
    with open(mpath) as f:
        records = [json.loads(line) for line in f]
    if [r["step"] for r in records] != list(range(steps)):
        raise AssertionError("conv_lds: the metrics file's records")
    latest = ckpt_lib.latest(ckdir)
    if latest is None or not latest.endswith(f"ckpt_{steps}.npz"):
        raise AssertionError(f"conv_lds: checkpoint {latest}")
    print(f"conv_lds: elbo/N {hist[0]:.4f} -> {hist[-1]:.4f}; "
          f"{len(records)} metrics records, step_time_s "
          f"{np.median([r['step_time_s'] for r in records]):.5f} (median); "
          f"{os.path.basename(latest)}")

    # a 2-epoch run preempted after epoch 1 and resumed, against the
    # uninterrupted run
    full = _conv_main(["--train.num_epochs", "2"])
    ckdir2 = os.path.join(tmp, "pre")
    first = _conv_main(["--train.num_epochs", "1", "--train.checkpoint_dir",
                        ckdir2])
    rest = _conv_main(["--train.num_epochs", "2", "--train.checkpoint_dir",
                       ckdir2])
    resumed = np.asarray(first + rest)
    gap = float(np.max(np.abs(resumed - full) / np.abs(np.asarray(full))))
    print(f"conv_lds resume: 2 epochs preempted after 1 and resumed vs "
          f"uninterrupted, largest ELBO gap rel {gap:.3e} (first epoch "
          f"{float(np.max(np.abs(np.asarray(first) - full[:steps]))):.3e} "
          f"abs; no determinism flag set)")
    if len(resumed) != len(full) or not gap <= 1e-3:
        raise AssertionError("conv_lds: the resumed run left the "
                             "uninterrupted trajectory")

    t = conv_step_checks(cfg, device)
    return launches, t


def conv_step_checks(cfg, device="cuda"):
    """One config-4 batch: the ELBO, natural gradient and net gradients on
    the kernels and on the float32 plain path, each against the float64
    CPU path under the same noise, with TF32 off (the nets may use it in
    training; here it would mask the E-step's error; _conv_grads_check); a
    bf16 step's gap to the float32 step; the event ms, busy ms, device ops
    and idle share of a step."""
    _conv_grads_check(cfg, device)
    tc = cfg.train
    data, prior, glob, nets, parts = conv_lds.build(cfg, device)
    B, N, S = tc.batch_size, data.shape[0], tc.num_samples
    batch = data[:B]
    gen = torch.Generator(device=device).manual_seed(4)

    # a bf16 step and a float32 step from the same state and noise
    cfg16 = dataclasses.replace(cfg, net_compute_dtype="bfloat16")
    vals = {}
    for c in (cfg, cfg16):
        _, prior_c, glob_c, nets_c, parts_c = conv_lds.build(c, device)
        opt_init, step = loop.make_train_step(
            *parts_c, prior_c, N, num_samples=S,
            net_step_size=tc.net_step_size, pgm_step_size=tc.pgm_step_size)
        g = torch.Generator(device=device).manual_seed(5)
        out = step(glob_c, nets_c, opt_init(glob_c, nets_c), batch, g)
        _finite([out[0], out[3], tuple(out[4].values())],
                f"the {c.net_compute_dtype} step")
        vals[c.net_compute_dtype] = float(out[3])
    gap16 = abs(vals["bfloat16"] - vals["float32"]) / abs(vals["float32"])
    print(f"conv_lds bf16 step: elbo/N {vals['bfloat16']:.6f} vs float32 "
          f"{vals['float32']:.6f}, rel gap {gap16:.3e}")

    # the step's times
    opt_init, step = loop.make_train_step(*parts, prior, N, num_samples=S)
    st = [glob, nets, opt_init(glob, nets)]

    def one_step():
        st[0], st[1], st[2], _, _ = step(*st, batch, gen)

    ms = _time_ms(one_step, runs=10)
    dev_ms, ops = _device_totals(one_step)
    print(f"time conv_lds_train_step: {ms:.4f} ms = {B * 1e3 / ms:.1f} "
          f"seqs/s; device {dev_ms:.4f} ms in {ops:.1f} device ops a step "
          f"(idle {1 - dev_ms / ms:.1%})")
    return dict(conv_train_step=ms, conv_train_step_device=dev_ms,
                conv_train_step_ops=ops)


def conv_kernels(device="cuda", shape=CONV_SHAPE):
    """#1-#4 alone at config-4 shape: each kernel (float32) and its plain
    version in float32 against the plain version in float64 on the same
    inputs (the forward kernels max abs and the filter's summed ln rel, the
    adjoints normwise rel and max abs), each held to its T=100 tier or to
    twice the float32 plain error; their event ms, device ms, plain ms
    (float32, on the card) and bound. Returns ``{name: row}``."""
    init, mats, nodes, eps = _problem(shape, 0, device)
    B = shape["B"]
    fin = estep.filter_inputs(init, mats, nodes)
    filt64 = estep.filter_fwd_plain(*fin)
    sin = _sampler_problem(fin, filt64[:2], mats, eps, B)
    adj_filt, adj_samp = adjoint_problem(shape, 0, device)
    runs = {
        "filter_fwd": (estep.filter_fwd, estep.filter_fwd_plain, fin),
        "sampler_fwd": (estep.sampler_fwd, estep.sampler_fwd_plain, sin),
        "filter_adj": (estep.filter_adj, estep.filter_adj_plain, adj_filt),
        "sampler_adj": (estep.sampler_adj, estep.sampler_adj_plain,
                        adj_samp)}
    rows = {}
    for name, (kernel, plain, args) in runs.items():
        a32 = _f32(args)
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        outs = {}
        for tag, fn in (("kernel", kernel), ("plain", plain)):
            got = fn(*a32)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            if name.endswith("_adj"):
                outs[tag] = _rel_err(got, want)
            elif name == "filter_fwd":
                outs[tag] = (_max_err(got[:2], want[:2]),
                             _ln_rel(got[2], want[2]))
            else:
                outs[tag] = (_max_err(got, want),)
        tiers = ((TOL_ADJ_REL, math.inf) if name.endswith("_adj") else
                 (TOL_ABS, TOL_LOGZ_REL))
        ok = all(_within(k, p, tier) for k, p, tier in
                 zip(outs["kernel"], outs["plain"], tiers))
        dev = _device_ms(lambda: kernel(*a32))
        row = dict(err=outs["kernel"], plain_err=outs["plain"],
                   ms=_time_ms(lambda: kernel(*a32)),
                   device_ms=sum(v for n, v in dev.items()
                                 if n.startswith(name)),
                   plain_ms=_time_ms(lambda: plain(*a32), runs=3, warmup=1),
                   bound=bound(name, *(shape[k] for k in "BTdS")))
        rows[name] = row
        print(f"config-4 {name} [{shape}]: error {outs['kernel']}, float32 "
              f"plain error {outs['plain']} (vs float64); {row['ms']:.4f} "
              f"ms event, {row['device_ms']:.4f} ms device ("
              + ", ".join(f"{n} {v:.4f}" for n, v in dev.items())
              + f"), plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound'][0]:.6g} ms ({row['bound'][1]})")
        if not ok:
            raise AssertionError(f"{name} at config-4 shape: {outs}")
    return rows


# the example scripts' *_smoke presets, run on the card (phase 4e)
EXAMPLES = ("gmm_pinwheel", "lds_dots", "lds_missing", "lds_ragged",
            "slds_synth", "conv_lds", "bigdata_dp")


def _example_subprocess(name, device):
    """``python -m svae_tpu_torch.examples.<name> --preset <name>_smoke``;
    its ELBO history from the last line (``first_elbo= last_elbo=``)."""
    proc = subprocess.run(
        [sys.executable, "-m", f"svae_tpu_torch.examples.{name}", "--device",
         device, "--preset", f"{name}_smoke"], capture_output=True,
        text=True, timeout=DP_TIMEOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"example {name} exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr}")
    last = proc.stdout.strip().splitlines()[-1]
    fields = dict(kv.split("=") for kv in last.split())
    return [float(fields["first_elbo"]), float(fields["last_elbo"])]


def example_smokes(device="cuda"):
    """Each example script of the port at its ``*_smoke`` preset on the
    card: a finite ELBO history (and the missing-data RMSEs)."""
    for name in EXAMPLES:
        t0 = time.perf_counter()
        if name == "bigdata_dp":
            # it forms a process group: a process of its own, launched as
            # a user would, so that this one never holds a group
            out = _example_subprocess(name, device)
        else:
            mod = importlib.import_module(f"svae_tpu_torch.examples.{name}")
            out = mod.main(["--device", device, "--preset",
                            f"{name}_smoke"])
        hist = (out[0] if name == "lds_ragged" else
                list(out) if name == "lds_missing" else out)
        if not len(hist) or not np.isfinite(hist).all():
            raise AssertionError(f"example {name}: {out}")
        print(f"example {name} ({name}_smoke, {device}): "
              f"{time.perf_counter() - t0:.1f} s, finite")


# BASELINE config 5 (PRESETS["bigdata_dp"]: T=50, d_latent=8, 16-pixel
# frames, MLP (64,), global batch 256, S=2, Adam at 1e-3): the
# data-parallel step. Its corpus is cut to DP_BATCHES global batches.
DP_PRESET = "bigdata_dp"
DP_BATCHES = 20
# The DP step against the single-process step on the same batch and noise,
# float32 on the card: ELBO and terms rel, the updated globals normwise rel,
# the updated nets max abs (against Adam's first step of lr = 1e-3 a
# parameter). One rank: the all_reduce over a one-rank group is the
# identity and both steps run the same float32 ops, so DP_TOL_ONE allows
# only a few ulps' reassociation. Two ranks: the batch's and the
# particles' sums are split between the ranks and added back, which moves
# float32 sums over 256 sequences x 50 steps by ~1e-7-1e-6 relative;
# DP_TOL_TWO is ten times that (a net parameter 1e-5, 1% of a step).
DP_TOL_ONE = 1e-6
DP_TOL_TWO = 1e-5
# time sharding on the card: one sequence, float64, against
# kalman.lds_smoother on the card
TIMESHARD = dict(B=1, T=512, d=10, S=1, ranks=2)
TIMESHARD_RTOL, TIMESHARD_ATOL = 1e-8, 1e-10
DP_TIMEOUT = 900


def _dp_step_check(cfg, mesh, device, seed=7, reference=True):
    """One DP step on this rank's shard of a global batch of ``cfg`` and
    its share of the noise (S particles a shard, the shards' noise the
    global S*M particles split by mesh index), and (``reference``) the
    single-process step on the global batch with all S*M particles, from
    the same initial parameters; returns the differences."""
    from svae_tpu_torch.examples._common import train_kwargs
    from svae_tpu_torch.examples.lds_dots import build
    from svae_tpu_torch.parallel import make_dp_train_step

    tc = cfg.train
    Bg, S, M = tc.batch_size, tc.num_samples, mesh.shape["mc"]
    N = DP_BATCHES * Bg
    batch = torch.from_numpy(make_dot_data(
        seed=seed, num_seqs=Bg, T=cfg.T, image_width=cfg.image_width)).to(
            device)
    eps = torch.randn((S * M, Bg, cfg.T, cfg.d_latent), device=device,
                      generator=torch.Generator(device).manual_seed(seed))
    kw = dict(train_kwargs(tc), num_samples=S)

    def step_out(step, pgm, nets, state, b):
        pgm, nets, _, val, terms = step(pgm, nets, state, b, None)
        return pgm, nets, float(val), {k: float(v) for k, v in terms.items()}

    prior, glob, nets = build(cfg, torch.Generator().manual_seed(tc.seed),
                              device)
    bl = Bg // mesh.shape["data"]
    rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
    shard_eps = eps[mesh.mc_index * S:(mesh.mc_index + 1) * S, rows]
    init, step = make_dp_train_step(
        functools.partial(lds.run_inference, eps=shard_eps),
        recognition.mlp_recognize, decoders.mlp_loglike, prior, N, mesh, Bg,
        **kw)
    got = step_out(step, glob, nets, init(glob, nets), batch[rows])
    if not reference:
        return got, None
    prior, glob, nets = build(cfg, torch.Generator().manual_seed(tc.seed),
                              device)
    init, step = loop.make_train_step(
        functools.partial(lds.run_inference, eps=eps),
        recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
        **dict(kw, num_samples=S * M))
    want = step_out(step, glob, nets, init(glob, nets), batch)
    rel = lambda a, b: abs(a - b) / abs(b)
    errs = dict(
        elbo=rel(got[2], want[2]),
        terms=max(rel(got[3][k], want[3][k]) for k in want[3]),
        globals=_normwise(tree_leaves(got[0]), [
            x.detach().double().cpu() for x in tree_leaves(want[0])]),
        nets=max(float((a - b).detach().abs().max()) for a, b in zip(
            tree_leaves(elbo.net_parameters(got[1])),
            tree_leaves(elbo.net_parameters(want[1])))))
    return got, errs


def _dp_one_rank(rank, out, device, preset):
    """Phase 4d (a), in a process of its own: ``examples.bigdata_dp`` at
    ``preset``'s width on a one-rank group (NCCL on the card), its corpus
    cut to DP_BATCHES global batches, with the launch counters; then on a
    1x1 mesh of a one-rank group the first DP step against
    ``loop.make_train_step`` on the same batch and noise, and the step's,
    the single-process step's and the all_reduce's times."""
    from svae_tpu_torch.examples import bigdata_dp
    from svae_tpu_torch.parallel import make_mesh, multihost

    cfg = PRESETS[preset]
    Bg = cfg.train.batch_size
    res = dict(cut=DP_BATCHES * Bg)
    _reset_counters()
    t0 = time.perf_counter()
    hist = bigdata_dp.main(["--device", device, "--preset", preset,
                            "--num_seqs", str(DP_BATCHES * Bg),
                            "--train.num_epochs", "1"])
    _sync(device)
    res.update(wall=time.perf_counter() - t0, hist=hist,
               launches={w.__name__: w.launches for w in WRAPPERS},
               plain={p.__name__: p.calls for p in ALL_PLAINS if p.calls},
               other={w.__name__: w.launches for w in ALL_WRAPPERS
                      if w.launches and w not in WRAPPERS + PASS_WRAPPERS
                      + FWD_PASS_WRAPPERS})

    multihost.initialize(world_size=1, device=device)
    try:
        mesh = make_mesh()
        res["backend"] = dist.get_backend()
        _, res["errs"] = _dp_step_check(cfg, mesh, device)
        if device == "cuda":
            res.update(_dp_timings(cfg, mesh, device))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, "one_rank.json"), "w") as f:
        json.dump(res, f)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dp_timings(cfg, mesh, device):
    """Event ms, device ms and device ops of a DP step and of
    ``make_train_step``'s at the same shape; the all_reduce's bytes, its
    count a step and its event ms alone."""
    from svae_tpu_torch.examples._common import train_kwargs
    from svae_tpu_torch.examples.lds_dots import build
    from svae_tpu_torch.parallel import make_dp_train_step

    tc = cfg.train
    Bg, N = tc.batch_size, DP_BATCHES * tc.batch_size
    batch = torch.from_numpy(make_dot_data(
        seed=8, num_seqs=Bg, T=cfg.T, image_width=cfg.image_width)).to(device)
    parts = (lds.run_inference, recognition.mlp_recognize,
             decoders.mlp_loglike)
    gen = torch.Generator(device=device).manual_seed(9)
    out = {}
    sizes = []
    all_reduce = dist.all_reduce

    def spy(t, *a, **k):
        sizes.append(t.numel() * t.element_size())
        return all_reduce(t, *a, **k)

    for tag in ("dp", "single"):
        prior, glob, nets = build(
            cfg, torch.Generator().manual_seed(tc.seed), device)
        if tag == "dp":
            init, step = make_dp_train_step(*parts, prior, N, mesh, Bg,
                                            **train_kwargs(tc))
        else:
            init, step = loop.make_train_step(*parts, prior, N,
                                              **train_kwargs(tc))
        st = [glob, nets, init(glob, nets)]

        def one_step():
            st[0], st[1], st[2], _, _ = step(*st, batch, gen)

        if tag == "dp":
            dist.all_reduce = spy
            try:
                one_step()
            finally:
                dist.all_reduce = all_reduce
            _reset_counters()
            one_step()
            torch.cuda.synchronize()
            out["launches_per_step"] = {w.__name__: w.launches
                                        for w in WRAPPERS}
        out[f"{tag}_ms"] = _time_ms(one_step, runs=10)
        out[f"{tag}_device_ms"], out[f"{tag}_ops"] = _device_totals(one_step)
    out["all_reduce_calls"] = len(sizes)
    out["all_reduce_bytes"] = sizes[0]
    buf = torch.zeros(sizes[0] // 4, device=device)
    out["all_reduce_ms"] = _time_ms(lambda: dist.all_reduce(buf))
    return out


def _dp_two_ranks(rank, store, out, device, preset):
    """Phase 4d (b, c), two ranks on one card over gloo: the DP step on
    the meshes (data=2, mc=1) and (data=1, mc=2) against the
    single-process step on the global batch (rank 0) and the replicas'
    fingerprints over both axes; then ``lds_smoother_timeshard`` over the
    two ranks at TIMESHARD's shape in float64 against
    ``kalman.lds_smoother`` on the card."""
    from svae_tpu_torch.parallel import make_mesh, multihost
    from svae_tpu_torch.parallel.time_shard import lds_smoother_timeshard

    multihost.initialize(init_method=f"file://{store}", world_size=2,
                         rank=rank, backend="gloo", device=device,
                         timeout_secs=DP_TIMEOUT)
    res = {}
    try:
        cfg = PRESETS[preset]
        for name, (D, M) in (("data2_mc1", (2, 1)), ("data1_mc2", (1, 2))):
            mesh = make_mesh(data=D, mc=M)
            (pgm, nets, _, _), errs = _dp_step_check(cfg, mesh, device,
                                                     reference=rank == 0)
            res[name] = dict(errs=errs, fingerprint=[
                multihost.assert_replicated_consistent((pgm, nets), mesh,
                                                       axis)
                for axis in ("data", "mc")])

        ts = TIMESHARD
        init, mats, pots, _ = _problem(ts, 5, device)
        pairs, nodes = lds._chain(mats, pots)
        _sync(device)
        t0 = time.perf_counter()
        got = lds_smoother_timeshard(init, pairs, nodes)
        _sync(device)
        res["timeshard_s"] = time.perf_counter() - t0
        if rank == 0:
            t0 = time.perf_counter()
            want = kalman.lds_smoother(init, pairs, nodes)
            _sync(device)
            res["smoother_s"] = time.perf_counter() - t0
            res["timeshard_err"] = max(float((a - b).abs().max())
                                       for a, b in zip(got, want))
            res["timeshard_close"] = all(
                torch.allclose(a, b, rtol=TIMESHARD_RTOL,
                               atol=TIMESHARD_ATOL)
                for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"two_ranks_{rank}.json"), "w") as f:
        json.dump(res, f)


def dp_path(device="cuda", preset=DP_PRESET):
    """Phase 4d: BASELINE config 5's data-parallel SVI, every rank a process
    of its own (spawned and joined with a timeout, so this process never
    holds a process group). Returns the step's timings."""
    from svae_tpu_torch.parallel import multihost

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    try:
        multihost.spawn_local(_dp_one_rank, 1, (tmp, device, preset),
                              DP_TIMEOUT)
        with open(os.path.join(tmp, "one_rank.json")) as f:
            one = json.load(f)
        multihost.spawn_local(_dp_two_ranks, 2,
                              (os.path.join(tmp, "store"), tmp, device,
                               preset), DP_TIMEOUT)
        two = []
        for r in range(2):
            with open(os.path.join(tmp, f"two_ranks_{r}.json")) as f:
                two.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cfg = PRESETS[preset]
    steps = DP_BATCHES
    hist = one["hist"]
    print(f"dp path (BASELINE config 5, {preset}: T={cfg.T}, "
          f"d={cfg.d_latent}, {cfg.image_width}-pixel frames, MLP "
          f"{cfg.hidden}, global batch {cfg.train.batch_size}, S="
          f"{cfg.train.num_samples}; corpus cut to {one['cut']} sequences, "
          f"{steps} batches): examples.bigdata_dp on a one-rank "
          f"{one['backend']} group, {len(hist)} steps in {one['wall']:.1f} s, "
          f"elbo/N {hist[0]:.4f} -> {hist[-1]:.4f}; launches "
          f"{one['launches']} ({cfg.d_latent=} build), plain calls "
          f"{one['plain']}, other kernels {one['other']}")
    if (len(hist) != steps or not np.isfinite(hist).all()
            or any(v != steps for v in one["launches"].values())
            or one["plain"] or one["other"]):
        raise AssertionError("the bigdata_dp run did not run #1-#4 once a "
                             "step and nothing else")
    e = one["errs"]
    print(f"dp step vs make_train_step, 1x1 mesh, same batch and noise "
          f"(elbo rel, terms rel, globals normwise rel, nets max abs): "
          f"{e} (tier {DP_TOL_ONE})")
    if max(e.values()) > DP_TOL_ONE:
        raise AssertionError("the one-rank DP step left make_train_step")
    for name in ("data2_mc1", "data1_mc2"):
        e = two[0][name]["errs"]
        fps = [x for r in two for x in r[name]["fingerprint"]]
        print(f"dp step, 2 ranks on one card (gloo), mesh {name} vs the "
              f"single-process step on the global batch (elbo rel, terms "
              f"rel, globals normwise rel, nets max abs): {e} (tier "
              f"{DP_TOL_TWO}); replicas' fingerprint diff {max(fps)}")
        if max(e.values()) > DP_TOL_TWO or max(fps) != 0.0:
            raise AssertionError(f"the DP step on mesh {name}")
    ts = TIMESHARD
    print(f"time-sharded smoother over 2 ranks (gloo) on the card, float64, "
          f"{ts}: max abs {two[0]['timeshard_err']:.3e} against "
          f"kalman.lds_smoother (rtol {TIMESHARD_RTOL}, atol "
          f"{TIMESHARD_ATOL}); "
          f"{two[0]['timeshard_s']:.3f} s against {two[0]['smoother_s']:.3f}"
          f" s (host clock, first calls)")
    if not two[0]["timeshard_close"]:
        raise AssertionError("lds_smoother_timeshard left lds_smoother")
    t = {k: v for k, v in one.items() if k.endswith(("_ms", "_ops", "_bytes",
                                                     "_calls"))}
    if device == "cuda":
        print(f"time dp_train_step ({preset}, 1x1 mesh, NCCL): "
              f"{t['dp_ms']:.4f} ms event, {t['dp_device_ms']:.4f} ms "
              f"device in {t['dp_ops']:.1f} device ops; make_train_step "
              f"{t['single_ms']:.4f} ms event, {t['single_device_ms']:.4f} "
              f"ms device in {t['single_ops']:.1f} ops; all_reduce "
              f"{t['all_reduce_calls']} a step of {t['all_reduce_bytes']} "
              f"bytes, {t['all_reduce_ms']:.4f} ms event alone; launches a "
              f"step {one['launches_per_step']}")
        if t["all_reduce_calls"] != 1 or any(
                v != 1 for v in one["launches_per_step"].values()):
            raise AssertionError("a DP step is one all_reduce and #1-#4 "
                                 "once each")
    print(f"dp path wall: {time.perf_counter() - t0:.1f} s")
    return t


def elem_problem(shape, seed=0, device="cuda", stiff=False):
    """float64 packed leaves (L, R, B*C) of config-``shape`` chains (the
    expected potentials of random globals and recognizer-like evidence)
    cut into C chunks and folded onto the lanes, as the chunked E-step
    folds them (pad leaves included). ``stiff``: node precisions over
    STIFF_JD."""
    init, mats, nodes, _ = _problem(dict(shape, S=1), seed, device)
    if stiff:
        nodes = (_stiff_jd(nodes[0], seed), nodes[1])
    pairs, nodes = lds._chain(mats, nodes)
    fold, _, L = chunked._fold(kalman.build_leaves(init, pairs, nodes),
                               shape["C"])
    return chunked._pack(fold, L)


def _field_rel(got, want, d):
    """Normwise relative error of each element field of packed
    (L, R, N) elements."""
    return {f: float((a.double() - b).norm() / b.norm()) for f, a, b in
            zip(ELEM_FIELDS, chunked._unpack(got, d), chunked._unpack(want, d))}


def check_elem_scan(shape, seed=0, device="cuda"):
    """Phase 3c: the scan kernel (float32) against its plain version
    (float64) on the same leaves, the adjoint kernels against the plain
    adjoint on the same leaves, prefix and random cotangents, and each
    pass of the adjoint against its own plain version (fed the plain
    output of the pass before it), at ``shape``; raises unless every
    element field is within TOL_LOGZ_REL (the scan) and TOL_ADJ_REL (the
    adjoint and its passes), normwise. Returns ``{kernel: (worst field's
    normwise rel, max abs)}`` (the factor pass: over all of its output)
    and the fields' errors."""
    d = shape["d"]
    leaves = elem_problem(shape, seed, device)
    got = chunked.elem_scan(leaves.float())
    want = chunked.elem_scan_plain(leaves)
    torch.cuda.synchronize()
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    douts = torch.randn(want.shape, generator=g, dtype=want.dtype,
                        device=device)
    dgot = chunked.elem_scan_adj(*_f32((leaves, want, douts)))
    dwant = chunked.elem_scan_adj_plain(leaves, want, douts)
    # the adjoint's passes, each fed the plain output of the one before
    fac = chunked.elem_scan_adj_factor_plain(leaves, want)
    fgot = chunked.elem_scan_adj_factor(*_f32((leaves, want)))
    cwant = chunked.elem_scan_adj_chain_plain(fac, douts)
    cgot = chunked.elem_scan_adj_chain(*_f32((fac, douts)))
    torch.cuda.synchronize()
    fwd, adj = _field_rel(got, want, d), _field_rel(dgot, dwant, d)
    chain = _field_rel(cgot, cwant, d)
    errs = {"elem_scan": (max(fwd.values()), _max_err((got,), (want,))),
            "elem_scan_adj": (max(adj.values()),
                              _max_err((dgot,), (dwant,))),
            "elem_scan_adj_factor": _rel_err((fgot,), (fac,)),
            "elem_scan_adj_chain": (max(chain.values()),
                                    _max_err((cgot,), (cwant,))),
            "fields": {k: (fwd[k], adj[k]) for k in ELEM_FIELDS}}
    if (errs["elem_scan"][0] > TOL_LOGZ_REL
            or any(errs[k][0] > TOL_ADJ_REL for k in ELEM_ADJ_ERRS)):
        raise AssertionError(f"an element-scan kernel disagrees with its "
                             f"plain version at {shape}: {errs}")
    return errs


# the adjoint's entries in the errors of check_elem_scan
ELEM_ADJ_ERRS = ("elem_scan_adj", "elem_scan_adj_factor",
                 "elem_scan_adj_chain")


def chunked_train_path(device="cuda", B=64, T=100, steps=TRAIN_K):
    """Phase 4p: ``steps`` config-2 steps through ``loop.run`` with
    ``run_inference(parallel=CHUNKS)``, the launch counters showing 4
    launches of each element-scan kernel a step (the within-chunk prefix
    and suffix, the chunk-boundary prefix and suffix) and nothing else;
    one step against the float64 CPU path. Returns the launch counts."""
    S, d_obs, d = 2, 20, 10
    N = 50 * B
    data = torch.from_numpy(make_dot_data(
        seed=4, num_seqs=steps * B, T=T, image_width=d_obs)).to(device)
    prior, glob, rec, dec = _config2_models(device)
    run = functools.partial(lds.run_inference, parallel=CHUNKS)
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
        num_samples=S)
    gen = torch.Generator(device=device).manual_seed(9)

    _reset_counters()
    pgm, nets, _, history, gen = loop.run(
        step, glob, (rec, dec), opt_init(glob, (rec, dec)), data, gen,
        num_epochs=1, batch_size=B)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in CHUNK_WRAPPERS}
    others = {w.__name__: w.launches
              for w in WRAPPERS + RAGGED_WRAPPERS + HMM_WRAPPERS}
    plain_calls = {p.__name__: p.calls for p in
                   PLAINS + RAGGED_PLAINS + HMM_PLAINS + CHUNK_PLAINS}
    print(f"chunked train path ({steps} steps, parallel={CHUNKS}): launches "
          f"{launches}, other kernels {others}, plain calls {plain_calls}")
    if launches != {"elem_scan": 4 * steps, "elem_scan_adj": 4 * steps}:
        raise AssertionError(f"a chunked step missed a scan: {launches}")
    if any(others.values()) or any(plain_calls.values()):
        raise AssertionError("the chunked path launched another kernel or "
                             "called a plain version")
    if len(history) != steps or not np.isfinite(history).all():
        raise AssertionError(f"chunked path: bad ELBO history {history}")
    print(f"chunked train path: elbo/N "
          f"{' '.join(f'{e:.4f}' for e in history)}")
    _step_vs_f64(run, pgm, nets, data[:B], gen, prior, N, S, d,
                 f"chunked train step (parallel={CHUNKS})")
    return launches


def long_t_problem(T, seed=11, cfg=LONG_T):
    """float64 CPU globals and recognizer-like evidence (B, T, d) at
    bench_longT's shape."""
    B, d = cfg["B"], cfg["d"]
    g = torch.Generator().manual_seed(seed + T)
    glob = lds.init_pgm_param(d, g, dtype=torch.float64, device="cpu")
    f64 = dict(dtype=torch.float64)
    jd = torch.logaddexp(torch.randn((B, T, d), generator=g, **f64),
                         torch.zeros(())) + 0.5
    return glob, (jd, torch.randn((B, T, d), generator=g, **f64))


def long_t_moments(device="cuda", cfg=LONG_T):
    """Phase 4p: ``posterior_moments(parallel=C)`` at bench_longT's shape,
    float32 on the card, against float64 on the CPU, beside the float32
    plain path (the same call on CPU tensors) and ``parallel=False`` (the
    stationary kernels) on the card. No float32 tier is stated past T=100,
    so the kernels' error may be at most twice the plain path's. Returns
    ``{(T, C): (kernel err, plain err, sequential err, kernel vs
    sequential)}``, each the worst output's normwise relative error."""
    rel = lambda got, want: max(
        float((a.double().cpu() - b).norm() / b.norm())
        for a, b in zip(got, want))
    out = {}
    for T in cfg["Ts"]:
        glob, pots = long_t_problem(T, cfg=cfg)
        f32 = lambda x: x.float()
        glob32, pots32 = tree_map(f32, glob), tree_map(f32, pots)
        on = lambda x: x.to(device)
        globd, potsd = tree_map(on, glob32), tree_map(on, pots32)
        with torch.no_grad():
            seq = lds.posterior_moments(globd, potsd)
            for C in cfg["chunks"]:
                if 2 * C > T:
                    continue
                want = lds.posterior_moments(glob, pots, parallel=C)
                got = lds.posterior_moments(globd, potsd, parallel=C)
                plain = lds.posterior_moments(glob32, pots32, parallel=C)
                errs = (rel(got, want), rel(plain, want), rel(seq, want),
                        rel(got, tree_map(lambda x: x.double().cpu(), seq)))
                out[(T, C)] = errs
                print(f"posterior_moments(parallel={C}) at B={cfg['B']}, "
                      f"T={T}, d={cfg['d']} vs float64: kernels "
                      f"{errs[0]:.3e}, float32 plain path {errs[1]:.3e}, "
                      f"parallel=False {errs[2]:.3e}; kernels vs "
                      f"parallel=False {errs[3]:.3e}")
                if not errs[0] <= 2.0 * errs[1]:
                    raise AssertionError(
                        f"the chunked kernels' moments at T={T}, C={C} err "
                        f"more than twice the float32 plain path's")
    return out


def kfwd_problem(shape, seed=0, device="cuda", stiff=False):
    """float64 inputs of the shared-pair E-step at ``shape``: ``(init,
    pairs, nodes, eps)``, the config-``shape`` expected pairs varied in
    time (KFWD_SHAPES) and recognizer-like diagonal evidence (``stiff``:
    its precisions spread over STIFF_JD)."""
    init, mats, (jd, h), eps = _problem(shape, seed, device)
    if stiff:
        jd = _stiff_jd(jd, seed)
    g = torch.Generator().manual_seed(seed + 500)
    T1 = shape["T"] - 1
    r, s = (1.0 + 0.1 * (2.0 * torch.rand(T1, generator=g,
                                          dtype=torch.float64) - 1.0)
            for _ in range(2))
    r, s = r.to(device)[:, None, None], s.to(device)[:, None, None]
    P1, P2, P3, Pc = mats
    # r scales the pair potential, s its transition matrix: every pair
    # block stays positive semidefinite
    pairs = (r * P1, r * s * P2, r * s * s * P3, Pc.expand(T1).clone())
    return init, pairs, (-0.5 * torch.diag_embed(jd), h), eps


def _cpu64(tree):
    return tree_map(lambda x: torch.as_tensor(x).detach().double().cpu(),
                    tree)


def check_sampler_shared_passes(sin):
    """Each pass of ``sampler_shared`` (float32 kernel) against its own
    plain version (float64) on ``sin`` (``sampler_shared``'s float64
    arguments), the chain (``bpairs.sampler_bp_fwd_chain``) fed the plain
    factor pass's output. Returns ``{pass: max abs error}``, the chain
    under ``sampler_shared_chain``; the callers hold them to TOL_ABS."""
    P2, P3, Jf, hf, eps, xT = sin
    Qc = kalman_fwd.sampler_shared_factor(*_f32((P2, P3, Jf, hf, eps)))
    Qcp = kalman_fwd.sampler_shared_factor_plain(P2, P3, Jf, hf, eps)
    x = bpairs.sampler_bp_fwd_chain(*_f32((*Qcp, xT)))
    xp = bpairs.sampler_bp_fwd_chain_plain(*Qcp, xT)
    torch.cuda.synchronize()
    return {"sampler_shared_factor": _max_err(Qc, Qcp),
            "sampler_shared_chain": _max_err((x,), (xp,))}


def _kfwd_sampler_problem(problem, device):
    """``sampler_shared``'s float64 arguments on ``kfwd_problem``'s
    ``(init, pairs, nodes, eps)``: the forward messages of the float64
    plain filter (on the CPU), the pair rows and the noise on ``device``."""
    init, pairs, nodes, eps = problem
    _, Jf, hf = kalman_fwd.lds_filter(*_cpu64((init, pairs, nodes)))
    return kalman_fwd.sampler_inputs(pairs, Jf.to(device), hf.to(device),
                                     eps)[0]


def check_kalman_fwd(shape, seed=0, device="cuda"):
    """Phase 3k: the three shared-pair kernels (float32) against their
    plain versions (float64) on the same inputs at ``shape``, and each pass
    of the sampler against its own (check_sampler_shared_passes); the
    sampler reads the float64 forward messages. Raises past TOL_ABS
    (messages, samples, the passes) and TOL_LOGZ_REL (the summed
    log-normalizer). Returns the errors."""
    init, pairs, nodes, eps = kfwd_problem(shape, seed, device)
    fin = kalman_fwd.filter_inputs(init, pairs, nodes)
    J, h, ln = kalman_fwd.filter_shared(*_f32(fin))
    Jp, hp, lnp = kalman_fwd.filter_shared_plain(*fin)
    bin_ = kalman_fwd.backward_inputs(pairs, nodes)
    Jb, hb = kalman_fwd.backward_shared(*_f32(bin_))
    Jbp, hbp = kalman_fwd.backward_shared_plain(*bin_)
    sin = _kfwd_sampler_problem((init, pairs, nodes, eps), device)
    x = kalman_fwd.sampler_shared(*_f32(sin))
    xp = kalman_fwd.sampler_shared_plain(*sin)
    torch.cuda.synchronize()
    errs = {"filter_shared": _max_err((J, h), (Jp, hp)),
            "filter_ln_rel": abs(float(ln.double().sum() - lnp.sum()))
            / abs(float(lnp.sum())),
            "backward_shared": _max_err((Jb, hb), (Jbp, hbp)),
            "sampler_shared": _max_err((x,), (xp,)),
            **check_sampler_shared_passes(sin)}
    if not (errs["filter_shared"] <= TOL_ABS
            and errs["filter_ln_rel"] <= TOL_LOGZ_REL
            and errs["backward_shared"] <= TOL_ABS
            and all(errs[k] <= TOL_ABS for k in SAMPLER_SHARED_ERRS)):
        raise AssertionError(f"a shared-pair kernel disagrees with its plain "
                             f"version at {shape}: {errs}")
    return errs


SAMPLER_SHARED_ERRS = ("sampler_shared", "sampler_shared_factor",
                       "sampler_shared_chain")


def check_shared_filters(seed=0, device="cuda"):
    """``filter_shared`` and ``backward_shared`` (float32 kernels) against
    their plain versions (float64) where check_kalman_fwd does not hold
    them: B=37 sequences (a multiple of no count of chains a block but
    one), chains of one step (T=2) at every built d, and a small problem
    whose pair rows P1, P3 and node blocks N1 have their upper triangles
    perturbed (the kernels read A's lower triangle and C in full, and
    carry C's lower triangle, as the plain versions do): J and h within
    TOL_ABS, the forward's ln within TOL_LOGZ_REL normwise over the lanes.
    Raises if not; returns ``{case: (max abs, ln rel)}``."""
    out = {}

    def held(name, init, pairs, nodes):
        fin = kalman_fwd.filter_inputs(init, pairs, nodes)
        bin_ = kalman_fwd.backward_inputs(pairs, nodes)
        J, h, ln = kalman_fwd.filter_shared(*_f32(fin))
        Jb, hb = kalman_fwd.backward_shared(*_f32(bin_))
        torch.cuda.synchronize()
        Jp, hp, lnp = kalman_fwd.filter_shared_plain(*fin)
        err = max(_max_err((J, h), (Jp, hp)), _max_err(
            (Jb, hb), kalman_fwd.backward_shared_plain(*bin_)))
        ln_rel = float((ln.double() - lnp).norm() / lnp.norm())
        if not (err <= TOL_ABS and ln_rel <= TOL_LOGZ_REL):
            raise AssertionError(f"a shared-pair filter disagrees with its "
                                 f"plain version [{name}]: max abs {err}, "
                                 f"ln rel {ln_rel}")
        out[name] = (err, ln_rel)

    held("B37", *kfwd_problem(dict(B=37, T=40, d=10, S=1), seed,
                              device)[:3])
    for d in estep.KERNEL_DIMS:
        held(f"T2_d{d}", *kfwd_problem(dict(B=5, T=2, d=d, S=1), seed + d,
                                       device)[:3])
    init, (P1, P2, P3, Pc), (N1, N2), _ = kfwd_problem(KFWD_SHAPES["small"],
                                                       seed, device)
    d = N2.shape[-1]
    upper = torch.triu(torch.ones(d, d, dtype=N1.dtype, device=device), 1)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    perturb = lambda X: X + 0.3 * upper * torch.randn(
        X.shape, generator=g, dtype=X.dtype, device=device)
    held("asymmetric", init, (perturb(P1), P2, perturb(P3), Pc),
         (perturb(N1), N2))
    return out


# the kernels each entry point of ops/kalman_fwd.py launches, once each
KFWD_ENTRIES = {
    "lds_filter": {"filter_shared": 1},
    "lds_backward": {"backward_shared": 1},
    "lds_smoother": {"filter_shared": 1, "backward_shared": 1},
    "lds_sample": {"filter_shared": 1, "sampler_shared": 1},
    "lds_estep": {"filter_shared": 1, "backward_shared": 1,
                  "sampler_shared": 1},
    "lds_filter_bpairs": {"bidir_fwd": 1},
}


def _kfwd_call(entry, init, pairs, nodes, gen, S, eps):
    fn = getattr(kalman_fwd, entry)
    if entry == "lds_backward":
        return fn(pairs, nodes)
    if entry in ("lds_sample", "lds_estep"):
        return fn(init, pairs, nodes, gen, S, eps=eps)
    if entry == "lds_filter_bpairs":
        B = nodes[1].shape[0]
        return fn(init, bpairs._per_sequence(pairs, B), nodes)
    return fn(init, pairs, nodes)


def kalman_fwd_path(device="cuda", shape=KFWD_SHAPES["config2"]):
    """Phase 4k: each entry point of ops/kalman_fwd.py at config-2 width in
    float32 on the card, the counters set to 0 just before it and read just
    after: it launches exactly the kernels KFWD_ENTRIES names and no plain
    version. Then ``lds_estep`` against ``bpairs.lds_estep`` on the same
    chain and noise (two kernel families) and against the float64 CPU
    path. Returns the launch counts of ``lds_estep``."""
    init, pairs, nodes, eps = kfwd_problem(shape, 3, device)
    init, pairs, nodes, eps = (_f32(init), _f32(pairs), _f32(nodes),
                               eps.float())
    gen = torch.Generator(device=device).manual_seed(4)
    S = shape["S"]
    out = {}
    for entry, want in KFWD_ENTRIES.items():
        _reset_counters()
        out[entry] = _kfwd_call(entry, init, pairs, nodes, gen, S, eps)
        torch.cuda.synchronize()
        got = {w.__name__: w.launches for w in ALL_WRAPPERS if w.launches}
        plain_calls = sum(p.calls for p in ALL_PLAINS)
        print(f"kalman_fwd.{entry}: launches {got}, plain calls "
              f"{plain_calls}")
        if got != want or plain_calls:
            raise AssertionError(f"kalman_fwd.{entry} launched {got} (want "
                                 f"{want}) and {plain_calls} plain calls")
        _finite(out[entry], f"kalman_fwd.{entry}")
        if entry == "lds_estep":
            launches = got
    samples, (Ex, ExxT, Exnxt), logZ = out["lds_estep"]
    if (samples.shape != (S, shape["B"], shape["T"], shape["d"])
            or Exnxt.shape[1] != shape["T"] - 1):
        raise AssertionError("kalman_fwd.lds_estep: wrong shapes")

    def compare(ref, label):
        s_r, m_r, lz_r = ref
        errs = (_max_err((samples,), (s_r.to(device).double(),)),
                _max_err((Ex, ExxT, Exnxt),
                         tuple(m.to(device).double() for m in m_r)),
                float(((logZ.double() - lz_r.to(device).double()).abs()
                       / lz_r.to(device).double().abs()).max()))
        print(f"kalman_fwd.lds_estep vs {label}: samples max abs "
              f"{errs[0]:.3e}, moments max abs {errs[1]:.3e}, logZ rel "
              f"{errs[2]:.3e}")
        if not (errs[0] <= TOL_ABS and errs[1] <= TOL_ABS
                and errs[2] <= TOL_LOGZ_REL):
            raise AssertionError(f"kalman_fwd.lds_estep disagrees with "
                                 f"{label}")

    compare(bpairs.lds_estep(init, pairs, nodes, gen, S, eps=eps),
            "bpairs.lds_estep (same chain and noise)")
    compare(kalman_fwd.lds_estep(*_cpu64((init, pairs, nodes)), None, S,
                                 eps=_cpu64(eps)), "float64 on the CPU")
    return launches


def one_direction_filters(device="cuda", seed=5):
    """Phase 4k: ``bpairs.lds_filter`` and ``bpairs.lds_backward`` (the
    counterparts of pallas_vjp's, ``bidir_fwd`` over one direction's B
    lanes and ``bidir_adj`` as its backward) in float32 on the card against
    their plain versions in float64 on the CPU, values and the gradients
    of a random-weighted sum of every output with respect to the initial,
    pair and node potentials: on per-sequence pairs (a ragged batch of
    RAGGED_SHAPES["ragged"]) and on shared ones (KFWD config 2). Each call
    launches the forward kernel once and the adjoint once, and no plain
    version. Raises past TOL_ABS / TOL_LOGZ_REL (values) and TOL_ADJ_REL
    (gradients, normwise per input). Returns the worst errors."""
    shape = RAGGED_SHAPES["ragged"]
    init, mats, (jd, h), _ = _problem(shape, seed, device)
    lengths = torch.linspace(2, shape["T"], shape["B"]).round().long().to(
        device)
    jd, h, _ = lds._prepare((jd, h), None, lengths)
    cases = {"per-sequence": (init,) + lds._chain(mats, (jd, h), lengths),
             "shared": kfwd_problem(KFWD_SHAPES["config2"], seed,
                                    device)[:3]}
    worst = {"value": 0.0, "logZ_rel": 0.0, "grad_rel": 0.0}
    g = torch.Generator().manual_seed(seed)
    for kind, (init, pairs, nodes) in cases.items():
        leaves = [torch.as_tensor(x).detach()
                  for x in tree_leaves((init, pairs, nodes))]
        for fn in (bpairs.lds_filter, bpairs.lds_backward):
            def run(xs):
                i, p, n = xs[:3], xs[3:7], xs[7:]
                return fn(i, p, n) if fn is bpairs.lds_filter else fn(p, n)

            ins32 = [x.float().requires_grad_() for x in leaves]
            ins64 = [x.double().cpu().requires_grad_() for x in leaves]
            _reset_counters()
            out32 = run(ins32)
            weights = [torch.randn(o.shape, generator=g, dtype=torch.float64)
                       for o in out32]
            loss = sum((w.to(device).float() * o).sum()
                       for w, o in zip(weights, out32))
            grads32 = torch.autograd.grad(loss, ins32, allow_unused=True)
            torch.cuda.synchronize()
            got = {w.__name__: w.launches for w in ALL_WRAPPERS if w.launches}
            plain_calls = sum(p.calls for p in ALL_PLAINS)
            out64 = run(ins64)
            grads64 = torch.autograd.grad(
                sum((w * o).sum() for w, o in zip(weights, out64)), ins64,
                allow_unused=True)
            if got != {"bidir_fwd": 1, "bidir_adj": 1} or plain_calls:
                raise AssertionError(f"bpairs.{fn.__name__}: launches {got}, "
                                     f"plain calls {plain_calls}")
            msgs = slice(1, None) if fn is bpairs.lds_filter else slice(None)
            out32, out64 = _cpu64(out32), _cpu64(out64)
            value = _max_err(out32[msgs], out64[msgs])
            lz_rel = (float(((out32[0] - out64[0]).abs()
                             / out64[0].abs()).max())
                      if fn is bpairs.lds_filter else 0.0)
            grad_rel = max(_normwise((a,), (b,))
                           for a, b in zip(grads32, grads64)
                           if b is not None and float(b.norm()) > 0)
            print(f"bpairs.{fn.__name__} [{kind} pairs] vs float64 plain: "
                  f"launches {got}; messages max abs {value:.3e}, logZ rel "
                  f"{lz_rel:.3e}, gradients normwise {grad_rel:.3e}")
            for k, v in zip(worst, (value, lz_rel, grad_rel)):
                worst[k] = max(worst[k], v)
    if not (worst["value"] <= TOL_ABS and worst["logZ_rel"] <= TOL_LOGZ_REL
            and worst["grad_rel"] <= TOL_ADJ_REL):
        raise AssertionError(f"a one-direction filter disagrees with its "
                             f"plain version: {worst}")
    return worst


def kalman_fwd_timings(device="cuda"):
    """Phase 5, shared-pair kernels: the three kernels and their plain
    versions (the sampler's passes alone, and each one's device time
    within the sampler, _pass_times), and, on the same chains, the
    one-direction launches of the
    bpairs kernels (``bidir_fwd`` over the B forward lanes, as
    ``bpairs.lds_filter`` and ``kalman_fwd.lds_filter_bpairs`` launch it,
    and over the B backward lanes, as ``bpairs.lds_backward`` does;
    ``bidir_adj`` on each) and their plain versions, and
    ``sampler_bp_fwd`` and its passes on the pairs expanded per sequence
    (the routes the shared-pair kernels could have been served by), at
    config-2 width and at the long T; both E-steps on the same chain (CUDA
    events; the plain versions PLAIN_RUNS runs at config 2, 3 at the long
    T; the device time of the three shared-pair kernels, of ``bidir_fwd``
    and of ``sampler_bp_fwd`` on the same chains too)."""
    t = {}
    for tag, name in (("", "config2"), ("_longT", "longT")):
        shape = KFWD_SHAPES[name]
        runs = PLAIN_RUNS if not tag else 3
        init, pairs, nodes, eps = kfwd_problem(shape, 0, device)
        fin = kalman_fwd.filter_inputs(init, pairs, nodes)
        bin_ = kalman_fwd.backward_inputs(pairs, nodes)
        _, Jf, hf = kalman_fwd.lds_filter(*_cpu64((init, pairs, nodes)))
        sin, _ = kalman_fwd.sampler_inputs(pairs, Jf.to(device),
                                           hf.to(device), eps)
        sin32 = _f32(sin)
        one_dir = {
            "fwd_lanes": bpairs._packed(*bpairs._initial(init, nodes),
                                        bpairs._streams(pairs, nodes)),
            "bwd_lanes": bpairs._packed(
                *(torch.zeros_like(x) for x in bpairs._initial(init, nodes)),
                bpairs._reversed(bpairs._streams(pairs, nodes)))}
        g = torch.Generator(device=device).manual_seed(3)
        for k, args in one_dir.items():
            J, h, ln = bpairs.bidir_fwd_plain(*args)
            cots = tuple(torch.randn(x.shape, generator=g, dtype=x.dtype,
                                     device=device) for x in (J, h, ln))
            one_dir[k] = (_f32(args), _f32((*args, J, h, *cots)))
        kernels = {"filter_shared": (kalman_fwd.filter_shared,
                                     kalman_fwd.filter_shared_plain, fin),
                   "backward_shared": (kalman_fwd.backward_shared,
                                       kalman_fwd.backward_shared_plain,
                                       bin_),
                   "sampler_shared": (kalman_fwd.sampler_shared,
                                      kalman_fwd.sampler_shared_plain, sin)}
        for k, (fn, plain, args) in kernels.items():
            args = _f32(args)
            if k != "sampler_shared":
                t[k + tag] = _time_ms(lambda: fn(*args))
                t[k + "_device" + tag] = _device_ms(lambda: fn(*args)).get(
                    k + "_kernel", math.nan)
            t[k + "_plain" + tag] = _time_ms(lambda: plain(*args), runs=runs,
                                             warmup=1)
        # the sampler's passes (the factor pass on the shared rows, then
        # sampler_bp_fwd's chain pass), and on the same chains the served
        # route, sampler_bp_fwd and its passes on the pairs expanded per
        # sequence
        Q, c = kalman_fwd.sampler_shared_factor(*sin32[:5])
        _pass_times(
            t, tag, "sampler_shared",
            lambda: kalman_fwd.sampler_shared(*sin32),
            {"sampler_shared_factor": functools.partial(
                kalman_fwd.sampler_shared_factor, *sin32[:5]),
             "sampler_shared_chain": functools.partial(
                 bpairs.sampler_bp_fwd_chain, Q, c, sin32[5])},
            {"sampler_shared_factor": functools.partial(
                kalman_fwd.sampler_shared_factor_plain, *sin[:5])},
            {"sampler_shared_chain": "sampler_bp_fwd_chain_kernel"})
        bp_sin = _f32(bpairs.sampler_inputs(pairs, Jf.to(device),
                                            hf.to(device), eps)[0])
        Q, c = bpairs.sampler_bp_fwd_factor(*bp_sin[:5])
        _pass_times(
            t, "_served" + tag, "sampler_bp_fwd",
            lambda: bpairs.sampler_bp_fwd(*bp_sin),
            {"sampler_bp_fwd_factor": functools.partial(
                bpairs.sampler_bp_fwd_factor, *bp_sin[:5]),
             "sampler_bp_fwd_chain": functools.partial(
                 bpairs.sampler_bp_fwd_chain, Q, c, bp_sin[5])})
        for k, (fwd, adj) in one_dir.items():
            t[f"bidir_fwd_{k}{tag}"] = _time_ms(lambda: bpairs.bidir_fwd(
                *fwd))
            t[f"bidir_fwd_{k}_device{tag}"] = _device_ms(
                lambda: bpairs.bidir_fwd(*fwd)).get("bidir_fwd_kernel",
                                                    math.nan)
            t[f"bidir_fwd_{k}_plain{tag}"] = _time_ms(
                lambda: bpairs.bidir_fwd_plain(*fwd), runs=runs, warmup=1)
            t[f"bidir_adj_{k}{tag}"] = _time_ms(lambda: bpairs.bidir_adj(
                *adj))
            t[f"bidir_adj_{k}_plain{tag}"] = _time_ms(
                lambda: bpairs.bidir_adj_plain(*adj), runs=runs, warmup=1)
        init32, pairs32, nodes32 = (_f32(init), _f32(pairs), _f32(nodes))
        gen = torch.Generator(device=device).manual_seed(2)
        S = shape["S"]
        t["kalman_fwd_estep" + tag] = _time_ms(lambda: kalman_fwd.lds_estep(
            init32, pairs32, nodes32, gen, S))
        t["bpairs_estep" + tag] = _time_ms(lambda: bpairs.lds_estep(
            init32, pairs32, nodes32, gen, S))
    for k, v in t.items():
        print(f"time {k}: {v:.4f} ms")
    return t


@contextlib.contextmanager
def _twins_on_card():
    """Route the SLDS path's forward kernels to their plain twins, on
    whatever device the tensors lie, to time the twin path beside the
    kernel path (nothing in the package does this)."""
    names = ((bpairs, "bidir_fwd"), (bpairs, "sampler_bp_fwd"),
             (hmm_fb, "hmm_fb_fwd"), (hmm_fb, "hmm_fb_stat_fwd"))
    saved = [getattr(mod, name) for mod, name in names]
    for mod, name in names:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def slds_timings(device="cuda", cfg=SLDS_CONFIG, epochs=2):
    """Phase 5, SLDS path: each HMM kernel and its plain version at the
    slds_synth sweep shape and at measure_hmm's, event and device time,
    and the passes of ``hmm_fb_adj`` and of ``hmm_fb_stat_adj`` alone
    (_pass_times); ``bidir_fwd`` and
    ``sampler_bp_adj`` (with its passes) at the slds_synth x-step's shape
    (BIDIR_ADJ_SHAPES["slds"]: 2B = 32 lanes, T=80, d=4, S=2), event and
    device time; ``slds.run_inference`` at
    measure_slds's shape on the kernels and on the twins; one slds_synth
    train step (CUDA events); and the wall time of an slds_synth epoch
    (host clock around each, ending in a sync; one untimed, then the
    median of ``epochs``)."""
    t = {}
    for tag, shape in (("", HMM_SHAPES["slds"]),
                       ("_measure_hmm", HMM_SHAPES["measure_hmm"])):
        li, lt, lo, _ = hmm_problem(shape, 0, device)
        for fwd, adj in HMM_RUNS:
            args = hmm_kernel_args(li, lt, lo)[fwd]
            g = torch.Generator(device=device).manual_seed(3)
            outs = getattr(hmm_fb, fwd + "_plain")(*args)
            adj_args = _f32((*args, *outs) + tuple(
                torch.randn(o.shape, generator=g, dtype=o.dtype,
                            device=device) for o in outs))
            args = _f32(args)
            if adj == "hmm_fb_adj":
                streamed = adj_args
            else:
                stationary = adj_args
            for name, a, runs in ((fwd, args, TIMING_RUNS),
                                  (adj, adj_args, TIMING_RUNS),
                                  (fwd + "_plain", args, 10),
                                  (adj + "_plain", adj_args, 10)):
                fn = getattr(hmm_fb, name)
                t[name + tag] = _time_ms(lambda: fn(*a), runs=runs)
            for name, a in ((fwd, args), (adj, adj_args)):
                fn = getattr(hmm_fb, name)
                dev = _device_ms(lambda: fn(*a))
                t[name + "_device" + tag] = (sum(dev.values()) if dev
                                             else math.nan)
        # the streamed adjoint's passes alone, with their plain versions,
        # and the device time of each within the whole
        a0, M, alpha, beta, dalpha, dbeta = streamed
        W, V = hmm_fb.hmm_fb_adj_weights(a0, M, alpha, beta)
        g, h, _ = hmm_fb.hmm_fb_adj_chain(W, V, dalpha, dbeta)
        passes = {"hmm_fb_adj_weights": (a0, M, alpha, beta),
                  "hmm_fb_adj_chain": (W, V, dalpha, dbeta),
                  "hmm_fb_adj_dM": (W, V, g, h)}
        _pass_times(
            t, tag, "hmm_fb_adj", lambda: hmm_fb.hmm_fb_adj(*streamed),
            {k: functools.partial(getattr(hmm_fb, k), *a)
             for k, a in passes.items()},
            {k: functools.partial(getattr(hmm_fb, k + "_plain"), *a)
             for k, a in passes.items()})
        # the stationary adjoint's: its weight pass, the chain pass on its
        # weights (hmm_fb_adj_chain's kernel) and its sums pass
        a0, LT, lo, alpha, beta, dalpha, dbeta = stationary
        W, V = hmm_fb.hmm_fb_stat_adj_weights(a0, LT, lo, alpha, beta)
        g, h, _ = hmm_fb.hmm_fb_adj_chain(W, V, dalpha, dbeta)
        passes = {
            "hmm_fb_stat_adj_weights": (hmm_fb.hmm_fb_stat_adj_weights,
                                        (a0, LT, lo, alpha, beta)),
            "hmm_fb_stat_adj_chain": (hmm_fb.hmm_fb_adj_chain,
                                      (W, V, dalpha, dbeta)),
            "hmm_fb_stat_adj_sums": (hmm_fb.hmm_fb_stat_adj_sums,
                                     (W, V, g, h))}
        _pass_times(
            t, tag, "hmm_fb_stat_adj",
            lambda: hmm_fb.hmm_fb_stat_adj(*stationary),
            {k: functools.partial(fn, *a) for k, (fn, a) in passes.items()},
            {k: functools.partial(getattr(hmm_fb, k + "_plain"), *a)
             for k, (_, a) in passes.items()
             if k != "hmm_fb_stat_adj_chain"},
            {"hmm_fb_stat_adj_chain": "hmm_fb_adj_chain_kernel"})

    filt, samp, _ = bpairs_problem(BIDIR_ADJ_SHAPES["slds"], 0, device)
    _bpairs_kernel_times(t, "_slds", _f32(filt), _f32(samp))

    ms = MEASURE_SLDS
    g = torch.Generator().manual_seed(0)
    glob = slds.init_pgm_param(ms["K"], ms["d"], g, device=device)
    jd = (torch.logaddexp(torch.randn((ms["B"], ms["T"], ms["d"]),
                                      generator=g), torch.zeros(()))
          + 0.5).to(device)
    h = torch.randn((ms["B"], ms["T"], ms["d"]), generator=g).to(device)
    gen = torch.Generator(device=device).manual_seed(4)
    infer = lambda: slds.run_inference(glob, glob, (jd, h), gen, ms["S"],
                                       num_meanfield_iters=ms["sweeps"])
    t["slds_run_inference"] = _time_ms(infer)
    with _twins_on_card():
        t["slds_run_inference_twins"] = _time_ms(infer, runs=5, warmup=1)

    N, B = cfg["N"], cfg["B"]
    data = torch.from_numpy(make_switching_dot_data(
        1, N, cfg["T"], cfg["width"])).to(device)
    prior, glob, rec, dec = _slds_models(device, cfg["K"], cfg["d"],
                                         cfg["width"], cfg["hidden"])
    run = functools.partial(slds.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
        num_samples=cfg["S"], pgm_step_size=cfg["pgm_step_size"],
        net_step_size=cfg["net_step_size"])
    st = [glob, (rec, dec), opt_init(glob, (rec, dec))]

    def one_step():
        st[0], st[1], st[2], _, _ = step(*st, data[:B], gen)

    t["slds_train_step"] = _time_ms(one_step, runs=10)
    walls = []
    for i in range(epochs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st[0], st[1], st[2], _, _ = loop.run(step, *st, data, gen,
                                             num_epochs=1, batch_size=B)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    t["slds_epoch_wall"] = float(np.median(walls))
    seqs = {"slds_run_inference": ms["B"], "slds_run_inference_twins":
            ms["B"], "slds_train_step": B, "slds_epoch_wall": N // B * B}
    for k, v in t.items():
        print(f"time {k}: {v:.4f} ms"
              + (f" = {seqs[k] / v * 1e3:.1f} seqs/s" if k in seqs else ""))
    print(f"slds epoch walls (ms): {walls}")
    return t


# the HMM kernels past K=8, at measure_hmm's B and T (phase 3h)
HMM_LARGE_K = (16, 32, 64, 100)


def hmm_large_k(device="cuda", Ks=HMM_LARGE_K):
    """Phase 3h, the largest built K: at measure_hmm's B=128, T=100 with K
    states, the four HMM kernels against their plain versions
    (:func:`check_hmm`), then each kernel's event and device time, its
    plain version's event time and its bound. Returns ``{K: {kernel:
    {...}}}``."""
    rows = {}
    for K in Ks:
        shape = dict(HMM_SHAPES["measure_hmm"], K=K)
        errs = check_hmm(shape, "stationary", K, device)
        li, lt, lo, _ = hmm_problem(shape, K, device)
        g = torch.Generator(device=device).manual_seed(K)
        rows[K] = {}
        for fwd, adj in HMM_RUNS:
            args = hmm_kernel_args(li, lt, lo)[fwd]
            outs = getattr(hmm_fb, fwd + "_plain")(*args)
            adj_args = _f32((*args, *outs) + tuple(
                torch.randn(o.shape, generator=g, dtype=o.dtype,
                            device=device) for o in outs))
            for name, a in ((fwd, _f32(args)), (adj, adj_args)):
                fn, plain = (getattr(hmm_fb, name),
                             getattr(hmm_fb, name + "_plain"))
                dev = _device_ms(lambda: fn(*a))
                b_ms, b_by = bound(name, shape["B"], shape["T"], K, 1)
                rows[K][name] = dict(
                    err=errs[name], ms=_time_ms(lambda: fn(*a)),
                    device_ms=sum(dev.values()) if dev else math.nan,
                    plain_ms=_plain_ms(lambda: plain(*a)),
                    bound_ms=b_ms, bound_by=b_by)
        print(f"hmm kernels at K={K} [{shape}] (normwise rel, max abs; "
              f"event ms, device ms, plain ms, bound): "
              f"{json.dumps(rows[K])}")
    return rows


def _pass_times(t, tag, name, whole, passes, plains=None, kernels=None):
    """Into ``t``: the event time of ``name``, a function run as passes (a
    no-argument call ``whole``), and its device time in its passes'
    kernels (under torch.profiler); for each of its ``passes`` ({pass name:
    call}) the event time of the pass alone and its kernel's device time
    within the whole (the kernel ``<pass name>_kernel``, or
    ``kernels[pass name]``); for each of ``plains`` ({pass name: call of
    its plain version}) the plain version's event time. Keys end in
    ``tag``."""
    kernel = lambda k: (kernels or {}).get(k, k + "_kernel")
    t[name + tag] = _time_ms(whole)
    dev = _device_ms(whole)
    t[name + "_device" + tag] = (sum(dev.get(kernel(k), 0.0)
                                     for k in passes) if dev else math.nan)
    for k, fn in passes.items():
        t[k + tag] = _time_ms(fn)
        t[k + "_device" + tag] = dev.get(kernel(k), math.nan)
    for k, fn in (plains or {}).items():
        t[k + "_plain" + tag] = _plain_ms(fn)
    print(f"device {name}{tag}: {t[name + '_device' + tag]:.4f} ms in its "
          f"kernels, {sum(dev.values()):.4f} ms in all: "
          + ", ".join(f"{n} {v:.4f}" for n, v in dev.items()))


def chunked_timings(device="cuda", cfg=LONG_T):
    """Phase 5, chunked path: the element-scan kernels at the config-2 and
    long-T folds and at the config-2 chunk totals' shape, the adjoint's
    passes alone and the device time of each within the adjoint, and the
    plain versions at the config-2 fold; one chunked
    (``parallel=CHUNKS``) config-2 train step against the sequential one
    (A B B A, the median of each pair of runs); and ``posterior_moments``
    at bench_longT's shape for each C against ``parallel=False`` (CUDA
    events)."""
    t = {}
    for tag, name in (("", "config2"), ("_longT", "longT"),
                      ("_totals", "totals")):
        leaves = elem_problem(ELEM_SHAPES[name], 0, device)
        pref = chunked.elem_scan_plain(leaves)
        g = torch.Generator(device=device).manual_seed(3)
        douts = torch.randn(pref.shape, generator=g, dtype=pref.dtype,
                            device=device)
        args = _f32((leaves, pref, douts))
        fac = chunked.elem_scan_adj_factor(*args[:2])
        scan = lambda: chunked.elem_scan(args[0])
        t["elem_scan" + tag] = _time_ms(scan)
        t["elem_scan_device" + tag] = _device_ms(scan).get(
            "elem_scan_kernel", math.nan)
        print(f"device elem_scan{tag}: {t['elem_scan_device' + tag]:.4f} ms")
        passes = {"elem_scan_adj_factor": lambda: chunked.elem_scan_adj_factor(
                      *args[:2]),
                  "elem_scan_adj_chain": lambda: chunked.elem_scan_adj_chain(
                      fac, args[2])}
        plains = None
        if not tag:
            t["elem_scan_plain"] = _plain_ms(
                lambda: chunked.elem_scan_plain(args[0]))
            t["elem_scan_adj_plain"] = _plain_ms(
                lambda: chunked.elem_scan_adj_plain(*args))
            plains = {
                "elem_scan_adj_factor":
                    lambda: chunked.elem_scan_adj_factor_plain(*args[:2]),
                "elem_scan_adj_chain":
                    lambda: chunked.elem_scan_adj_chain_plain(fac, args[2])}
        _pass_times(t, tag, "elem_scan_adj",
                            lambda: chunked.elem_scan_adj(*args), passes,
                            plains)

    B = SHAPES["config2"]["B"]
    data = torch.from_numpy(make_dot_data(
        seed=2, num_seqs=B, T=SHAPES["config2"]["T"],
        image_width=20)).to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    walls = {}
    for par in (False, CHUNKS):
        prior, glob, rec, dec = _config2_models(device)
        run = functools.partial(lds.run_inference, parallel=par)
        opt_init, step = loop.make_train_step(
            run, recognition.mlp_recognize, decoders.mlp_loglike, prior,
            50 * B, num_samples=SHAPES["config2"]["S"])
        st = [glob, (rec, dec), opt_init(glob, (rec, dec))]

        def one_step(step=step, st=st):
            st[0], st[1], st[2], _, _ = step(*st, data, gen)

        walls[par] = one_step
    runs = {False: [], CHUNKS: []}
    for par in (False, CHUNKS, CHUNKS, False):
        runs[par].append(_time_ms(walls[par], runs=10))
    t["train_step_sequential"] = float(np.median(runs[False]))
    t["train_step_chunked"] = float(np.median(runs[CHUNKS]))
    print(f"train step medians (A B B A): sequential {runs[False]}, "
          f"chunked {runs[CHUNKS]}")

    for T in cfg["Ts"]:
        glob, pots = long_t_problem(T, cfg=cfg)
        on = lambda x: x.float().to(device)
        glob, pots = tree_map(on, glob), tree_map(on, pots)
        t[f"moments_T{T}_sequential"] = _time_ms(
            lambda: lds.posterior_moments(glob, pots))
        for C in cfg["chunks"]:
            if 2 * C <= T:
                t[f"moments_T{T}_C{C}"] = _time_ms(
                    lambda: lds.posterior_moments(glob, pots, parallel=C),
                    runs=10)
    seqs = {"train_step_sequential": B, "train_step_chunked": B}
    seqs.update({k: cfg["B"] for k in t if k.startswith("moments")})
    for k, v in t.items():
        print(f"time {k}: {v:.4f} ms"
              + (f" = {seqs[k] / v * 1e3:.1f} seqs/s" if k in seqs else ""))
    return t


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
        "filter_fwd_plain": _plain_ms(lambda: estep.filter_fwd_plain(*fin)),
        "sampler_fwd": _time_ms(lambda: estep.sampler_fwd(*sin)),
        "sampler_fwd_plain": _plain_ms(lambda: estep.sampler_fwd_plain(*sin)),
        "estep_kernels": _time_ms(lambda: estep.lds_estep_stationary(
            init, mats, nodes, gen, S)),
        "estep_twins": _plain_ms(lambda: estep.lds_estep_stationary(
            init, mats, nodes, gen, S, plain=True)),
    }
    glob = lds.init_pgm_param(shape["d"], torch.Generator().manual_seed(0),
                              device=device)
    t["run_inference"] = _time_ms(lambda: lds.run_inference(
        glob, glob, nodes, gen, S))

    # the sampler's passes alone
    P2, P3, Jfs, hfs, eps_f, xT = sin
    Wc = estep.sampler_fwd_factor(P3, Jfs, hfs, eps_f)
    passes = {
        "sampler_fwd_factor": lambda: estep.sampler_fwd_factor(
            P3, Jfs, hfs, eps_f),
        "sampler_fwd_chain": lambda: estep.sampler_fwd_chain(*Wc, P2, xT)}
    t["sampler_fwd_factor_plain"] = _plain_ms(
        lambda: estep.sampler_fwd_factor_plain(P3, Jfs, hfs, eps_f))
    t["sampler_fwd_chain_plain"] = _plain_ms(
        lambda: estep.sampler_fwd_chain_plain(*Wc, P2, xT))
    # the forward kernels' device time by kernel, beside their event times
    for k, fn in (("filter_fwd", lambda: estep.filter_fwd(*fin)),
                  ("sampler_fwd", lambda: estep.sampler_fwd(*sin)),
                  *passes.items()):
        if k in passes:
            t[k] = _time_ms(fn)
        dev = _device_ms(fn)
        t[k + "_device"] = sum(v for n, v in dev.items() if n.startswith(k))
        print(f"device {k}: {t[k + '_device']:.4f} ms in its kernels, "
              f"{sum(dev.values()):.4f} ms in all: "
              + ", ".join(f"{n} {v:.4f}" for n, v in dev.items()))

    # the adjoints, on float32 copies of the float64 check inputs
    filt, samp = (_f32(a) for a in adjoint_problem(shape, 0, device))
    t["filter_adj"] = _time_ms(lambda: estep.filter_adj(*filt))
    t["filter_adj_plain"] = _plain_ms(lambda: estep.filter_adj_plain(*filt))
    t["sampler_adj"] = _time_ms(lambda: estep.sampler_adj(*samp))
    t["sampler_adj_plain"] = _plain_ms(lambda: estep.sampler_adj_plain(
        *samp))
    # their passes alone (the wrappers' scratch and outputs allocated
    # inside each call, as in the adjoints)
    fac = estep.filter_adj_factor(*filt[:9])
    P2, P3, Jf, hf, eps_s, xT, x, dx = samp
    W = estep.sampler_adj_factor(P3, Jf)
    dhf = estep.sampler_adj_chain(W, P2, xT, x, dx)[0]
    t["filter_adj_factor"] = _time_ms(
        lambda: estep.filter_adj_factor(*filt[:9]))
    t["filter_adj_chain"] = _time_ms(
        lambda: estep.filter_adj_chain(fac, *filt[9:]))
    t["sampler_adj_factor"] = _time_ms(
        lambda: estep.sampler_adj_factor(P3, Jf))
    t["sampler_adj_chain"] = _time_ms(
        lambda: estep.sampler_adj_chain(W, P2, xT, x, dx))
    t["sampler_adj_dJc"] = _time_ms(lambda: estep.sampler_adj_dJc(
        P2, P3, Jf, hf, eps_s, xT, x, dhf))
    # the adjoints' device time by kernel (their event times above count
    # the host's launch time where it is the longer)
    for k, fn in (("filter_adj", lambda: estep.filter_adj(*filt)),
                  ("sampler_adj", lambda: estep.sampler_adj(*samp))):
        dev = _device_ms(fn)
        ours = sum(v for n, v in dev.items() if n.startswith(k))
        t[k + "_device"] = ours
        print(f"device {k}: {ours:.4f} ms in its kernels, "
              f"{sum(dev.values()):.4f} ms in all: "
              + ", ".join(f"{n} {v:.4f}" for n, v in dev.items()))

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


def _bpairs_kernel_times(t, tag, filt, samp, plains=False):
    """Into ``t`` (keys ending in ``tag``), on the float32 problems ``filt``
    and ``samp`` of bpairs_problem: ``bidir_fwd``'s event and device time;
    ``sampler_bp_fwd``'s and ``sampler_bp_adj``'s, and each of their passes
    alone and its device time within the whole (_pass_times), with the
    passes' plain versions if ``plains``."""
    fwd = lambda: bpairs.bidir_fwd(*filt[:8])
    t["bidir_fwd" + tag] = _time_ms(fwd)
    t["bidir_fwd_device" + tag] = _device_ms(fwd).get("bidir_fwd_kernel",
                                                      math.nan)
    P2, P3, Jf, hf, eps, xT, x, dx = samp
    Q, c = bpairs.sampler_bp_fwd_factor(P2, P3, Jf, hf, eps)
    passes = {"sampler_bp_fwd_factor": (bpairs.sampler_bp_fwd_factor,
                                        (P2, P3, Jf, hf, eps)),
              "sampler_bp_fwd_chain": (bpairs.sampler_bp_fwd_chain,
                                       (Q, c, xT))}
    _pass_times(
        t, tag, "sampler_bp_fwd", lambda: bpairs.sampler_bp_fwd(*samp[:6]),
        {k: functools.partial(fn, *a) for k, (fn, a) in passes.items()},
        {k: functools.partial(getattr(bpairs, k + "_plain"), *a)
         for k, (_, a) in passes.items()} if plains else None)
    W = bpairs.sampler_bp_adj_factor(P3, Jf)
    bbar = bpairs.sampler_bp_adj_chain(W, P2, dx)[0]
    dJc_args = (P2, P3, Jf, hf, eps, xT, x, bbar)
    passes = {
        "sampler_bp_adj_factor": (bpairs.sampler_bp_adj_factor, (P3, Jf)),
        "sampler_bp_adj_chain": (bpairs.sampler_bp_adj_chain, (W, P2, dx)),
        "sampler_bp_adj_dJc": (bpairs.sampler_bp_adj_dJc, dJc_args)}
    _pass_times(
        t, tag, "sampler_bp_adj", lambda: bpairs.sampler_bp_adj(*samp),
        {k: functools.partial(fn, *a) for k, (fn, a) in passes.items()},
        {k: functools.partial(getattr(bpairs, k + "_plain"), *a)
         for k, (_, a) in passes.items()} if plains else None)
    print(f"device bidir_fwd{tag}: {t['bidir_fwd_device' + tag]:.4f} ms")


def ragged_timings(device="cuda", seqs=None, B=RAGGED_B, pad=RAGGED_PAD):
    """Phase 5, ragged path: the bpairs kernels at B=64, T=128 and at
    T=512, their plain versions at T=128, ``bidir_fwd``'s device time,
    ``sampler_bp_fwd``'s, ``bidir_adj``'s and ``sampler_bp_adj``'s passes
    alone and the device time of each within the whole (``bidir_adj`` also at
    BIDIR_ADJ_SHAPES), one ragged train step per length
    bucket (CUDA events), and the wall time of a bucketed epoch against
    the same corpus padded to T_max (host clock around each epoch, which
    ends in a sync; one untimed epoch of each, then three of each in
    turns)."""
    t = {}
    for tag, shape in (("", RAGGED_SHAPES["ragged"]), ("_T512", RAGGED_LONG)):
        filt, samp, _ = bpairs_problem(shape, 0, device)
        filt, samp = _f32(filt), _f32(samp)
        _bpairs_kernel_times(t, tag, filt, samp, plains=not tag)
        fac = bpairs.bidir_adj_factor(*filt[:10])
        passes = {"bidir_adj_factor": lambda: bpairs.bidir_adj_factor(
                      *filt[:10]),
                  "bidir_adj_chain": lambda: bpairs.bidir_adj_chain(
                      fac, *filt[10:])}
        plains = None if tag else {
            "bidir_adj_factor": lambda: bpairs.bidir_adj_factor_plain(
                *filt[:10]),
            "bidir_adj_chain": lambda: bpairs.bidir_adj_chain_plain(
                fac, *filt[10:])}
        _pass_times(t, tag, "bidir_adj",
                            lambda: bpairs.bidir_adj(*filt), passes, plains)
        if not tag:
            t["bidir_fwd_plain"] = _plain_ms(
                lambda: bpairs.bidir_fwd_plain(*filt[:8]))
            t["bidir_adj_plain"] = _plain_ms(
                lambda: bpairs.bidir_adj_plain(*filt))
            t["sampler_bp_fwd_plain"] = _plain_ms(
                lambda: bpairs.sampler_bp_fwd_plain(*samp[:6]))
            t["sampler_bp_adj_plain"] = _plain_ms(
                lambda: bpairs.sampler_bp_adj_plain(*samp))
    # bidir_adj at its other shapes
    for name, shape in BIDIR_ADJ_SHAPES.items():
        filt = _f32(one_direction_problem(shape, 0, device)
                    if name == "one_direction" else
                    bpairs_problem(shape, 0, device)[0])
        fac = bpairs.bidir_adj_factor(*filt[:10])
        _pass_times(
            t, "_" + name, "bidir_adj", lambda: bpairs.bidir_adj(*filt),
            {"bidir_adj_factor": lambda: bpairs.bidir_adj_factor(*filt[:10]),
             "bidir_adj_chain": lambda: bpairs.bidir_adj_chain(
                 fac, *filt[10:])})

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


# --------------------------------------------------------------------------
# every latent size up to 32 and every HMM state count on the card
# --------------------------------------------------------------------------

# The E-step routes that pad an unbuilt d to estep.kernel_dim(d): the
# forward wrapper, its twin, its autograd Function (None: forward only), its
# padding, and its adjoint wrapper.
ROUTES = {
    "filter_fwd": (estep.filter_fwd, estep.filter_fwd_plain, estep.FilterFwd,
                   estep.FILTER_PADDING, estep.filter_adj),
    "sampler_fwd": (estep.sampler_fwd, estep.sampler_fwd_plain,
                    estep.SamplerFwd, estep.SAMPLER_PADDING,
                    estep.sampler_adj),
    "bidir_fwd": (bpairs.bidir_fwd, bpairs.bidir_fwd_plain, bpairs.BidirFwd,
                  bpairs.BIDIR_PADDING, bpairs.bidir_adj),
    "sampler_bp_fwd": (bpairs.sampler_bp_fwd, bpairs.sampler_bp_fwd_plain,
                       bpairs.SamplerBp, bpairs.SAMPLER_PADDING,
                       bpairs.sampler_bp_adj),
    "elem_scan": (chunked.elem_scan, chunked.elem_scan_plain,
                  chunked.ElemScan, chunked.LEAF_PADDING,
                  chunked.elem_scan_adj),
    "filter_shared": (kalman_fwd.filter_shared,
                      kalman_fwd.filter_shared_plain, None,
                      kalman_fwd.FILTER_PADDING, None),
    "backward_shared": (kalman_fwd.backward_shared,
                        kalman_fwd.backward_shared_plain, None,
                        kalman_fwd.BACKWARD_PADDING, None),
    "sampler_shared": (kalman_fwd.sampler_shared,
                       kalman_fwd.sampler_shared_plain, None,
                       kalman_fwd.SAMPLER_PADDING, None),
}
# the routes whose outputs end in a summed log-normalizer
ROUTES_LN = ("filter_fwd", "bidir_fwd", "filter_shared")
ROUTE_SHAPE = dict(B=5, T=9, S=3)


def route_problems(d, seed=0, device="cuda", shape=ROUTE_SHAPE):
    """float64 arguments of every route of ROUTES at latent size ``d``: the
    stationary filter's and sampler's, the bpairs filter's and sampler's
    (shared pairs broadcast per sequence), the chunked element scan's (3
    chunks) and the shared-pair filters' and sampler's."""
    shape = dict(shape, d=d)
    init, mats, nodes, eps = _problem(shape, seed, device)
    fin = estep.filter_inputs(init, mats, nodes)
    sin = _sampler_problem(fin, estep.filter_fwd_plain(*fin)[:2], mats, eps,
                           shape["B"])
    pairs, bnodes = lds._chain(mats, nodes)
    bin_ = bpairs.bidir_inputs(init, pairs, bnodes)
    J, h, _ = bpairs.bidir_fwd_plain(*bin_)
    bsin = bpairs.sampler_inputs(pairs, *bpairs.messages(bin_, J, h)[:2],
                                 eps)[0]
    fold, _, L = chunked._fold(kalman.build_leaves(init, pairs, bnodes), 3)
    kinit, kpairs, knodes, _ = kfwd_problem(shape, seed, device)
    kin = kalman_fwd.filter_inputs(kinit, kpairs, knodes)
    kJ, kh, _ = kalman_fwd.filter_shared_plain(*kin)
    ksin = kalman_fwd.sampler_inputs(
        kpairs, *bpairs._alpha(kin[0], kin[1], kJ, kh), eps)[0]
    return {"filter_fwd": fin, "sampler_fwd": sin, "bidir_fwd": bin_,
            "sampler_bp_fwd": bsin, "elem_scan": (chunked._pack(fold, L),),
            "filter_shared": kin,
            "backward_shared": kalman_fwd.backward_inputs(kpairs, knodes),
            "sampler_shared": ksin}


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def check_routes(d, seed=0, device="cuda"):
    """Every E-step route of ROUTES at latent size ``d`` (1 to 32) as the
    models call it (``estep._forward``: at an unbuilt d padded to
    estep.kernel_dim(d)), float32 on the card, against its twin in float64
    at d on the same inputs: the forward outputs (max abs; the summed ln
    rel; the element scan normwise) and, through the autograd Function and
    so the adjoint kernel, the gradients of every input against random
    cotangents (normwise); each route launching its kernel and its adjoint
    once and calling no plain version. Raises past TOL_ABS, TOL_LOGZ_REL,
    TOL_MSG_REL (the scan) and TOL_ADJ_REL. Returns ``{route: errors}``."""
    g = torch.Generator(device=device).manual_seed(seed + 2000)
    errs = {}
    for name, args in route_problems(d, seed, device).items():
        kernel, twin, fn, padding, adj = ROUTES[name]
        want = _tup(twin(*args))
        cots = [torch.randn(w.shape, generator=g, dtype=w.dtype,
                            device=device) for w in want]
        a32 = tuple(a.float().requires_grad_(fn is not None) for a in args)
        wgrads = estep._vjp(twin, args, cots) if fn is not None else None
        torch.cuda.synchronize()
        counts = lambda: (kernel.launches, adj.launches if adj else 0,
                          sum(p.calls for p in ALL_PLAINS))
        before = counts()
        with torch.set_grad_enabled(fn is not None):
            got = _tup(estep._forward(kernel, twin, fn, a32,
                                      padding=padding))
            grads = (torch.autograd.grad(got, a32, [c.float() for c in cots],
                                         allow_unused=True)
                     if fn is not None else None)
        torch.cuda.synchronize()
        moved = [x - y for x, y in zip(counts(), before)]
        got = tuple(x.detach() for x in got)
        if name == "elem_scan":
            e = {"fwd": _rel_err(got, want)[0]}
            ok = e["fwd"] <= TOL_MSG_REL
        else:
            nout = 2 if name in ROUTES_LN else len(want)
            e = {"fwd": _max_err(got[:nout], want[:nout])}
            ok = e["fwd"] <= TOL_ABS
            if name in ROUTES_LN:
                e["ln_rel"] = _ln_rel(got[2], want[2])
                ok = ok and e["ln_rel"] <= TOL_LOGZ_REL
        if fn is not None:
            # the noise gets no cotangent from the samplers' Functions
            used = [(a, b) for a, b in zip(grads, wgrads) if a is not None]
            e["adj"] = _rel_err(*zip(*used))[0]
            ok = ok and e["adj"] <= TOL_ADJ_REL
        if moved != [1, 1 if adj else 0, 0]:
            raise AssertionError(f"route {name} at d={d} did not launch its "
                                 f"kernels once each (kernel, adjoint, plain "
                                 f"calls moved {moved})")
        if not ok:
            raise AssertionError(f"route {name} at d={d} disagrees with its "
                                 f"twin: {e}")
        errs[name] = e
    return errs


def check_routes_refuse(d, device="cuda"):
    """Past the largest built d every route of ROUTES raises ValueError
    naming d on the card, launching nothing; returns the routes' count."""
    for name, args in route_problems(d, 0, device).items():
        kernel, twin, fn, padding, _ = ROUTES[name]
        before = kernel.launches
        try:
            estep._forward(kernel, twin, fn, _f32(args), padding=padding)
        except ValueError as e:
            if f"d={d}" not in str(e):
                raise AssertionError(f"route {name} at d={d} raised without "
                                     f"naming d: {e}") from e
        else:
            raise AssertionError(f"route {name} ran at d={d}")
        if kernel.launches != before:
            raise AssertionError(f"route {name} launched at d={d}")
    return len(ROUTES)


# the largest latent size of the *_wide.cu instances (the checks' d past
# 16; the stiff and non-SPD cases run at 24 too), and the state counts past
# a warp that phase 3h holds: K in {33, 48, 64, 100} and one past the
# runtime-K kernels' block of 128 threads
WIDE_D = 32
HMM_WIDE_K = (33, 48, 64, 100, 160)
# BASELINE config 4 at the top of its latent range, and a latent size the
# kernels serve padded (to 32)
CONV_WIDE_D = WIDE_D
CONV_PAD_D = 28
CONV_WIDE_STEPS = 3


def _conv_steps(cfg, device, steps):
    """``steps`` config-``cfg`` train steps through ``loop.make_train_step``
    on seeded weights: every step launches #1-#4 once and calls no plain
    version. Returns the step's ELBOs."""
    data, prior, glob, nets, parts = conv_lds.build(cfg, device)
    tc = cfg.train
    opt_init, step = loop.make_train_step(
        *parts, prior, data.shape[0], num_samples=tc.num_samples,
        net_step_size=tc.net_step_size, pgm_step_size=tc.pgm_step_size)
    st = [glob, nets, opt_init(glob, nets)]
    gen = torch.Generator(device=device).manual_seed(9)
    B = tc.batch_size
    _reset_counters()
    vals = []
    for i in range(steps):
        j = i % (data.shape[0] // B)
        st[0], st[1], st[2], val, _ = step(*st, data[j * B:(j + 1) * B], gen)
        vals.append(float(val))
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in WRAPPERS}
    plain_calls = {p.__name__: p.calls for p in ALL_PLAINS if p.calls}
    if any(v != steps for v in launches.values()) or plain_calls:
        raise AssertionError(f"config 4 at d={cfg.d_latent}: {steps} steps "
                             f"did not run #1-#4 once a step: {launches} "
                             f"{plain_calls}")
    if not np.isfinite(vals).all():
        raise AssertionError(f"config 4 at d={cfg.d_latent}: ELBOs {vals}")
    return vals, launches


def conv_estep_check(d, device="cuda", seed=3):
    """The stationary E-step at config-4 shape (B=8, T=500, S=2) and latent
    size ``d``: ``lds_estep_stationary`` in float32 on the card (the
    kernels, padded where d is unbuilt) and on its float32 twins, each
    against the twins in float64 on the CPU under the same noise: the
    samples (max abs), the statistics (each leaf's max abs over its
    largest entry) and the local KL (rel), as logZ enters it; the long-T
    rule (PERF.md §2) holds the kernels to their tier or to twice the
    float32 twins' error. Returns ``{"kernels": errs, "plain": errs}``."""
    shape = dict(CONV_SHAPE, d=d)
    init, mats, nodes, eps = _problem(shape, seed, device)
    cpu = lambda xs: tuple(x.cpu() for x in xs)
    ref = estep.lds_estep_stationary(cpu(init), cpu(mats), cpu(nodes), None,
                                     shape["S"], eps=eps.cpu())
    errs = {}
    for tag, plain in (("kernels", False), ("plain", True)):
        out = estep.lds_estep_stationary(_f32(init), _f32(mats),
                                         _f32(nodes), None, shape["S"],
                                         eps=eps.float(), plain=plain)
        torch.cuda.synchronize()
        stats = tree_leaves(out[1])
        errs[tag] = (
            float((out[0].double().cpu() - ref[0]).abs().max()),
            max(float((a.double().cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(stats, tree_leaves(ref[1]))),
            abs(float(out[2]) - float(ref[2])) / abs(float(ref[2])))
    if not all(_within(k, p, tier) for k, p, tier in zip(
            errs["kernels"], errs["plain"],
            (TOL_ABS, TOL_LOGZ_REL, TOL_LOGZ_REL))):
        raise AssertionError(f"the config-4 E-step at d={d} disagrees with "
                             f"float64: {errs}")
    return errs


def _conv_grads_check(cfg, device="cuda"):
    """One config-``cfg`` batch: the ELBO, natural gradient and net
    gradients on the kernels and on the float32 plain path, each against
    the float64 CPU path under the same noise, with TF32 off; raises past
    the tiers (or twice the float32 plain path's error). Returns the
    errors (elbo rel, natgrad rel, worst net grad rel) of each."""
    tc = cfg.train
    data, prior, glob, nets, parts = conv_lds.build(cfg, device)
    B, N, S = tc.batch_size, data.shape[0], tc.num_samples
    batch = data[:B]
    gen = torch.Generator(device=device).manual_seed(4)
    eps = torch.randn((S, B, cfg.T, cfg.d_latent), generator=gen,
                      device=device)
    cpu64 = lambda x: x.detach().double().cpu()

    def grads(run_eps, pgm, nets, batch, prior):
        fn = elbo.make_gradfun(functools.partial(parts[0], eps=run_eps),
                               *parts[1:], prior, N, num_samples=S)
        return fn(pgm, nets, batch, None)

    with f32_linalg():
        got = grads(eps, glob, nets, batch, prior)
        with _stationary_twins():
            plain = grads(eps, glob, nets, batch, prior)
        torch.cuda.synchronize()
    nets64 = tuple(copy.deepcopy(m).double().cpu() for m in nets)
    want = grads(cpu64(eps), tree_map(cpu64, glob), nets64, cpu64(batch),
                 tree_map(cpu64, prior))
    errs = {}
    for name, res in (("kernels", got), ("plain f32", plain)):
        val, nat, net_grads, _ = res
        errs[name] = (abs(float(val) / float(want[0]) - 1.0),
                      _normwise(tree_leaves(nat), tree_leaves(want[1])),
                      max(_normwise(g, g64)
                          for g, g64 in zip(net_grads, want[2])))
    print(f"conv_lds step at d={cfg.d_latent} vs float64 CPU path (elbo "
          f"rel, natgrad rel, worst net grad rel): kernels "
          f"{errs['kernels']}, float32 plain {errs['plain f32']}")
    tiers = (TOL_LOGZ_REL, TOL_ADJ_REL, TOL_ADJ_REL)
    if not all(_within(k, p, tier) for k, p, tier in
               zip(errs["kernels"], errs["plain f32"], tiers)):
        raise AssertionError(f"the config-4 step at d={cfg.d_latent} "
                             f"disagrees with the f64 reference")
    return errs


def conv_wide_path(device="cuda"):
    """Phase 4w: BASELINE config 4 (the conv_lds preset: N=128, B=8, T=500,
    convs (16, 32), S=2) at d_latent=32 on the d=32 instances of #1-#4:
    CONV_WIDE_STEPS train steps, each launching #1-#4 once; the E-step
    (conv_estep_check) and a step's ELBO and gradients against float64
    (conv_step_checks, with its bf16 step and the step's times); #1-#4
    alone at that shape (conv_kernels) and on inputs padded from d=28 to
    the same instance; then the same steps, E-step and step check at
    d_latent=CONV_PAD_D (28), through the padded route. Returns
    ``(launches of the d=32 steps, {kernel: row}, timings)``."""
    cfg = dataclasses.replace(PRESETS["conv_lds"], d_latent=CONV_WIDE_D)
    vals, launches = _conv_steps(cfg, device, CONV_WIDE_STEPS)
    print(f"config 4 at d={CONV_WIDE_D}: {CONV_WIDE_STEPS} train steps, "
          f"elbo/N {vals}, launches {launches}")
    print(f"config-4 E-step at d={CONV_WIDE_D} vs float64 (samples max "
          f"abs, statistics rel, local KL rel): "
          f"{conv_estep_check(CONV_WIDE_D, device)}")
    t = conv_step_checks(cfg, device)
    shape = dict(CONV_SHAPE, d=CONV_WIDE_D)
    rows = conv_kernels(device, shape)
    # the same instances on inputs padded from CONV_PAD_D
    init, mats, nodes, eps = _problem(dict(shape, d=CONV_PAD_D), 0, device)
    fin = estep.filter_inputs(init, mats, nodes)
    sin = _sampler_problem(fin, estep.filter_fwd_plain(*fin)[:2], mats, eps,
                           shape["B"])
    for name, args, padding in (
            ("filter_fwd", fin, estep.FILTER_PADDING),
            ("sampler_fwd", sin, estep.SAMPLER_PADDING)):
        a32 = padding.pad(_f32(args), CONV_PAD_D, CONV_WIDE_D)
        kernel = getattr(estep, name)
        dev = _device_ms(lambda: kernel(*a32))
        rows[name]["padded_device_ms"] = sum(
            v for n, v in dev.items() if n.startswith(name))
        print(f"config-4 {name} on inputs padded from d={CONV_PAD_D} to "
              f"{CONV_WIDE_D}: {rows[name]['padded_device_ms']:.4f} ms "
              f"device")
    cfgp = dataclasses.replace(PRESETS["conv_lds"], d_latent=CONV_PAD_D)
    vals, lp = _conv_steps(cfgp, device, 1)
    print(f"config 4 at d={CONV_PAD_D} (padded to {CONV_WIDE_D}): a train "
          f"step, elbo/N {vals}, launches {lp}; E-step vs float64 "
          f"{conv_estep_check(CONV_PAD_D, device)}")
    _conv_grads_check(cfgp, device)
    return launches, rows, t


def wide_kernel_timings(device="cuda", d=WIDE_D, pad_d=CONV_PAD_D):
    """The d-templated kernels off config 4's path at d=32 and config 4's B
    and T (B=8, T=500, S=2; the element scans at the CHUNKS-chunk fold):
    each kernel's event ms, its device ms (every kernel of the call), its
    float32 plain version's event ms and its bound; each forward kernel's
    device ms also on inputs padded from d=28 to the same instance (the
    adjoints run that instance on the same shapes). Returns ``{name:
    row}``."""
    shape = dict(CONV_SHAPE, d=d)
    B, T, S, C = shape["B"], shape["T"], shape["S"], CHUNKS
    g = torch.Generator(device=device).manual_seed(21)

    def problems(dd):
        sh = dict(shape, d=dd)
        filt, samp, _ = bpairs_problem(sh, 0, device)
        leaves = elem_problem(dict(sh, C=C), 0, device)
        pref = chunked.elem_scan_plain(leaves)
        douts = torch.randn(pref.shape, generator=g, dtype=pref.dtype,
                            device=device)
        init, pairs, nodes, eps = kfwd_problem(sh, 0, device)
        kin = kalman_fwd.filter_inputs(init, pairs, nodes)
        J, h, _ = kalman_fwd.filter_shared_plain(*kin)
        ksin = kalman_fwd.sampler_inputs(
            pairs, *bpairs._alpha(kin[0], kin[1], J, h), eps)[0]
        return {
            "bidir_fwd": (filt[:8], bpairs.BIDIR_PADDING),
            "bidir_adj": (filt, None),
            "sampler_bp_fwd": (samp[:6], bpairs.SAMPLER_PADDING),
            "sampler_bp_adj": (samp, None),
            "elem_scan": ((leaves,), chunked.LEAF_PADDING),
            "elem_scan_adj": ((leaves, pref, douts), None),
            "filter_shared": (kin, kalman_fwd.FILTER_PADDING),
            "backward_shared": (kalman_fwd.backward_inputs(pairs, nodes),
                                kalman_fwd.BACKWARD_PADDING),
            "sampler_shared": (ksin, kalman_fwd.SAMPLER_PADDING)}

    modules = {"elem_scan": chunked, "elem_scan_adj": chunked,
               "filter_shared": kalman_fwd, "backward_shared": kalman_fwd,
               "sampler_shared": kalman_fwd}
    padded = problems(pad_d)
    rows = {}
    for name, (args, padding) in problems(d).items():
        mod = modules.get(name, bpairs)
        fn, plain = getattr(mod, name), getattr(mod, name + "_plain")
        a32 = _f32(args)
        dev = _device_ms(lambda: fn(*a32))
        bshape = ((B * C, -(-(T - 1) // C), d, 1)
                  if name.startswith("elem_scan") else (B, T, d, S))
        row = dict(ms=_time_ms(lambda: fn(*a32)),
                   device_ms=sum(dev.values()) if dev else math.nan,
                   plain_ms=_time_ms(lambda: plain(*a32), runs=2, warmup=1),
                   bound=bound(name, *bshape))
        if padding is not None:
            p32 = padding.pad(_f32(padded[name][0]), pad_d, d)
            pdev = _device_ms(lambda: fn(*p32))
            row["padded_device_ms"] = (sum(pdev.values()) if pdev
                                       else math.nan)
        rows[name] = row
        print(f"{name} at d={d} [{shape}] (event ms, device ms, float32 "
              f"plain ms, bound; device ms padded from d={pad_d}): "
              f"{json.dumps(row)}")
    return rows


# an SLDS with many discrete states: slds_synth's other settings at K=64
SLDS_WIDE_K = 64


def slds_wide_k_path(device="cuda", cfg=SLDS_CONFIG, K=SLDS_WIDE_K):
    """Phase 4m: an SLDS at slds_synth's settings (d=4, T=80, B=16, S=2, 12
    sweeps; seeded weights, switching dot frames) with K=64 states, whose
    z-steps run the runtime-K HMM kernels (a chain a block):
    ``run_inference`` with no gradient, its launches and its local KL and
    statistics against the float64 CPU path under the same noise; one train
    step (``loop.make_train_step``) launching hmm_fb_fwd and hmm_fb_adj;
    one ``make_gradfun`` step against float64 (_step_vs_f64). Returns the
    train step's launches and event ms."""
    d, T, B, S, N = (cfg[k] for k in ("d", "T", "B", "S", "N"))
    data = torch.from_numpy(make_switching_dot_data(
        6, 2 * B, T, cfg["width"])).to(device)
    prior, glob, rec, dec = _slds_models(device, K, d, cfg["width"],
                                         cfg["hidden"])
    run = functools.partial(slds.run_inference,
                            num_meanfield_iters=cfg["sweeps"])
    gen = torch.Generator(device=device).manual_seed(13)
    eps = torch.randn((S, B, T, d), generator=gen, device=device)
    with torch.no_grad():
        pots = rec(data[:B])
        _reset_counters()
        out = run(glob, glob, pots, None, S, eps=eps)
        torch.cuda.synchronize()
        hmm_launches = {w.__name__: w.launches for w in HMM_WRAPPERS}
        cpu64 = lambda x: x.detach().double().cpu()
        ref = run(tree_map(cpu64, glob), tree_map(cpu64, glob),
                  tree_map(cpu64, pots), None, S, eps=cpu64(eps))
    kl_rel = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
    stat_rel = max(float((a.double().cpu() - b).abs().max()
                         / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(tree_leaves(out[1]), tree_leaves(ref[1])))
    samp = float((out[0].double().cpu() - ref[0]).abs().max())
    print(f"slds K={K} run_inference (B={B}, T={T}, d={d}, "
          f"{cfg['sweeps']} sweeps): hmm launches {hmm_launches}; vs "
          f"float64 local KL rel {kl_rel:.3e}, statistics rel "
          f"{stat_rel:.3e}, samples max abs {samp:.3e}")
    if hmm_launches["hmm_fb_fwd"] != cfg["sweeps"] + 1:
        raise AssertionError(f"slds K={K}: the z-steps did not run the HMM "
                             f"kernel once a sweep: {hmm_launches}")
    if not (kl_rel <= TOL_LOGZ_REL and stat_rel <= TOL_LOGZ_REL
            and samp <= TOL_ABS):
        raise AssertionError(f"slds K={K}: run_inference disagrees with "
                             f"float64")
    opt_init, step = loop.make_train_step(
        run, recognition.mlp_recognize, decoders.mlp_loglike, prior, N,
        num_samples=S, pgm_step_size=cfg["pgm_step_size"],
        net_step_size=cfg["net_step_size"])
    st = [glob, (rec, dec), opt_init(glob, (rec, dec))]

    def one_step():
        st[0], st[1], st[2], val, _ = step(*st, data[B:], gen)
        return val

    _reset_counters()
    val = one_step()
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in HMM_WRAPPERS}
    if (launches["hmm_fb_fwd"] != cfg["sweeps"] + 1
            or launches["hmm_fb_adj"] != 2 or not math.isfinite(float(val))):
        raise AssertionError(f"slds K={K} train step: launches {launches}, "
                             f"elbo {float(val)}")
    ms = _time_ms(one_step, runs=5, warmup=1)
    print(f"slds K={K} train step: launches {launches}, elbo/N "
          f"{float(val):.4f}, {ms:.4f} ms")
    _step_vs_f64(run, st[0], st[1], data[:B], gen, prior, N, S, d,
                 f"slds K={K} step")
    return launches, dict(slds_wide_k_train_step=ms)


def bound(name, B, T, d, S, NL=None):
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
    early exit. For the HMM kernels ``d`` is the number of states K and
    ``S`` is not read; each add, max, exp and log counts one operation.
    ``NL`` is the lane count of the bidir kernels, 2B unless one
    direction's B lanes run alone. The shared-pair kernels read each pair
    row once, not once per lane."""
    dd, T1, SB = d * d, T - 1, S * B
    NL = 2 * B if NL is None else NL
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
    elif name == "sampler_fwd_factor":
        # one (step, sequence) a thread: chol d^3/3, L^-1 hf d^2, S solves
        # S d^2, the inverse d^3/3 + d^3/3
        chains = B
        step = d ** 3 + (1 + S) * d * d
        # in: P3, Jf, hf, eps; out: W, c
        floats = tri + T1 * (tri + d) * B + T1 * d * SB + T1 * dd * B + \
            T1 * d * SB
    elif name == "sampler_fwd_chain":
        chains = SB
        # P2^T x and W times it, 2 d^2 each
        step = 4 * d * d
        # in: W (symmetric), c, P2, xT; out: x
        floats = T1 * tri * B + T1 * d * SB + dd + d * SB + T1 * d * SB
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
    elif name == "bidir_adj_factor":
        # one (step, lane) a thread: chol d^3/3, W = M^-1 2 d^3/3,
        # K = W D^T 2 d^3, w 2 d^2
        chains = NL
        step = 3 * d ** 3 + 2 * d * d
        # in: J0, h0, A, D, f, the forward's J, h as the pre-step messages
        # of steps 1..T-2; out: fac = [W, K, w]
        floats = ((tri + d) * NL + T1 * (tri + dd + d) * NL
                  + (T1 - 1) * (tri + d) * NL + T1 * (2 * dd + d) * NL)
    elif name == "bidir_adj_chain":
        # P = K Gs 2 d^3, a = K g 2 d^2, P K^T 2 d^3, the outer products
        # and sums of M-bar and h-bar 8 d^2, dD 2 d^2
        chains = NL
        step = 4 * d ** 3 + 12 * d * d
        # in: fac, dJ, dh, dln; out: dA, dC, dD, dE, dF, dJ0, dh0
        floats = (T1 * (2 * dd + d) * NL + T1 * (dd + d) * NL + NL
                  + T1 * (3 * dd + 2 * d) * NL + (dd + d) * NL)
    elif name == "bidir_fwd":
        chains = NL
        # Gauss-Jordan on [M | D^T | v]: round k updates d-1 rows of the
        # d-k-1 columns of M right of the pivot and the d+1 columns on the
        # right, (d-1)(3d^2 + d)/2 multiply-adds in all; D X_D d^3, D X_v
        # d^2, v . X_v d; J' and h' d^2 + d
        step = 2 * ((d - 1) * (3 * d * d + d) / 2 + d ** 3 + 2 * d * d
                    + 2 * d)
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
    elif name.startswith("sampler_bp_fwd"):
        # per (step, sequence), S = the samples: the factor pass's chol
        # d^3/3, Q = Jc^-1 P2^T by two triangular solves a column 2 d^3,
        # L^-1 hf d^2 and a back substitution d^2 a sample; the chain's
        # Q x 2 d^2 a sample
        chains = B
        ops = {"factor": 7 * d ** 3 / 3 + (1 + S) * d * d,
               "chain": 2 * d * d * S}
        if name == "sampler_bp_fwd_factor":
            step = ops["factor"]
            # in: P2, P3 and Jf (lower triangles), hf, eps; out: Q, c
            floats = T1 * (2 * dd + 2 * tri + d) * B + 2 * T1 * d * SB
        elif name == "sampler_bp_fwd_chain":
            step = ops["chain"]
            # in: Q, c, xT; out: x
            floats = T1 * dd * B + 2 * T1 * d * SB + d * SB
        else:
            step = sum(ops.values())
            # in: P2, P3, Jf, hf per sequence, eps, xT; out: x
            floats = T1 * (dd + 2 * tri + d) * B + 2 * T1 * d * SB + d * SB
    elif name.startswith("sampler_bp_adj"):
        # per (step, sequence) of the three passes, S = the samples: the
        # factor pass's chol d^3/3 and inverse 2 d^3/3; the chain's W x-bar
        # and P2 b-bar 4 d^2 a sample; the dJc pass's chol d^3/3, L^-1
        # d^3/3 and Linv^T Z Linv 4 d^3/3 once, and per sample b 2 d^2, w
        # and u 2 d^2, Z 3 d^2, dP2 2 d^2 and dhf d
        chains = B
        ops = {"factor": d ** 3, "chain": 4 * d * d * S,
               "dJc": 2 * d ** 3 + S * (9 * d * d + d)}
        if name == "sampler_bp_adj_factor":
            step = ops["factor"]
            # in: P3, Jf (lower triangles); out: W
            floats = T1 * (2 * tri + dd) * B
        elif name == "sampler_bp_adj_chain":
            step = ops["chain"]
            # in: W (symmetric), P2, dx; out: bbar, dxT
            floats = T1 * (tri + dd) * B + 2 * T1 * d * SB + d * SB
        elif name == "sampler_bp_adj_dJc":
            step = ops["dJc"]
            # in: P2, P3, Jf, hf, eps, xT, x (steps 1..T-2), bbar; out:
            # dP2, dP3, dJf, dhf
            floats = (T1 * (dd + 2 * tri + d) * B + 3 * T1 * d * SB
                      + T1 * (3 * dd + d) * B)
        else:
            step = sum(ops.values())
            # in: P2, P3, Jf, hf, xT, x (steps 1..T-2), dx (not the noise:
            # x determines it); out: dP2, dP3, dJf, dhf (summed over the
            # samples), dxT
            floats = (T1 * (dd + 2 * tri + d) * B + T1 * (3 * dd + d) * B
                      + (2 * T1 - 1) * d * SB + 2 * d * SB)
    elif name in ("filter_shared", "backward_shared"):
        chains = B
        # bidir_fwd's step (filter_chain.cuh): the Gauss-Jordan elimination
        # of [M | D^T | v], D X_D d^3, D X_v d^2, J' and h' d^2 + d, and
        # the forward's v . X_v d
        step = 2 * ((d - 1) * (3 * d * d + d) / 2 + d ** 3 + 2 * d * d + d
                    + (d if name == "filter_shared" else 0))
        # in: the shared rows P1, P3 (lower triangle), P2, and pc (the
        # backward filter does not read pc), the node streams N1 (lower
        # triangle) and N2, the filter's J0, h0; out: J, h, and ln
        floats = (T1 * (2 * tri + dd) + T1 * (tri + d) * B
                  + T1 * (dd + d) * B)
        if name == "filter_shared":
            floats += T1 + (tri + d) * B + B
    elif name.startswith("sampler_shared"):
        # sampler_bp_fwd's passes on the shared rows, per (step, sequence):
        # the factor pass's 7 d^3/3 + (1 + S) d^2, the chain's 2 d^2 a
        # sample
        chains = B
        ops = {"factor": 7 * d ** 3 / 3 + (1 + S) * d * d,
               "chain": 2 * d * d * S}
        # in: the shared rows P2 and P3 (lower triangle), Jf (lower
        # triangle) and hf per sequence, eps
        floats = T1 * (dd + tri) + T1 * (tri + d) * B + T1 * d * SB
        if name == "sampler_shared_factor":
            step = ops["factor"]
            floats += T1 * dd * B + T1 * d * SB  # out: Q, c
        else:
            step = sum(ops.values())
            floats += d * SB + T1 * d * SB  # in: xT; out: x
    elif name.startswith("elem_scan"):
        # here B is the lane count N and T the scan length L; the algebra of
        # pallas_chunked's _combine_rows (chol d^3/3, two triangular
        # solves for each of X and Y 4 d^3, three d x d products 6 d^3,
        # vectors 12 d^2) and _combine_vjp_rows (chol, X, Y 4 d^3, M^-1
        # d^3, the three quadratic terms of dM 12 d^3, dJ12a and dJ12b
        # 8 d^3, vectors and outer products 30 d^2) per step and lane. An
        # element's J11 and J22 are symmetric in the leaves and the
        # prefixes, so an input element counts Rs = 2 tri + d^2 + 2d + 1
        # floats and an output or a cotangent all R = 3 d^2 + 2d + 1.
        chains, R = NL // 2, 3 * dd + 2 * d + 1
        Rs = 2 * tri + dd + 2 * d + 1
        F = 3 * dd + d
        if name == "elem_scan":
            step = 31 * d ** 3 / 3 + 12 * d * d + 5 * d
            floats = T * (Rs + R) * chains  # in: leaves; out: the prefixes
        elif name == "elem_scan_adj_factor":
            # one (combine, lane) a thread: chol d^3/3, W = M^-1 2 d^3/3,
            # X and Y 4 d^3, v 2 d^2
            step = 5 * d ** 3 + 2 * d * d
            # in: J11 (lower), J12, h1 of leaves 1..L-1 and J22 (lower),
            # J12, h2 of the prefixes 0..L-2; out: fac = [X, Y, W, v]
            floats = (T - 1) * (2 * (tri + dd + d) + F) * chains
        elif name == "elem_scan_adj_chain":
            # G11 X^T, G12 Y^T, G22 Y^T, X G12, Y G22, X Q1 and Y Q2 14 d^3;
            # X g1 + Y g2 4 d^2; the outer products and sums ~20 d^2
            step = 14 * d ** 3 + 24 * d * d
            # in: fac, the cotangents; out: dleaves
            floats = ((T - 1) * F + 2 * T * R) * chains
        else:
            step = 76 * d ** 3 / 3 + 30 * d * d + 4 * d
            # in: leaves 1..L-1, the prefixes 0..L-2 (step 0 passes its
            # cotangent through), the cotangents; out: dleaves
            floats = (2 * (T - 1) * Rs + 2 * T * R) * chains
    elif name.startswith("hmm_fb"):
        # here d is the number of states K; chains: one per sequence and
        # direction
        K, KK, chains = d, d * d, NL
        stat = "_stat_" in name
        # the chain elements: K*K a step and sequence, or the stationary
        # (K, K) matrix once beside K observations a step and sequence
        elements = KK + T1 * K * B if stat else T1 * KK * B
        if name == "hmm_fb_adj_weights":
            # one (step, entry, sequence) a thread: w and v, an add, a
            # subtraction and an exp each
            chains, step = B, 6 * KK
            # in: a0, M, alpha, beta; out: W, V
            floats = K * B + T1 * KK * B + 2 * T1 * K * B + 2 * T1 * KK * B
        elif name == "hmm_fb_adj_chain":
            # per step and chain: K adds of the direct cotangent, K^2
            # multiply-adds
            step = K + 2 * KK
            # in: W, V, dalpha, dbeta; out: g, h, da0
            floats = 2 * T1 * KK * B + 4 * T1 * K * B + K * B
        elif name == "hmm_fb_adj_dM":
            # one (step, entry, sequence) a thread: two multiplies, an add
            chains, step = B, 3 * KK
            # in: W, V, g, h; out: dM
            floats = 3 * T1 * KK * B + 2 * T1 * K * B
        elif name == "hmm_fb_stat_adj_weights":
            # one (step, entry, sequence) a thread: lt + lo, then w and v,
            # an add, a subtraction and an exp each
            chains, step = B, 7 * KK
            # in: a0, LT, lo, alpha, beta; out: W, V
            floats = K * B + elements + 2 * T1 * K * B + 2 * T1 * KK * B
        elif name == "hmm_fb_stat_adj_sums":
            # per (step, sequence): dLT's two multiplies and two adds an
            # entry, dlo's K multiply-adds and an add a state
            chains, step = B, 6 * KK + K
            # in: W, V, g, h; out: dlo, dLT
            floats = 2 * T1 * KK * B + 3 * T1 * K * B + KK
        elif name.endswith("_fwd"):
            # per step K logsumexps of K terms: K adds (carry + element;
            # K more for lt + lo in the stationary kernel), K-1 maxes, K
            # subtractions, K exps, K adds, a log and an add
            step = K * (5 * K + 1) + (KK if stat else 0)
            # in: a0, the elements; out: alpha, beta
            floats = K * B + elements + 2 * T1 * K * B
        else:
            # per step K^2 weights: an add, a subtraction, an exp, a
            # multiply and an add (the stationary kernel: the lt + lo add
            # and the dLT add too), and K adds of the direct cotangent
            step = KK * (7 if stat else 5) + K
            # in: a0, the elements, alpha, beta and their cotangents;
            # out: da0 and the elements' cotangents (dM, or dLT and dlo)
            floats = 2 * K * B + 2 * elements + 4 * T1 * K * B
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
            k = re.search(r"([A-Za-z_]+_kernel)ILi(\d+)E", m.group(1))
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
    laps = [time.perf_counter()]

    def lap(what):
        """Print the seconds the phases since the last lap took."""
        laps.append(time.perf_counter())
        print(f"phase seconds: {what} {laps[-1] - laps[-2]:.1f}")

    errs = {}
    for name, shape in SHAPES.items():
        e = check_kernels(shape)
        print(f"kernels vs twins [{name} {shape}]: {e}")
        a = check_adjoints(shape)
        print(f"adjoints vs plain adjoints [{name} {shape}] (normwise rel, "
              f"max abs): {a}")
        for k in FWD_ERRS:
            errs[k] = max(errs.get(k, 0.0), e[k])
        for k in ("filter_adj", "sampler_adj"):
            errs[k] = max(errs.get(k, 0.0), a[k][1])
    # the forward kernels and the sampler's passes, the adjoints and each
    # of their passes at every built d; every E-step route at every d from
    # 1 to 32, padded where d has no instance of its own
    for d in range(1, estep.KERNEL_DIMS[-1] + 1):
        if d in estep.KERNEL_DIMS:
            e = check_kernels(dict(B=5, T=9, d=d, S=3), seed=d)
            print(f"kernels and the sampler's passes vs twins [d={d}, B=5, "
                  f"T=9, S=3] (max abs; the filter's summed ln rel): {e}")
            a = check_adjoints(dict(B=5, T=9, d=d, S=3), seed=d)
            print(f"adjoints and their passes vs plain versions [d={d}, "
                  f"B=5, T=9, S=3] (normwise rel, max abs): {a}")
            for k in FWD_ERRS:
                errs[k] = max(errs.get(k, 0.0), e[k])
            for k in ("filter_adj", "sampler_adj"):
                errs[k] = max(errs.get(k, 0.0), a[k][1])
        r = check_routes(d, seed=d)
        print(f"E-step routes at d={d} (instance d={estep.kernel_dim(d)}; "
              f"{ROUTE_SHAPE}) vs float64 twins (forward max abs or "
              f"normwise, ln rel, adjoint normwise): {r}")
    d = estep.KERNEL_DIMS[-1] + 1
    print(f"E-step routes at d={d}: {check_routes_refuse(d)} of "
          f"{len(ROUTES)} raise ValueError naming d")
    lap("3, the stationary kernels and every route at d = 1..32")
    for d in (None, 24, WIDE_D):
        shape = SHAPES["config2"] if d is None else dict(SHAPES["config2"],
                                                         d=d)
        print(f"stiff case, node precisions over {list(STIFF_JD)} "
              f"[{shape}] (kernel error, float32 plain error): "
              f"{check_stiff(d=d)}")
        print(f"non-SPD step at d={d or 3}: non-finite outputs where it "
              f"reaches and nowhere else: "
              f"{check_non_spd(d=d or 3)}")
    lap("3s, the stiff and non-SPD cases")
    for name, shape in {**RAGGED_SHAPES, "T512": RAGGED_LONG,
                        f"d={WIDE_D}": dict(B=5, T=9, d=WIDE_D, S=3)}.items():
        e = check_bpairs(shape)
        print(f"bpairs kernels vs plain versions [{name} {shape}, lengths "
              f"over [2, {shape['T']}]] (forward max abs; adjoints normwise "
              f"rel, max abs): {e}")
        for k in ("bidir_fwd",) + SAMPLER_BP_FWD_ERRS:
            errs[k] = max(errs.get(k, 0.0), e[k])
        for k in ("bidir_adj", "bidir_adj_factor",
                  "bidir_adj_chain") + SAMPLER_BP_ERRS:
            errs[k] = max(errs.get(k, 0.0), e[k][1])
    e = check_sampler_bp_fwd()
    print(f"sampler_bp_fwd and its passes vs plain versions [slds "
          f"{BIDIR_ADJ_SHAPES['slds']}] (max abs): {e}")
    for k, v in e.items():
        errs[k] = max(errs[k], v)
    e = check_bidir_fwd()
    print(f"bidir_fwd vs plain [slds {BIDIR_ADJ_SHAPES['slds']}, one "
          f"direction {BIDIR_ADJ_SHAPES['one_direction']}, asymmetric C] "
          f"(max abs, ln rel), and non-finite entries of an indefinite "
          f"step's lane: {e}")
    errs["bidir_fwd"] = max([errs["bidir_fwd"]]
                            + [v[0] for k, v in e.items() if k != "non_spd"])
    for name, e in check_bidir_adj_shapes().items():
        print(f"bidir_adj and its passes vs plain versions [{name} "
              f"{BIDIR_ADJ_SHAPES[name]}] (normwise rel, max abs): {e}")
        for k, (_, err) in e.items():
            errs[k] = max(errs.get(k, 0.0), err)
    lap("3b, the per-sequence-pair kernels")
    # (name, shape, case, seed): the HMM shapes, then every built K at a
    # batch whose last warp is partial
    hmm_cases = [(name, shape, case, 0) for name, shape in HMM_SHAPES.items()
                 for case in (("stationary", "ragged", "forced")
                              if name == "slds" else ("stationary",))]
    hmm_cases += [(f"K={K}", dict(B=37, T=9, K=K), "stationary", K)
                  for K in hmm_fb.KERNEL_STATES + HMM_WIDE_K]
    for name, shape, case, seed in hmm_cases:
        e = check_hmm(shape, case, seed)
        print(f"hmm kernels vs plain versions [{name} {shape} {case}] "
              f"(normwise rel, max abs; node marginals max abs; the "
              f"stationary forward bitwise the streamed on LT + lo): {e}")
        for k in sum(HMM_RUNS, HMM_ADJ_PASSES + HMM_STAT_ADJ_ERRS):
            if k in e:
                errs[k] = max(errs.get(k, 0.0), e[k][1])
    stat_launches = hmm_stationary_path()
    large_k = hmm_large_k()
    lap("3h, the HMM kernels at every K checked")
    for K, rows in large_k.items():
        for k, row in rows.items():
            errs[k] = max(errs.get(k, 0.0), row["err"][1])
    for name, shape in {**ELEM_SHAPES,
                        f"d={WIDE_D}": dict(B=5, T=17, d=WIDE_D, C=3)}.items():
        e = check_elem_scan(shape)
        print(f"element-scan kernels vs plain versions [{name} {shape}] "
              f"(worst field's normwise rel, max abs; per field scan, "
              f"adjoint): {e}")
        for k in ("elem_scan",) + ELEM_ADJ_ERRS:
            errs[k] = max(errs.get(k, 0.0), e[k][1])
    for name, shape in {**KFWD_SHAPES,
                        f"d={WIDE_D}": dict(B=5, T=9, d=WIDE_D, S=3)}.items():
        e = check_kalman_fwd(shape)
        print(f"shared-pair kernels vs plain versions [{name} {shape}] (max "
              f"abs; the filter's summed log-normalizer rel): {e}")
        for k in ("filter_shared", "backward_shared") + SAMPLER_SHARED_ERRS:
            errs[k] = max(errs.get(k, 0.0), e[k])
    e = check_shared_filters()
    print(f"shared-pair filters vs plain [B=37, T=2 at every built d, "
          f"asymmetric pair and node blocks] (max abs, ln rel): {e}")
    for k in ("filter_shared", "backward_shared"):
        errs[k] = max([errs[k]] + [v[0] for v in e.values()])
    lap("3e/3k, the element-scan and shared-pair kernels")

    main_path()
    launches = train_path()
    launches.update(ragged_path())
    padded_theorem()
    lap("4, the config-2 and ragged paths")
    slds_launches = slds_path()
    slds_padded_theorem()
    launches.update({k: slds_launches[k] for k in HMM_RUNS[0]})
    launches.update({k: stat_launches[k] for k in HMM_RUNS[1]})
    lap("4s, the SLDS path")
    launches.update(chunked_train_path())
    long_t_moments()
    launches.update(kalman_fwd_path())
    one_direction_filters()
    gmm_path()
    forecast_path()
    lap("4p/4k/4g/4f, the chunked, shared-pair, GMM and forecast paths")
    serving_t = streaming_path()
    serving_t.update(slds_parallel_path())
    lap("4v/4q, serving and the SLDS parallel= routes")
    conv_launches, conv_t = conv_lds_path()
    conv_rows = conv_kernels()
    lap("4e, config 4")
    wide_launches, wide_rows, wide_t = conv_wide_path()
    lap("4w, config 4 at d=32 and a padded d")
    wide_rows.update(wide_kernel_timings())
    lap("4w, the kernels off config 4's path at d=32")
    many_launches, many_t = slds_wide_k_path()
    lap("4m, the SLDS at K=64")
    example_smokes()
    dp_t = dp_path()
    lap("4x/4d, the examples and the data-parallel step")
    t = timings()
    t.update(ragged_timings())
    t.update(slds_timings())
    t.update(chunked_timings())
    t.update(kalman_fwd_timings())
    lap("5, the timings")
    print(f"chip_smoke wall since the build began: "
          f"{time.perf_counter() - t0:.1f} s")
    kernels = []
    for k in KERNELS:
        if k.startswith("hmm_fb"):
            shape = dict(HMM_SHAPES["slds"], S=1)
            shape["d"] = shape["K"]
        elif k.startswith("elem_scan"):
            # the config-2 fold: B*C lanes of ceil((T-1)/C) steps
            c = ELEM_SHAPES["config2"]
            shape = dict(B=c["B"] * c["C"], T=-(-(c["T"] - 1) // c["C"]),
                         d=c["d"], S=1)
        elif k in [w.__name__ for w in WRAPPERS + FWD_PASS_WRAPPERS]:
            shape = SHAPES["config2"]
        elif k in [w.__name__ for w in KFWD_WRAPPERS + KFWD_PASS_WRAPPERS]:
            shape = KFWD_SHAPES["config2"]
        else:
            shape = RAGGED_SHAPES["ragged"]
        bound_ms, bound_by = bound(k, shape["B"], shape["T"], shape["d"],
                                   shape["S"])
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": ", ".join((KERNELS[k],) + SERVES.get(k, ())),
            "launches": launches[LAUNCHED_BY.get(k, k)],
            "max_abs_err": errs[k], "ms": t[k], "plain_ms": t[k + "_plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    for name in ("config2", "longT"):
        shape = KFWD_SHAPES[name]
        args = (shape["B"], shape["T"], shape["d"], shape["S"])
        print(f"bounds at {name} {shape} (ms, by): "
              + ", ".join(f"{k} {bound(k, *args)}" for k in
                          [w.__name__ for w in KFWD_WRAPPERS]
                          + ["sampler_shared_factor", "sampler_bp_fwd_chain"])
              + f", one direction's B lanes: bidir_fwd "
              f"{bound('bidir_fwd', *args, NL=shape['B'])}, bidir_adj "
              f"{bound('bidir_adj', *args, NL=shape['B'])}")
    for name in ("slds", "measure_hmm"):
        shape = HMM_SHAPES[name]
        print(f"bounds at {name} {shape} (ms, by): " + ", ".join(
            f"{k} {bound(k, shape['B'], shape['T'], shape['K'], 1)}"
            for k in sum(HMM_RUNS, ()) + HMM_ADJ_PASSES
            + HMM_STAT_ADJ_PASSES))
    print("config-4 kernels (" + json.dumps(CONV_SHAPE) + ", launches a "
          "conv_lds step): " + json.dumps([dict(
              name=k, launches_per_step=conv_launches[k] / (
                  PRESETS["conv_lds"].num_seqs
                  // PRESETS["conv_lds"].train.batch_size), **row)
              for k, row in conv_rows.items()]))
    print(f"conv_lds step: {json.dumps(conv_t)}")
    print(f"config-4 kernels at d={WIDE_D} ("
          + json.dumps(dict(CONV_SHAPE, d=WIDE_D)) + ", launches a step): "
          + json.dumps([dict(name=k, launches_per_step=wide_launches.get(
              k, 0) / CONV_WIDE_STEPS, **row)
                        for k, row in wide_rows.items()]))
    print(f"conv_lds step at d={WIDE_D}: {json.dumps(wide_t)}")
    print(f"slds K={SLDS_WIDE_K} train step: launches {many_launches}, "
          f"{json.dumps(many_t)}")
    print(f"hmm kernels at measure_hmm's B and T, K in {list(large_k)}: "
          f"{json.dumps(large_k)}")
    print(f"serving path and slds parallel= steps (ms): "
          f"{json.dumps(serving_t)}")
    print(f"bigdata_dp step: {json.dumps(dp_t)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
