"""LDS-SVAE on a variable-length corpus: length-bucketed ragged batches.

  data/loader.ragged_epoch_batches (shuffle -> sort by length -> bucket ->
      pad to a rounded boundary -> shuffle batch order)
  -> train/loop.make_train_step(ragged=True)
  -> models/lds.run_inference(lengths=) (exact padded-batch semantics: pad
      frames carry no evidence, normalized dummy pad transitions, pad-free
      M-step statistics)
  -> the masked decoder log-likelihood.

Every batch's padded T is a multiple of ``pad_multiple``, which bounds the
padding and the number of distinct batch shapes.

    python -m svae_tpu_torch.examples.lds_ragged
        [--preset lds_ragged_smoke] [--device cpu] ...
"""

import functools

import numpy as np
import torch

from svae_tpu_torch.data import loader
from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.examples._common import (lds_parallel, parse, report,
                                             train_kwargs)
from svae_tpu_torch.examples.lds_dots import build
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib


def make_ragged_corpus(seed, num_seqs, T_min, T_max, image_width):
    """Variable-length 1D dot videos: each sequence is an independent
    bouncing-dot rollout whose length is uniform in [T_min, T_max]."""
    rng = np.random.RandomState(seed)
    seqs = []
    for i in range(num_seqs):
        t = int(rng.randint(T_min, T_max + 1))
        full = make_dot_data(num_seqs=1, T=t, image_width=image_width,
                             seed=seed + 1 + i)
        seqs.append(np.asarray(full[0], np.float32))
    return seqs


def main(argv=None):
    cfg, device = parse("lds_ragged", argv)
    tc = cfg.train
    seqs = make_ragged_corpus(tc.seed, cfg.num_seqs, cfg.T_min, cfg.T,
                              cfg.image_width)
    N = len(seqs)
    mean_T = float(np.mean([s.shape[0] for s in seqs]))
    pgm_prior, pgm_params, net_params = build(
        cfg, torch.Generator().manual_seed(tc.seed), device)

    run_inf = functools.partial(lds.run_inference, parallel=lds_parallel(cfg))
    opt_init, train_step = loop_lib.make_train_step(
        run_inf, recognition.mlp_recognize, decoders.mlp_loglike,
        pgm_prior, N, ragged=True, **train_kwargs(tc))
    opt_state = opt_init(pgm_params, net_params)

    # group_by_shape: each bucket's batches emit consecutively, so
    # steps_per_dispatch > 1 groups same-shape batches
    base_loader = loader.make_loader(
        seqs, tc.batch_size, seed=tc.seed, pad_multiple=cfg.pad_multiple,
        prefetch=2, device=device, group_by_shape=tc.steps_per_dispatch > 1)
    shapes = set()

    def get_batches(epoch):
        for frames, lengths in base_loader(epoch):
            shapes.add(int(frames.shape[1]))
            yield frames, lengths

    pgm_params, net_params, opt_state, hist = experiment.run_with_loader(
        tc, train_step, pgm_params, net_params, opt_state, get_batches,
        device=device)

    report(hist)
    print(f"mean_T={mean_T:.1f} padded_shapes={sorted(shapes)}")
    return hist, sorted(shapes)


if __name__ == "__main__":
    main()
