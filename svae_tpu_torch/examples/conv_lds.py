"""LDS-SVAE on 2D image sequences with a conv recognition net, T=500
(BASELINE config 4).

    python -m svae_tpu_torch.examples.conv_lds [--preset conv_lds_smoke]
        [--device cpu] ...
"""

import functools

import numpy as np
import torch

from svae_tpu_torch.data.synthetic import make_2d_dot_movies
from svae_tpu_torch.examples._common import (lds_parallel, parse, report,
                                             train_kwargs)
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib


def build(cfg, device):
    """The config's data (N, T, H*W) on ``device``, the prior and initial
    globals, the nets (from a generator seeded with ``train.seed``) and
    ``make_train_step``'s first three arguments."""
    tc = cfg.train
    gen = torch.Generator().manual_seed(tc.seed)
    data = torch.from_numpy(make_2d_dot_movies(
        tc.seed, cfg.num_seqs, cfg.T, cfg.frame_hw)).to(device)
    d_obs = data.shape[-1]
    pgm_prior = lds.init_pgm_param(cfg.d_latent, gen, device=device)
    pgm_params = lds.init_pgm_param(cfg.d_latent, gen, device=device)
    net_params = (
        recognition.init_conv_recognize(cfg.frame_hw, cfg.channels,
                                        cfg.kernel_size, cfg.d_latent, gen,
                                        device=device),
        decoders.init_mlp_decode(cfg.d_latent, cfg.hidden_dec, d_obs, gen,
                                 device=device))
    cdt = torch.bfloat16 if cfg.net_compute_dtype == "bfloat16" else None
    parts = (functools.partial(lds.run_inference,
                               parallel=lds_parallel(cfg)),
             recognition.make_conv_recognize(cfg.frame_hw, compute_dtype=cdt),
             decoders.make_mlp_loglike(compute_dtype=cdt))
    return data, pgm_prior, pgm_params, net_params, parts


def main(argv=None):
    cfg, device = parse("conv_lds", argv)
    tc = cfg.train
    data, pgm_prior, pgm_params, net_params, parts = build(cfg, device)
    opt_init, train_step = loop_lib.make_train_step(
        *parts, pgm_prior, data.shape[0], **train_kwargs(tc))
    opt_state = opt_init(pgm_params, net_params)

    pgm_params, net_params, opt_state, hist = experiment.run(
        tc, train_step, pgm_params, net_params, opt_state, data)
    report(hist)

    if tc.plot_path:
        from svae_tpu_torch.utils import plotting
        seq = data[:1]
        with torch.no_grad():
            pots = recognition.conv_recognize(net_params[0], seq,
                                              cfg.frame_hw)
            samples, _, _, _ = lds.run_inference(
                pgm_prior, pgm_params, pots,
                torch.Generator(device=data.device).manual_seed(1), 1,
                parallel=lds_parallel(cfg))
            mu, _ = decoders.mlp_decode(net_params[1], samples[0, 0])
        plotting.plot_frame_montage(tc.plot_path, np.asarray(seq[0].cpu()),
                                    mu.cpu().numpy(), cfg.frame_hw)
    return hist


if __name__ == "__main__":
    main()
