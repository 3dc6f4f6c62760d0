"""LDS-SVAE on 1D bouncing-dot image sequences, T=100 (BASELINE config 2).

    python -m svae_tpu_torch.examples.lds_dots [--preset lds_dots_smoke]
        [--T 100] [--device cpu] ...
"""

import functools

import torch

from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.examples._common import (lds_parallel, parse, report,
                                             train_kwargs)
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib


def build(cfg, generator, device):
    """Prior, initial globals and MLP nets of an LDS config, drawn from
    ``generator`` in that order."""
    pgm_prior = lds.init_pgm_param(cfg.d_latent, generator, device=device)
    pgm_params = lds.init_pgm_param(cfg.d_latent, generator, device=device)
    net_params = (
        recognition.init_mlp_recognize(cfg.image_width, cfg.hidden,
                                       cfg.d_latent, generator,
                                       device=device),
        decoders.init_mlp_decode(cfg.d_latent, cfg.hidden, cfg.image_width,
                                 generator, device=device))
    return pgm_prior, pgm_params, net_params


def main(argv=None):
    cfg, device = parse("lds_dots", argv)
    tc = cfg.train
    data = torch.from_numpy(make_dot_data(
        seed=tc.seed, num_seqs=cfg.num_seqs, T=cfg.T,
        image_width=cfg.image_width)).to(device)
    N = data.shape[0]  # N counts sequences (the exchangeable unit)
    pgm_prior, pgm_params, net_params = build(
        cfg, torch.Generator().manual_seed(tc.seed), device)

    run_inf = functools.partial(lds.run_inference, parallel=lds_parallel(cfg))
    opt_init, train_step = loop_lib.make_train_step(
        run_inf, recognition.mlp_recognize, decoders.mlp_loglike,
        pgm_prior, N, **train_kwargs(tc))
    opt_state = opt_init(pgm_params, net_params)

    pgm_params, net_params, opt_state, hist = experiment.run(
        tc, train_step, pgm_params, net_params, opt_state, data)

    if tc.plot_path:
        from svae_tpu_torch.utils import plotting
        seq = data[:1]
        with torch.no_grad():
            pots = recognition.mlp_recognize(net_params[0], seq)
            samples, _, _, _ = lds.run_inference(
                pgm_prior, pgm_params, pots,
                torch.Generator(device=data.device).manual_seed(0), 1)
            recon, _ = decoders.mlp_decode(net_params[1], samples[0, 0])
        plotting.plot_lds_reconstruction(tc.plot_path, seq[0], recon)

    report(hist)
    return hist


if __name__ == "__main__":
    main()
