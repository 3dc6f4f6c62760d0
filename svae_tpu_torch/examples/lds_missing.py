"""LDS-SVAE with missing frames: train through the masked-evidence
pipeline on dot videos with a fraction of frames dropped, then impute the
dropped frames with the smoother and report pixel RMSE against the
held-back truth (and against a copy-last-observed baseline). Exercises
data/masking.nan_mask -> elbo.make_objective(mask_fn=) ->
models/lds.run_inference(mask=) -> the masked decoder log-likelihood.

    python -m svae_tpu_torch.examples.lds_missing
        [--preset lds_missing_smoke] [--missing_frac 0.25] [--device cpu]
"""

import functools

import numpy as np
import torch

from svae_tpu_torch.data import masking
from svae_tpu_torch.data.synthetic import make_dot_data
from svae_tpu_torch.examples._common import (lds_parallel, parse, report,
                                             train_kwargs)
from svae_tpu_torch.examples.lds_dots import build
from svae_tpu_torch.models import lds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib


def drop_frames(generator, data, missing_frac):
    """NaN-mark a random ``missing_frac`` of the (seq, frame) pairs, always
    keeping each sequence's first frame observed (it anchors the chain)."""
    N, T = data.shape[:2]
    u = torch.rand((N, T), generator=generator, device=generator.device)
    drop = (u < missing_frac).to(data.device)
    drop[:, 0] = False
    return torch.where(drop[..., None], torch.nan, data), drop


def impute(pgm_params, net_params, clean_batch, mask):
    """Smoother-impute every frame; per-frame reconstructions."""
    with torch.no_grad():
        pots = recognition.mlp_recognize(net_params[0], clean_batch)
        Ex, _, _, _ = lds.posterior_moments(pgm_params, pots, mask=mask)
        recon, _ = decoders.mlp_decode(net_params[1], Ex)
    return recon


def main(argv=None):
    cfg, device = parse("lds_missing", argv)
    tc = cfg.train
    truth = torch.from_numpy(make_dot_data(
        seed=tc.seed, num_seqs=cfg.num_seqs, T=cfg.T,
        image_width=cfg.image_width)).to(device)
    data, dropped = drop_frames(torch.Generator().manual_seed(tc.seed + 1),
                                truth, cfg.missing_frac)
    N = data.shape[0]
    print(f"dropped {float(dropped.float().mean()):.1%} of frames "
          f"({int(dropped.sum())} of {dropped.numel()})")

    pgm_prior, pgm_params, net_params = build(
        cfg, torch.Generator().manual_seed(tc.seed), device)
    run_inf = functools.partial(lds.run_inference, parallel=lds_parallel(cfg))
    opt_init, train_step = loop_lib.make_train_step(
        run_inf, recognition.mlp_recognize, decoders.mlp_loglike,
        pgm_prior, N, mask_fn=masking.nan_mask, **train_kwargs(tc))
    opt_state = opt_init(pgm_params, net_params)

    pgm_params, net_params, opt_state, hist = experiment.run(
        tc, train_step, pgm_params, net_params, opt_state, data)

    # ---- impute the dropped frames and score against the held-back truth
    eval_n = min(N, 64)
    clean, mask = masking.nan_mask(data[:eval_n])
    recon = impute(pgm_params, net_params, clean, mask).cpu().numpy()
    miss = dropped[:eval_n].cpu().numpy()
    truth_np = truth[:eval_n].cpu().numpy()
    rmse = float(np.sqrt(np.mean((recon[miss] - truth_np[miss]) ** 2)))

    # copy-last-observed baseline (per sequence, forward fill in pixels)
    filled = np.array(truth_np)
    for i in range(eval_n):
        for t in range(1, filled.shape[1]):
            if miss[i, t]:
                filled[i, t] = filled[i, t - 1]
    rmse_ffill = float(np.sqrt(np.mean(
        (filled[miss] - truth_np[miss]) ** 2)))
    print(f"imputation_rmse={rmse:.4f} ffill_baseline={rmse_ffill:.4f}")

    if tc.plot_path:
        from svae_tpu_torch.utils import plotting
        plotting.plot_lds_reconstruction(tc.plot_path, truth_np[0], recon[0])

    if hist:
        report(hist)
    return rmse, rmse_ffill


if __name__ == "__main__":
    main()
