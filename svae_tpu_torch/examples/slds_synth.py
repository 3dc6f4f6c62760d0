"""SLDS-SVAE on synthetic switching-dynamics dot sequences (BASELINE
config 3): the HMM forward-backward and the per-state Kalman messages of
the structured mean-field E-step.

    python -m svae_tpu_torch.examples.slds_synth
        [--preset slds_synth_smoke] [--device cpu] ...
"""

import numpy as np
import torch

from svae_tpu_torch.data.synthetic import make_switching_dot_data
from svae_tpu_torch.examples._common import parse, report, train_kwargs
from svae_tpu_torch.models import slds
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib


def segmentation_purity(pred, true):
    """Map each predicted discrete state to its majority true regime and
    score the fraction of frames so explained (invariant to the states'
    labels)."""
    pred, true = np.asarray(pred).ravel(), np.asarray(true).ravel()
    correct = 0
    for k in np.unique(pred):
        m = pred == k
        correct += np.bincount(true[m]).max()
    return correct / pred.size


def main(argv=None):
    cfg, device = parse("slds_synth", argv)
    tc = cfg.train
    gen = torch.Generator().manual_seed(tc.seed)
    data_np, true_states = make_switching_dot_data(
        tc.seed, cfg.num_seqs, cfg.T, cfg.image_width, return_states=True)
    data = torch.from_numpy(data_np).to(device)
    N = data.shape[0]

    pgm_prior = slds.init_pgm_param(cfg.K, cfg.d_latent, gen, device=device)
    pgm_params = slds.init_pgm_param(cfg.K, cfg.d_latent, gen,
                                     device=device)
    net_params = (
        recognition.init_mlp_recognize(cfg.image_width, cfg.hidden,
                                       cfg.d_latent, gen, device=device),
        decoders.init_mlp_decode(cfg.d_latent, cfg.hidden, cfg.image_width,
                                 gen, device=device))

    # every backend runs the port's kernels; the config's is accepted for
    # the JAX package's flags
    def run_inf(prior, glob, pots, generator, S):
        return slds.run_inference(prior, glob, pots, generator, S,
                                  num_meanfield_iters=cfg.meanfield_iters)

    opt_init, train_step = loop_lib.make_train_step(
        run_inf, recognition.mlp_recognize, decoders.mlp_loglike,
        pgm_prior, N, **train_kwargs(tc))
    opt_state = opt_init(pgm_params, net_params)

    pgm_params, net_params, opt_state, hist = experiment.run(
        tc, train_step, pgm_params, net_params, opt_state, data)
    report(hist)

    # MAP segmentation of a probe batch against the true regimes
    n_probe = min(8, N)
    with torch.no_grad():
        pots = recognition.mlp_recognize(net_params[0], data[:n_probe])
        paths = slds.most_likely_states(
            pgm_params, pots,
            num_meanfield_iters=cfg.meanfield_iters).cpu().numpy()
    purity = segmentation_purity(paths, true_states[:n_probe])
    print(f"segmentation_purity={purity:.3f} (K={cfg.K} states vs 2 true "
          f"regimes, {n_probe} seqs)")
    if tc.plot_path:
        from svae_tpu_torch.utils import plotting
        plotting.plot_slds_segmentation(tc.plot_path, paths,
                                        true_states[:n_probe])
    return hist


if __name__ == "__main__":
    main()
