"""GMM-SVAE on 2D pinwheel data (BASELINE config 1).

    python -m svae_tpu_torch.examples.gmm_pinwheel
        [--preset gmm_pinwheel_smoke] [--K 8] [--train.num_epochs 100]
        [--device cpu] ...
"""

import torch

from svae_tpu_torch.data.synthetic import make_pinwheel
from svae_tpu_torch.examples._common import parse, report, train_kwargs
from svae_tpu_torch.models import gmm
from svae_tpu_torch.nets import decoders, recognition
from svae_tpu_torch.train import experiment
from svae_tpu_torch.train import loop as loop_lib
from svae_tpu_torch.utils.pytree import tree_map


def _latents(net, data):
    """The recognizer's latent means h / J of ``data``, on the host."""
    with torch.no_grad():
        J, h = recognition.mlp_recognize(net, data)
    return (h / J).cpu().numpy()


def main(argv=None):
    cfg, device = parse("gmm_pinwheel", argv)
    tc = cfg.train
    gen = torch.Generator().manual_seed(tc.seed)
    data = torch.from_numpy(make_pinwheel(
        seed=tc.seed, num_classes=cfg.num_classes,
        num_per_class=cfg.num_per_class)).to(device)
    N, d_obs = data.shape

    pgm_prior = gmm.init_pgm_param(cfg.K, cfg.d_latent, gen, device=device)
    pgm_params = gmm.init_pgm_param(cfg.K, cfg.d_latent, gen,
                                    random_scale=2.0, device=device)
    net_params = (
        recognition.init_mlp_recognize(d_obs, cfg.hidden, cfg.d_latent, gen,
                                       device=device),
        decoders.init_mlp_decode(cfg.d_latent, cfg.hidden, d_obs, gen,
                                 device=device))

    def run_inf(prior, glob, pots, generator, S):
        return gmm.run_inference(prior, glob, pots, generator, S,
                                 num_meanfield_iters=cfg.meanfield_iters)

    opt_init, train_step = loop_lib.make_train_step(
        run_inf, recognition.mlp_recognize, decoders.mlp_loglike,
        pgm_prior, N, **train_kwargs(tc))
    opt_state = opt_init(pgm_params, net_params)

    snapshots = []
    extra_callback = None
    if tc.animate_path:
        def extra_callback(step, elbo, state, terms):
            pgm, net, _ = state
            snapshots.append((_latents(net[0], data),
                              tree_map(lambda a: a.cpu().numpy(), pgm),
                              step))

    pgm_params, net_params, opt_state, hist = experiment.run(
        tc, train_step, pgm_params, net_params, opt_state, data,
        extra_callback=extra_callback)

    if tc.animate_path and snapshots:
        from svae_tpu_torch.utils import plotting
        plotting.animate_gmm_clusters(tc.animate_path, snapshots)
        print(f"wrote {tc.animate_path} ({len(snapshots)} frames)")

    if tc.plot_path:
        from svae_tpu_torch.utils import plotting
        # the clusters in the recognition net's latent space
        plotting.plot_gmm_clusters(tc.plot_path,
                                   _latents(net_params[0], data), pgm_params)

    report(hist)
    return hist


if __name__ == "__main__":
    main()
