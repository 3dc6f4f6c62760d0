"""MC-ELBO value (port of the forward half of svae_tpu/train/elbo.py).

For a minibatch of B of N datapoints:

  ELBO = (N/B) * [ E_q log p(y | x, gamma) - local_KL ] - global_KL

This module gives the value and the expected sufficient statistics, under
``torch.no_grad()``; the gradient channels (``make_gradfun``) come with the
training path.
"""

import torch


def masked_forward(run_inference, recognize, loglike, pgm_prior,
                   pgm_params, net_params, batch, generator, num_samples,
                   mask_fn=None):
    """Recognition -> inference -> decoder log-likelihood. Returns
    ``(ll, stats, global_kl, local_kl, B)``. ``mask_fn``: ``batch ->
    (clean_batch, mask)`` for data with missing frames; the mask goes to
    ``run_inference(mask=)`` and to ``loglike(mask=)``."""
    recogn_net, loglike_net = net_params
    B = batch.shape[0]
    if mask_fn is None:
        clean, mask = batch, None
    else:
        clean, mask = mask_fn(batch)
    nn_potentials = recognize(recogn_net, clean)
    kw = {} if mask is None else {"mask": mask}
    samples, stats, global_kl, local_kl = run_inference(
        pgm_prior, pgm_params, nn_potentials, generator, num_samples, **kw)
    ll = loglike(loglike_net, samples, clean, **kw)
    return ll, stats, global_kl, local_kl, B


def make_objective(run_inference, recognize, loglike, pgm_prior, N,
                   num_samples=1, mask_fn=None):
    """Build ``objective(pgm_params, net_params, batch, generator) ->
    (elbo_per_datapoint, (stats, terms))`` with ``net_params =
    (recognizer, decoder)``; ``terms`` holds the ELBO's three components
    per datapoint."""

    def objective(pgm_params, net_params, batch, generator):
        with torch.no_grad():
            ll, stats, global_kl, local_kl, B = masked_forward(
                run_inference, recognize, loglike, pgm_prior, pgm_params,
                net_params, batch, generator, num_samples, mask_fn)
            elbo = (N / B) * (ll - local_kl) - global_kl
            terms = {
                "loglike": ll / B,
                "local_kl": local_kl / B,
                "global_kl": global_kl / N,
            }
        return elbo / N, (stats, terms)

    return objective
