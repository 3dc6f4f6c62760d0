"""MC-ELBO and the split SVAE gradient (port of svae_tpu/train/elbo.py).

For a minibatch of B of N datapoints:

  ELBO = (N/B) * [ E_q log p(y | x, gamma) - local_KL ] - global_KL

Two gradient channels:
  1. the conjugate PGM globals get the closed-form natural gradient from
     the detached expected sufficient statistics,
         natgrad = (natgrad_scale / N) * (prior + (N/B) * stats - params)
     (an ascent direction);
  2. the recognition and decoder nets get ordinary backprop gradients of
     the ELBO through the reparameterized samples and the local KL: on a
     card through the E-step's adjoint kernels, on the CPU through torch's
     autograd of the plain twins.
"""

import torch

from svae_tpu_torch.utils.pytree import (tree_add, tree_map, tree_scale,
                                         tree_sub)

_RAGGED = ("ragged batches (ragged=True) are not ported yet: ROADMAP.md "
           "Queue 1, 'Ragged and masked LDS'")


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
                   num_samples=1, mask_fn=None, ragged=False):
    """Build ``objective(pgm_params, net_params, batch, generator) ->
    (elbo_per_datapoint, (stats, terms))`` with ``net_params =
    (recognizer, decoder)``. The value carries the autograd graph to the
    nets' parameters; ``stats`` (for the natural gradient) and ``terms``
    (the ELBO's three components per datapoint) are detached."""
    if ragged:
        raise NotImplementedError(_RAGGED)

    def objective(pgm_params, net_params, batch, generator):
        ll, stats, global_kl, local_kl, B = masked_forward(
            run_inference, recognize, loglike, pgm_prior, pgm_params,
            net_params, batch, generator, num_samples, mask_fn)
        elbo = (N / B) * (ll - local_kl) - global_kl
        terms = {
            "loglike": ll / B,
            "local_kl": local_kl / B,
            "global_kl": global_kl / N,
        }
        return elbo / N, (tree_map(torch.Tensor.detach, stats),
                          {k: v.detach() for k, v in terms.items()})

    return objective


def net_parameters(net_params):
    """The nets' parameters as ``(recognizer params, decoder params)``,
    each a tuple in ``module.parameters()`` order (the leaf order of the
    JAX package's parameter pytrees)."""
    return tuple(tuple(net.parameters()) for net in net_params)


def make_gradfun(run_inference, recognize, loglike, pgm_prior, N,
                 num_samples=1, natgrad_scale=1.0, mask_fn=None,
                 ragged=False):
    """Build the per-step value-and-gradient function

      ``gradfun(pgm_params, net_params, batch, generator) ->
          (elbo_per_datapoint, pgm_natgrad, net_grads, terms)``.

    ``pgm_natgrad`` is an ascent direction congruent with ``pgm_params``;
    ``net_grads`` are the ELBO's ascent gradients, congruent with
    :func:`net_parameters`; ``terms`` holds the ELBO's three components
    (per datapoint) and ``net_grad_norm``, the global norm of
    ``net_grads``. Gradients are taken with respect to the net parameters
    only; nothing is written into their ``.grad``."""
    objective = make_objective(run_inference, recognize, loglike, pgm_prior,
                               N, num_samples, mask_fn=mask_fn,
                               ragged=ragged)

    def gradfun(pgm_params, net_params, batch, generator):
        B = batch.shape[0]
        params = net_parameters(net_params)
        with torch.enable_grad():
            elbo, (stats, terms) = objective(pgm_params, net_params, batch,
                                             generator)
            flat = torch.autograd.grad(elbo, [p for ps in params for p in ps])
        it = iter(flat)
        net_grads = tuple(tuple(next(it) for _ in ps) for ps in params)
        # closed-form natural gradient from the conjugate statistics
        natgrad = tree_scale(
            tree_sub(tree_add(pgm_prior, tree_scale(stats, N / B)),
                     pgm_params),
            natgrad_scale / N)
        terms = dict(terms)
        terms["net_grad_norm"] = torch.sqrt(sum((g * g).sum() for g in flat))
        return elbo.detach(), natgrad, net_grads, terms

    return gradfun
