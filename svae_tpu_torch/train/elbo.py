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

from svae_tpu_torch.models.lds import _length_mask
from svae_tpu_torch.utils.pytree import (tree_add, tree_map, tree_scale,
                                         tree_sub)


def masked_forward(run_inference, recognize, loglike, pgm_prior,
                   pgm_params, net_params, batch, generator, num_samples,
                   mask_fn=None, ragged=False):
    """Recognition -> inference -> decoder log-likelihood. Returns
    ``(ll, stats, global_kl, local_kl, B)``. The masks compose: ``mask_fn``
    (``frames -> (clean_frames, mask)``) marks missing frames, whose mask
    goes to ``run_inference(mask=)`` and ``loglike(mask=)``; a ``ragged``
    batch is a ``(frames, lengths)`` pair whose lengths go to
    ``run_inference(lengths=)`` and whose pad frames also drop out of the
    decoder term."""
    recogn_net, loglike_net = net_params
    frames, lengths = batch if ragged else (batch, None)
    B = frames.shape[0]
    if mask_fn is None:
        clean, mask = frames, None
    else:
        clean, mask = mask_fn(frames)
    nn_potentials = recognize(recogn_net, clean)
    kw = {} if mask is None else {"mask": mask}
    if lengths is not None:
        kw["lengths"] = lengths
    samples, stats, global_kl, local_kl = run_inference(
        pgm_prior, pgm_params, nn_potentials, generator, num_samples, **kw)
    ll_mask = mask
    if lengths is not None:
        lm = _length_mask(lengths, B, clean.shape[-2], clean.dtype,
                          clean.device)
        ll_mask = lm if ll_mask is None else ll_mask * lm
    ll_kw = {} if ll_mask is None else {"mask": ll_mask}
    ll = loglike(loglike_net, samples, clean, **ll_kw)
    return ll, stats, global_kl, local_kl, B


def make_objective(run_inference, recognize, loglike, pgm_prior, N,
                   num_samples=1, mask_fn=None, ragged=False):
    """Build ``objective(pgm_params, net_params, batch, generator) ->
    (elbo_per_datapoint, (stats, terms))`` with ``net_params =
    (recognizer, decoder)``. The value carries the autograd graph to the
    nets' parameters; ``stats`` (for the natural gradient) and ``terms``
    (the ELBO's three components per datapoint) are detached. ``ragged``:
    the batch is a ``(frames (B, T, d_obs), lengths (B,))`` pair from a
    length-bucketed loader (svae_tpu_torch.data.loader), with the exact
    padded-batch semantics of ``run_inference(lengths=)``."""

    def objective(pgm_params, net_params, batch, generator):
        ll, stats, global_kl, local_kl, B = masked_forward(
            run_inference, recognize, loglike, pgm_prior, pgm_params,
            net_params, batch, generator, num_samples, mask_fn, ragged)
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
        B = (batch[0] if ragged else batch).shape[0]
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
