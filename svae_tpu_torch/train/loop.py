"""Training loop: one SVI step, a k-step loop and a host-side epoch loop
with callbacks (port of svae_tpu/train/loop.py).

PyTorch runs eagerly, so there is no jit and no buffer donation: a step is
the sequence of kernels its ops launch, and the nets are updated in place
(svae_tpu_torch/train/optim.py). Randomness comes from one
``torch.Generator`` that every step draws from in sequence, in place of
the JAX package's key splits.
"""

import torch

from svae_tpu_torch.train.elbo import make_gradfun
from svae_tpu_torch.train.optim import make_optimizer


def make_train_step(run_inference, recognize, loglike, pgm_prior, N,
                    num_samples=1, natgrad_scale=1.0, pgm_step_size=1.0,
                    net_optimizer=None, net_step_size=1e-3, mask_fn=None):
    """Build ``(init_state, train_step)``:

      init_state(pgm_params, net_params) -> opt_state
      train_step(pgm_params, net_params, opt_state, batch, generator)
          -> (pgm_params, net_params, opt_state, elbo, terms)

    ``terms`` carries the ELBO components and the net-gradient norm, as
    device scalars; ``generator`` draws the step's sampling noise."""
    gradfun = make_gradfun(run_inference, recognize, loglike, pgm_prior, N,
                           num_samples, natgrad_scale, mask_fn=mask_fn)
    opt_init, opt_update = make_optimizer(net_optimizer, pgm_step_size,
                                          net_step_size)

    def step(pgm_params, net_params, opt_state, batch, generator):
        elbo, natgrad, net_grads, terms = gradfun(pgm_params, net_params,
                                                  batch, generator)
        pgm_params, net_params, opt_state = opt_update(
            opt_state, pgm_params, net_params, natgrad, net_grads)
        return pgm_params, net_params, opt_state, elbo, terms

    return opt_init, step


def make_fused_train_step(run_inference, recognize, loglike, pgm_prior, N,
                          k_steps, num_samples=1, natgrad_scale=1.0,
                          pgm_step_size=1.0, net_optimizer=None,
                          net_step_size=1e-3, mask_fn=None,
                          stacked_batch=False):
    """Like :func:`make_train_step`, but one call runs ``k_steps`` SVI
    steps, each drawing its noise from ``generator`` after the one before:

      fused_step(pgm_params, net_params, opt_state, batch, generator)
          -> (pgm_params, net_params, opt_state, elbo, terms, elbos)

    ``batch`` is reused by every step (full-batch training) or, with
    ``stacked_batch=True``, is a ``(k_steps, B, ...)`` tensor of per-step
    minibatches. ``elbo`` and ``terms`` are the last step's, ``elbos`` the
    (k_steps,) history on the device. The loop adds no host sync of its
    own; each step's ``run_inference`` makes its one finiteness check.
    (A CUDA graph of the k steps is later work: ROADMAP.md.)"""
    opt_init, step = make_train_step(
        run_inference, recognize, loglike, pgm_prior, N, num_samples,
        natgrad_scale, pgm_step_size, net_optimizer, net_step_size, mask_fn)

    def fused(pgm_params, net_params, opt_state, batch, generator):
        if stacked_batch and batch.shape[0] != k_steps:
            raise ValueError(f"stacked_batch: expected {k_steps} batches, "
                             f"got {batch.shape[0]}")
        elbos = []
        for i in range(k_steps):
            b = batch[i] if stacked_batch else batch
            pgm_params, net_params, opt_state, elbo, terms = step(
                pgm_params, net_params, opt_state, b, generator)
            elbos.append(elbo)
        return (pgm_params, net_params, opt_state, elbos[-1], terms,
                torch.stack(elbos))

    return opt_init, fused


def run(train_step, pgm_params, net_params, opt_state, data, generator,
        num_epochs, batch_size, callback=None, callback_every=1,
        shuffle=True):
    """Host-side epoch loop (reference: svae/optimizers.py:adam loop).

    ``data`` is one tensor with a leading sequence axis; batches are
    equal-sized slices (the tail remainder is dropped). Each epoch's
    permutation is drawn from ``generator`` (on its device), then each
    step's noise. ``callback(step, elbo, (pgm_params, net_params,
    opt_state), terms, generator)`` runs every ``callback_every`` steps and
    on the final step; ``elbo`` is a float there (one host sync per
    firing), ``terms`` the step's device-side metrics. The ELBO history
    stays on the device and is fetched once at the end.

    Returns (pgm_params, net_params, opt_state, elbo_history, generator).
    """
    N = data.shape[0]
    num_batches = N // batch_size
    total_steps = num_epochs * num_batches
    history = []
    step_idx = 0
    for _ in range(num_epochs):
        if shuffle:
            perm = torch.randperm(N, generator=generator,
                                  device=generator.device).to(data.device)
        else:
            perm = torch.arange(N, device=data.device)
        for b in range(num_batches):
            batch = data[perm[b * batch_size:(b + 1) * batch_size]]
            pgm_params, net_params, opt_state, elbo, terms = train_step(
                pgm_params, net_params, opt_state, batch, generator)
            history.append(elbo)  # device scalar: no host sync
            step_idx += 1
            if callback is not None and (step_idx % callback_every == 0
                                         or step_idx == total_steps):
                callback(step_idx - 1, float(elbo),
                         (pgm_params, net_params, opt_state), terms,
                         generator)
    history = torch.stack(history).tolist() if history else []
    return pgm_params, net_params, opt_state, history, generator
