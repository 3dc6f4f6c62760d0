"""Training loop: one SVI step, a k-step loop and host-side epoch loops
with callbacks, over a dense array or a loader (port of
svae_tpu/train/loop.py).

PyTorch runs eagerly, so there is no jit and no buffer donation: a step is
the sequence of kernels its ops launch, and the nets are updated in place
(svae_tpu_torch/train/optim.py). Randomness comes from one
``torch.Generator`` that every step draws from in sequence, in place of
the JAX package's key splits.
"""

import torch

from svae_tpu_torch.train.elbo import make_gradfun
from svae_tpu_torch.train.optim import make_optimizer
from svae_tpu_torch.utils.pytree import tree_leaves


def make_train_step(run_inference, recognize, loglike, pgm_prior, N,
                    num_samples=1, natgrad_scale=1.0, pgm_step_size=1.0,
                    net_optimizer=None, net_step_size=1e-3, mask_fn=None,
                    ragged=False):
    """Build ``(init_state, train_step)``:

      init_state(pgm_params, net_params) -> opt_state
      train_step(pgm_params, net_params, opt_state, batch, generator)
          -> (pgm_params, net_params, opt_state, elbo, terms)

    ``terms`` carries the ELBO components and the net-gradient norm, as
    device scalars; ``generator`` draws the step's sampling noise.
    ``ragged`` makes ``batch`` a ``(frames, lengths)`` pair from a
    length-bucketed loader (see elbo.make_objective)."""
    gradfun = make_gradfun(run_inference, recognize, loglike, pgm_prior, N,
                           num_samples, natgrad_scale, mask_fn=mask_fn,
                           ragged=ragged)
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
        shuffle=True, steps_per_dispatch=1):
    """Host-side epoch loop (reference: svae/optimizers.py:adam loop).

    ``data`` is one tensor with a leading sequence axis; batches are
    equal-sized slices (the tail remainder is dropped). Each epoch's
    permutation is drawn from ``generator`` (on its device), then each
    step's noise. ``callback(step, elbo, (pgm_params, net_params,
    opt_state), terms, generator)`` runs every ``callback_every`` steps and
    on the final step; ``elbo`` is a float there (one host sync per
    firing), ``terms`` the step's device-side metrics. The ELBO history
    stays on the device and is fetched once at the end.

    ``steps_per_dispatch=k`` keeps the JAX package's callback cadence for
    its grouped dispatches: there each epoch's steps run in groups of k
    (a trailing partial group step by step), and the callback fires at the
    end of a group when a multiple of ``callback_every`` fell within it.
    Here the steps run one at a time all the same, so the trajectory does
    not depend on k.

    Returns (pgm_params, net_params, opt_state, elbo_history, generator).
    """
    N = data.shape[0]
    num_batches = N // batch_size
    total_steps = num_epochs * num_batches
    k_grp = max(int(steps_per_dispatch), 1)
    history = []
    step_idx = 0
    for _ in range(num_epochs):
        if shuffle:
            perm = torch.randperm(N, generator=generator,
                                  device=generator.device).to(data.device)
        else:
            perm = torch.arange(N, device=data.device)
        b = 0
        while b < num_batches:
            advanced = k_grp if b + k_grp <= num_batches else 1
            for i in range(b, b + advanced):
                batch = data[perm[i * batch_size:(i + 1) * batch_size]]
                pgm_params, net_params, opt_state, elbo, terms = train_step(
                    pgm_params, net_params, opt_state, batch, generator)
                history.append(elbo)  # device scalar: no host sync
            step_idx += advanced
            b += advanced
            # a multiple of callback_every fell within the steps just run
            if callback is not None and (
                    step_idx % callback_every < advanced
                    or step_idx == total_steps):
                callback(step_idx - 1, float(elbo),
                         (pgm_params, net_params, opt_state), terms,
                         generator)
    history = torch.stack(history).tolist() if history else []
    return pgm_params, net_params, opt_state, history, generator


def _batch_signature(batch):
    """Shape identity of a loader batch: its structure and each leaf's
    shape and dtype. The JAX package scans consecutive batches of one
    signature in one dispatch."""
    leaves = tree_leaves(batch)
    return (isinstance(batch, (tuple, list)),
            tuple((tuple(x.shape), str(x.dtype)) for x in leaves))


def run_loader(train_step, pgm_params, net_params, opt_state, get_batches,
               generator, num_epochs, callback=None, callback_every=1,
               steps_per_dispatch=1):
    """Epoch loop driven by a loader factory (``data.loader.make_loader``):
    each epoch iterates ``get_batches(epoch)``, already shuffled,
    length-bucketed and on the device, so ragged corpora train through the
    same callback contract as :func:`run`. Batches may be ``(frames,
    lengths)`` pairs (with ``make_train_step(ragged=True)``).

    Steps run one at a time, in loader order, each drawing its noise from
    ``generator`` after the one before. ``steps_per_dispatch=k`` keeps the
    JAX package's callback cadence: there, runs of k consecutive batches
    of one shape go into one dispatch and the callback fires at the end of
    such a group when a multiple of ``callback_every`` fell within it (a
    shape change or an epoch end runs the partial group step by step). The
    trajectory does not depend on k, as the JAX package's docstring
    guarantees for its own; fusing a group into one CUDA graph is later
    work (ROADMAP.md). The total step count is not known
    up front, so the callback fires on the cadence only.

    ``callback(step, elbo, (pgm_params, net_params, opt_state), terms,
    generator)`` gets ``elbo`` as a float (one host sync per firing). The
    ELBO history stays on the device and is fetched once at the end.
    Returns (pgm_params, net_params, opt_state, elbo_history, generator).
    """
    k_grp = max(int(steps_per_dispatch), 1)
    state = [pgm_params, net_params, opt_state]
    history = []
    step_idx = 0

    def steps(batches):
        nonlocal step_idx
        for batch in batches:
            pgm, net, st, elbo, terms = train_step(*state, batch, generator)
            state[:] = [pgm, net, st]
            history.append(elbo)  # device scalar: no host sync
        step_idx += len(batches)
        # a multiple of callback_every fell within the steps just run
        if callback is not None and step_idx % callback_every < len(batches):
            callback(step_idx - 1, float(elbo), tuple(state), terms,
                     generator)

    for epoch in range(num_epochs):
        pending, sig = [], None
        for batch in get_batches(epoch):
            if pending and _batch_signature(batch) != sig:
                for b in pending:
                    steps([b])
                pending = []
            pending.append(batch)
            sig = _batch_signature(batch)
            if len(pending) == k_grp:
                steps(pending)
                pending = []
        for b in pending:
            steps([b])
    history = torch.stack(history).tolist() if history else []
    return state[0], state[1], state[2], history, generator
