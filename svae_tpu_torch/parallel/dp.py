"""Data-parallel, MC-particle-sharded SVI train step over
``torch.distributed`` (port of svae_tpu/parallel/dp.py).

Each rank of a :class:`~svae_tpu_torch.parallel.mesh.Mesh` runs the step
on its slice of the global batch with its own particles; one collective
joins them:

  * the ELBO, the net gradients, the detached expected sufficient
    statistics and the metric terms are averaged over ``mc`` (each mc
    shard holds independent reparameterization particles of the same
    term) and summed over ``data`` (each data shard contributes a term).
    The mean over mc of a sum over data is 1/M times the sum over all
    data * mc ranks, so the step packs them into one flat buffer and
    reduces it with ONE ``all_reduce`` over the mesh's group, scaled by
    1/M;
  * the natural gradient is then assembled from the *globally summed*
    statistics, ``natgrad = scale/N * (prior + (N/B_global) * stats_total
    - params)``, and the optimizer update runs replicated and
    deterministic on every rank (all its inputs are post-collective).

Per-shard noise: the step takes one generator that is the same on every
rank (as the JAX step takes a replicated key) and folds its state with the
rank's (data, mc) coordinates into the shard's own generator
(:func:`shard_generator`), so every shard draws independent particles.
"""

import hashlib

import torch
import torch.distributed as dist

from svae_tpu_torch.parallel.mesh import local_batch_size
from svae_tpu_torch.train import elbo as elbo_lib
from svae_tpu_torch.train.optim import make_optimizer
from svae_tpu_torch.utils.pytree import (tree_add, tree_leaves, tree_map,
                                         tree_scale, tree_sub)


def _hash63(*parts):
    data = b"\0".join(p if isinstance(p, bytes) else str(p).encode()
                      for p in parts)
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") >> 1


def shard_generator(seed, mesh, device):
    """A generator on ``device`` for this rank's shard, seeded from
    ``seed``, the data index and ``mc_index + 7919``."""
    return torch.Generator(device=device).manual_seed(
        _hash63(int(seed), mesh.data_index, mesh.mc_index + 7919))


def _fold(generator):
    """A seed taken from ``generator``'s state, the generator then moved on
    (reseeded from the same hash): identical on every rank that holds the
    same state, and no host sync, since a generator's state is host-side."""
    state = generator.get_state().numpy().tobytes()
    generator.manual_seed(_hash63(state, "next"))
    return _hash63(state, "step")


def make_dp_train_step(run_inference, recognize, loglike, pgm_prior, N,
                       mesh, global_batch, num_samples=1, natgrad_scale=1.0,
                       pgm_step_size=1.0, net_optimizer=None,
                       net_step_size=1e-3, mask_fn=None, ragged=False):
    """Build ``(init_state, train_step)`` like ``train.loop.
    make_train_step``, but data-parallel over ``mesh`` (axes ``("mc",
    "data")``). ``mask_fn`` enables missing-data training as in
    ``train.elbo.make_objective`` (applied per data shard: masking is
    elementwise, so it commutes with the batch sharding); ``ragged`` makes
    the batch a ``(frames, lengths)`` pair from the length-bucketed loader,
    both sliced over ``data``.

    ``train_step(pgm_params, net_params, opt_state, local_batch,
    generator)`` takes this rank's ``global_batch / data`` slice of the
    global batch (``data.loader.make_loader(sharding=mesh)`` yields it)
    and a generator identical on every rank; ``num_samples`` is the
    per-shard particle count, so the effective MC sample size is
    ``num_samples * mesh.shape["mc"]``. Returns ``(pgm_params, net_params,
    opt_state, elbo, terms)``, the contract of ``make_train_step``: the
    updated parameters and state (the same on every rank), the global ELBO
    per datapoint and the metrics dict (the three ELBO components and the
    net-gradient norm), so the loop and experiment layers take it
    unchanged."""
    if not mesh.on_mesh:
        raise ValueError(f"rank {dist.get_rank()} holds no shard of the "
                         f"mesh {mesh.shape}")
    opt_init, opt_update = make_optimizer(net_optimizer, pgm_step_size,
                                          net_step_size)
    D, M = mesh.shape["data"], mesh.shape["mc"]
    B_local = local_batch_size(global_batch, mesh)
    scale = N / global_batch

    def step(pgm_params, net_params, opt_state, local_batch, generator):
        B = (local_batch[0] if ragged else local_batch).shape[0]
        if B != B_local:
            raise ValueError(f"local batch of {B}, expected {B_local} "
                             f"(global batch {global_batch} over {D} data "
                             f"shards)")
        gen = (None if generator is None else
               shard_generator(_fold(generator), mesh, generator.device))
        params = [p for ps in elbo_lib.net_parameters(net_params)
                  for p in ps]
        # per-shard objective: the data terms get N / B_GLOBAL (the shards
        # are summed), and the replicated global KL is spread over the D
        # data shards so that the sum counts it once
        with torch.enable_grad():
            ll, stats, global_kl, local_kl, _ = elbo_lib.masked_forward(
                run_inference, recognize, loglike, pgm_prior, pgm_params,
                net_params, local_batch, gen, num_samples, mask_fn, ragged)
            obj = (scale * (ll - local_kl) - global_kl / D) / N
            grads = torch.autograd.grad(obj, params)
        # per-shard metric terms, per datapoint of the GLOBAL batch
        terms = (ll / global_batch, local_kl / global_batch,
                 global_kl / (N * D))
        parts = [obj, *terms, *tree_leaves(stats), *grads]
        parts = [x.detach() if isinstance(x, torch.Tensor) else
                 torch.tensor(x, dtype=obj.dtype, device=obj.device)
                 for x in parts]
        dtype = parts[0].dtype
        for x in parts[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        buf = torch.cat([x.reshape(-1).to(dtype) for x in parts])
        # particles average, data shards sum: one collective a step
        dist.all_reduce(buf, group=mesh.group)
        if M > 1:
            buf = buf / M
        it = iter(x.view(p.shape).to(p.dtype) for x, p in
                  zip(buf.split([p.numel() for p in parts]), parts))
        elbo = next(it)
        terms = {k: next(it) for k in ("loglike", "local_kl", "global_kl")}
        stats = tree_map(lambda _: next(it), stats)
        gnet = tuple(tuple(next(it) for _ in ps)
                     for ps in elbo_lib.net_parameters(net_params))

        natgrad = tree_scale(
            tree_sub(tree_add(pgm_prior, tree_scale(stats, scale)),
                     pgm_params),
            natgrad_scale / N)
        terms["net_grad_norm"] = torch.sqrt(
            sum((g * g).sum() for gs in gnet for g in gs))
        pgm_params, net_params, opt_state = opt_update(
            opt_state, pgm_params, net_params, natgrad, gnet)
        return pgm_params, net_params, opt_state, elbo, terms

    return opt_init, step
