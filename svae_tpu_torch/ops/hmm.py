"""Discrete-chain helpers on plain torch ops (port of the part of
svae_tpu/ops/hmm.py that the port needs): the Viterbi decode and posterior
path sampling.

The chain elements are M_t(i, j) = log_trans(i, j) + log_obs_{t+1}(j), as
in :mod:`svae_tpu_torch.ops.hmm_fb`. There is no kernel here (the JAX
package has none for these either): each is a loop over T of max-plus or
log-sum-exp ops batched over the sequences.
"""

import math

import torch


def hmm_viterbi(log_init, log_trans, log_obs):
    """MAP state paths of B chains by max-plus message passing: ``(path
    int32 (B, T), score (B,))`` with ``score = max_z log p(z, y)`` up to
    the observation normalizer.

    ``log_init`` (K,); ``log_trans`` (K, K), shared, or (B, T-1, K, K);
    ``log_obs`` (B, T, K). The traceback needs no stored backpointers:
    with every forward message delta_t kept, z_t = argmax_i delta_t(i) +
    M_t(i, z_{t+1}) re-derives them. Ties go to the lowest state, as in
    the JAX package."""
    B, T, K = log_obs.shape
    M = log_trans + log_obs[:, 1:, None, :]              # (B, T-1, K, K)
    delta = [log_init + log_obs[:, 0]]
    for t in range(T - 1):
        delta.append((delta[-1][:, :, None] + M[:, t]).amax(1))
    z = delta[-1].argmax(-1)
    score = delta[-1].gather(1, z[:, None])[:, 0]
    path = [z]
    rows = torch.arange(B, device=log_obs.device)
    for t in reversed(range(T - 1)):
        z = (delta[t] + M[rows, t, :, z]).argmax(-1)
        path.append(z)
    return torch.stack(path[::-1], 1).to(torch.int32), score


def gumbel(shape, generator, dtype, device):
    """Standard Gumbel noise ``-log(-log U)`` drawn by ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def hmm_sample(log_init, log_trans, log_obs, generator, num_samples=(),
               parallel=False, gumbel_noise=None):
    """Posterior path samples of B chains: backward log-messages, then
    forward sampling by Gumbel argmax (discrete; no reparameterization).
    Returns int32 paths ``(B,) + num_samples + (T,)`` (``num_samples`` an
    int or a shape tuple S).

    ``log_init`` (K,); ``log_trans`` (K, K), shared, or (B, T-1, K, K);
    ``log_obs`` (B, T, K). ``generator`` draws the Gumbel noise unless
    ``gumbel_noise`` = (g0, gs) gives it in the JAX package's layout per
    sequence, a batch axis in front: g0 (B,) + S + (K,) for the first frame
    and gs (B, T-1) + S + (K,) for the rest. ``parallel=True`` (the JAX
    package's associative scan of the backward messages) is not ported and
    raises."""
    if parallel:
        raise NotImplementedError(
            "hmm_sample(parallel=...): the associative scan of the backward "
            "messages is not ported (ROADMAP.md Queue 1)")
    if isinstance(num_samples, int):
        num_samples = (num_samples,)
    S = tuple(num_samples)
    B, T, K = log_obs.shape
    P = math.prod(S)
    M = log_trans + log_obs[:, 1:, None, :]              # (B, T-1, K, K)
    # beta[t](i): the log-mass of the futures given z_t = i
    beta = [log_obs.new_zeros(B, K)]
    for t in reversed(range(T - 1)):
        beta.append(torch.logsumexp(M[:, t] + beta[-1][:, None, :], -1))
    beta = beta[::-1]
    if gumbel_noise is None:
        kw = dict(dtype=log_obs.dtype, device=log_obs.device)
        gumbel_noise = (gumbel((B,) + S + (K,), generator, **kw),
                        gumbel((B, T - 1) + S + (K,), generator, **kw))
    g0, gs = gumbel_noise
    gs = gs.reshape(B, T - 1, P, K)
    a0 = log_init + log_obs[:, 0] + beta[0]                # (B, K)
    z = (a0[:, None] + g0.reshape(B, P, K)).argmax(-1)     # (B, P)
    path = [z]
    for t in range(T - 1):
        rows = M[:, t].gather(1, z[..., None].expand(B, P, K))
        z = (rows + beta[t + 1][:, None] + gs[:, t]).argmax(-1)
        path.append(z)
    return torch.stack(path, -1).reshape((B,) + S + (T,)).to(torch.int32)
