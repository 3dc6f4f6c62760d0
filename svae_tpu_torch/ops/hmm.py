"""Discrete-chain helpers on plain torch ops (port of the part of
svae_tpu/ops/hmm.py that the port needs): the Viterbi decode.

The chain elements are M_t(i, j) = log_trans(i, j) + log_obs_{t+1}(j), as
in :mod:`svae_tpu_torch.ops.hmm_fb`. There is no kernel here: the decode
is a loop over T of max-plus ops batched over the sequences.
"""

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
