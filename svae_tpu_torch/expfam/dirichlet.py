"""Dirichlet: the conjugate prior of mixture weights and HMM transition
rows (port of svae_tpu/expfam/dirichlet.py).

Natural parameter ``eta = alpha - 1``, paired with the sufficient
statistic ``log pi``; the distribution acts on the last axis, so a (K, K)
array is K independent transition rows. ``expectedstats`` is the digamma
form and equals the autograd of ``logZ`` (tested).
"""

import torch


def standard_to_natural(alpha):
    return alpha - 1.0


def natural_to_standard(natparam):
    return natparam + 1.0


def logZ(natparam):
    """Sum over the rows of ``sum_k lgamma(alpha_k) - lgamma(sum_k
    alpha_k)``."""
    alpha = natparam + 1.0
    return (torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))).sum()


def expectedstats(natparam):
    """E[log pi] = digamma(alpha) - digamma(sum alpha)."""
    alpha = natparam + 1.0
    return (torch.special.digamma(alpha)
            - torch.special.digamma(alpha.sum(-1, keepdim=True)))
