"""Categorical distribution over K labels in natural (logit) form (port of
svae_tpu/expfam/categorical.py): ``logZ = logsumexp(eta)`` summed over the
leading axes and ``expectedstats = softmax(eta)`` on the last axis."""

import torch


def standard_to_natural(probs):
    return torch.log(probs)


def natural_to_standard(natparam):
    return torch.softmax(natparam, dim=-1)


def logZ(natparam):
    return torch.logsumexp(natparam, dim=-1).sum()


def expectedstats(natparam):
    return torch.softmax(natparam, dim=-1)
