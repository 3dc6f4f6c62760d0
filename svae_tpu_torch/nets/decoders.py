"""Decoders: latent samples -> log-likelihood of data (port of
svae_tpu/nets/decoders.py: the MLP and linear decoders)."""

import math

import torch
from torch import nn

from svae_tpu_torch.nets.mlp import (MLP, GaussianMeanHead, init_dense,
                                     init_mlp)

LOG2PI = math.log(2 * math.pi)


class MLPDecoder(nn.Module):
    """x (..., d_latent) -> (mu, log_sigmasq) each (..., d_obs)."""

    def __init__(self, hidden, head):
        super().__init__()
        self.hidden = hidden
        self.head = head

    def forward(self, x, mean_fn=None, compute_dtype=None):
        return self.head(self.hidden(x, compute_dtype), mean_fn=mean_fn,
                         compute_dtype=compute_dtype)


def _mean_head(n_in, d_obs, generator, dtype, device):
    return GaussianMeanHead(
        init_dense(n_in, d_obs, generator, dtype=dtype, device=device),
        init_dense(n_in, d_obs, generator, dtype=dtype, device=device))


def init_mlp_decode(d_latent, hidden_sizes, d_obs, generator,
                    dtype=torch.float32, device=None):
    """Random MLP decoder on ``device`` (default ``"cuda"``; pass ``"cpu"``
    to run on the CPU), drawn from ``generator``."""
    sizes = (d_latent,) + tuple(hidden_sizes)
    hidden = init_mlp(sizes, generator, dtype=dtype, device=device)
    return MLPDecoder(hidden, _mean_head(sizes[-1], d_obs, generator, dtype,
                                         device))


def init_linear_decode(d_latent, d_obs, generator, dtype=torch.float32,
                       device=None):
    """Random linear decoder (the head alone, on an empty hidden stack) on
    ``device`` (default ``"cuda"``), drawn from ``generator``."""
    return MLPDecoder(MLP([]), _mean_head(d_latent, d_obs, generator, dtype,
                                          device))


def mlp_decode(net, x, mean_fn=None, compute_dtype=None):
    """x (..., d_latent) -> (mu, log_sigmasq) each (..., d_obs).
    ``compute_dtype=torch.bfloat16`` runs the products on bf16 operands
    with a float32 result (nets.mlp.matmul)."""
    return net(x, mean_fn=mean_fn, compute_dtype=compute_dtype)


def linear_decode(net, x, mean_fn=None):
    """x (..., d_latent) -> (mu, log_sigmasq) each (..., d_obs)."""
    return net(x, mean_fn=mean_fn)


def diag_gaussian_loglike(y, mu, log_sigmasq):
    """Sum over the last axis of log N(y | mu, diag(exp(log_sigmasq)))."""
    return -0.5 * ((y - mu) ** 2 / torch.exp(log_sigmasq) + log_sigmasq
                   + LOG2PI).sum(-1)


def mlp_loglike(net, samples, y, mean_fn=None, mask=None,
                compute_dtype=None):
    """MC-averaged decoder log-likelihood, summed over the batch.

    ``samples`` (num_samples, ...batch..., d_latent) or
    (...batch..., d_latent); ``y`` (...batch..., d_obs). Sample axes are
    averaged, batch and time axes summed. ``mask`` (broadcastable to y's
    batch axes, {0,1} or bool) drops missing frames from the sum.
    ``compute_dtype`` as in :func:`mlp_decode`; the log-density itself
    stays float32."""
    return _mc_loglike(*mlp_decode(net, samples, mean_fn=mean_fn,
                                   compute_dtype=compute_dtype), y, mask)


def linear_loglike(net, samples, y, mean_fn=None, mask=None):
    """:func:`mlp_loglike` of a linear decoder (no ``compute_dtype``)."""
    return _mc_loglike(*linear_decode(net, samples, mean_fn=mean_fn), y,
                       mask)


def _mc_loglike(mu, log_sigmasq, y, mask):
    """The log-density of ``y`` averaged over the sample axes of (mu,
    log_sigmasq) and summed over the batch, ``mask`` dropping frames."""
    ll = diag_gaussian_loglike(y, mu, log_sigmasq)
    extra = ll.dim() - (y.dim() - 1)
    if extra > 0:
        ll = ll.mean(dim=tuple(range(extra)))
    if mask is not None:
        ll = ll * torch.as_tensor(mask, device=ll.device).to(ll.dtype)
    return ll.sum()


def make_mlp_loglike(mean_fn=None, compute_dtype=None):
    """Close over the decode options -> ``loglike(net, samples, y,
    mask=None)``, usable directly as the training core's loglike."""

    def loglike(net, samples, y, mask=None):
        return mlp_loglike(net, samples, y, mean_fn=mean_fn, mask=mask,
                           compute_dtype=compute_dtype)

    return loglike
