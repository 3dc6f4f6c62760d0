"""MLP stack and Gaussian output heads as ``nn.Module``s (port of
svae_tpu/nets/mlp.py).

A dense layer holds ``W`` as (n_in, n_out) and computes ``x @ W + b``, the
JAX package's layout, so parameters carry over without a transpose
(svae_tpu_torch/convert.py). Every module works on arbitrary leading axes.
"""

import math

import torch
from torch import nn


def matmul(x, W, compute_dtype=None):
    """``x @ W``, or with ``compute_dtype`` (``torch.bfloat16``) the
    product of the operands rounded to it, as a float32 result: the JAX
    package's ``preferred_element_type=float32``. The rounded operands are
    multiplied in float32, where each product of two bf16 values is exact
    (as in ``recognition.ConvSame``). Biases, activations and the PGM
    algebra stay float32: only the nets take this path."""
    if compute_dtype is None:
        return x @ W
    return x.to(compute_dtype).float() @ W.to(compute_dtype).float()


class Dense(nn.Module):
    """``x @ W + b`` with ``W`` (n_in, n_out)."""

    def __init__(self, W, b):
        super().__init__()
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)

    def forward(self, x, compute_dtype=None):
        return matmul(x, self.W, compute_dtype) + self.b


def init_dense(n_in, n_out, generator, scale=1.0, dtype=torch.float32,
               device=None):
    """Glorot-normal weights drawn on ``generator``'s device, zero bias,
    placed on ``device`` (default ``"cuda"``; pass ``"cpu"`` to run on the
    CPU)."""
    std = scale * math.sqrt(2.0 / (n_in + n_out))
    W = std * torch.randn((n_in, n_out), generator=generator, dtype=dtype,
                          device=generator.device)
    device = "cuda" if device is None else device
    return Dense(W.to(device), torch.zeros(n_out, dtype=dtype, device=device))


def softplus(x):
    """log(1 + e^x) as ``logaddexp(x, 0)``, exact for every x (unlike
    ``F.softplus``, which returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class MLP(nn.Module):
    """Hidden stack: tanh after every layer."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, compute_dtype=None):
        for layer in self.layers:
            x = torch.tanh(layer(x, compute_dtype))
        return x


def init_mlp(sizes, generator, scale=1.0, dtype=torch.float32, device=None):
    """Hidden stack for sizes = (d_in, h1, ..., hk), on ``device``
    (default ``"cuda"``)."""
    return MLP([init_dense(m, n, generator, scale, dtype, device)
                for m, n in zip(sizes[:-1], sizes[1:])])


class GaussianInfoHead(nn.Module):
    """Recognition head: h -> diagonal evidence (J_diag, h_lin), with
    J_diag = softplus(.) + eps > 0."""

    def __init__(self, j_layer, h_layer, eps=1e-6):
        super().__init__()
        self.j_layer = j_layer
        self.h_layer = h_layer
        self.eps = eps

    def forward(self, h, compute_dtype=None):
        return (softplus(self.j_layer(h, compute_dtype)) + self.eps,
                self.h_layer(h, compute_dtype))


class GaussianMeanHead(nn.Module):
    """Decoder head: h -> (mu, log_sigmasq); ``mean_fn`` (e.g. sigmoid)
    post-processes the mean block."""

    def __init__(self, mean_layer, sig_layer):
        super().__init__()
        self.mean_layer = mean_layer
        self.sig_layer = sig_layer

    def forward(self, h, mean_fn=None, compute_dtype=None):
        mu = self.mean_layer(h, compute_dtype)
        if mean_fn is not None:
            mu = mean_fn(mu)
        return mu, self.sig_layer(h, compute_dtype)
