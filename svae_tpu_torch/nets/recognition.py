"""Recognition network: data -> diagonal Gaussian evidence potentials
(port of svae_tpu/nets/recognition.py, MLP recognizer)."""

import torch
from torch import nn

from svae_tpu_torch.nets.mlp import GaussianInfoHead, init_dense, init_mlp


class MLPRecognizer(nn.Module):
    """data (..., d_obs) -> (J_diag, h) each (..., d_latent)."""

    def __init__(self, hidden, head):
        super().__init__()
        self.hidden = hidden
        self.head = head

    def forward(self, data):
        return self.head(self.hidden(data))


def init_mlp_recognize(d_obs, hidden_sizes, d_latent, generator,
                       dtype=torch.float32, device=None):
    """Random MLP recognizer on ``device`` (default ``"cuda"``; pass ``"cpu"``
    to run on the CPU), drawn from ``generator``."""
    sizes = (d_obs,) + tuple(hidden_sizes)
    hidden = init_mlp(sizes, generator, dtype=dtype, device=device)
    head = GaussianInfoHead(
        init_dense(sizes[-1], d_latent, generator, dtype=dtype, device=device),
        init_dense(sizes[-1], d_latent, generator, dtype=dtype, device=device))
    return MLPRecognizer(hidden, head)


def mlp_recognize(net, data):
    """The training core's recognize function: ``net(data)``."""
    return net(data)
