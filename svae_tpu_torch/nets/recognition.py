"""Recognition networks: data -> diagonal Gaussian evidence potentials
(port of svae_tpu/nets/recognition.py: the MLP, residual, linear and conv
recognizers)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from svae_tpu_torch.nets.mlp import (MLP, GaussianInfoHead, init_dense,
                                     init_mlp, init_resnet)


class MLPRecognizer(nn.Module):
    """data (..., d_obs) -> (J_diag, h) each (..., d_latent)."""

    def __init__(self, hidden, head):
        super().__init__()
        self.hidden = hidden
        self.head = head

    def forward(self, data, compute_dtype=None):
        return self.head(self.hidden(data, compute_dtype), compute_dtype)


def _info_head(n_in, d_latent, generator, dtype, device):
    return GaussianInfoHead(
        init_dense(n_in, d_latent, generator, dtype=dtype, device=device),
        init_dense(n_in, d_latent, generator, dtype=dtype, device=device))


def init_mlp_recognize(d_obs, hidden_sizes, d_latent, generator,
                       dtype=torch.float32, device=None):
    """Random MLP recognizer on ``device`` (default ``"cuda"``; pass ``"cpu"``
    to run on the CPU), drawn from ``generator``."""
    sizes = (d_obs,) + tuple(hidden_sizes)
    hidden = init_mlp(sizes, generator, dtype=dtype, device=device)
    return MLPRecognizer(hidden, _info_head(sizes[-1], d_latent, generator,
                                            dtype, device))


def mlp_recognize(net, data, compute_dtype=None):
    """The training core's recognize function: ``net(data)``;
    ``compute_dtype`` as in nets.mlp.matmul."""
    return net(data, compute_dtype)


def init_resnet_recognize(d_obs, width, depth, d_latent, generator,
                          dtype=torch.float32, device=None):
    """Random residual recognizer (:class:`MLPRecognizer` over a
    :class:`~svae_tpu_torch.nets.mlp.ResNet` of ``depth`` blocks of
    ``width``) on ``device`` (default ``"cuda"``), drawn from
    ``generator``: the identity skips keep the evidence map
    well-conditioned at depth."""
    stack = init_resnet(d_obs, width, depth, generator, dtype=dtype,
                        device=device)
    return MLPRecognizer(stack, _info_head(width, d_latent, generator, dtype,
                                           device))


def resnet_recognize(net, data, compute_dtype=None):
    """data (..., d_obs) -> (J_diag, h) each (..., d_latent);
    ``compute_dtype`` as in nets.mlp.matmul."""
    return net(data, compute_dtype)


def init_linear_recognize(d_obs, d_latent, generator, dtype=torch.float32,
                          device=None):
    """Random linear recognizer (the head alone, on an empty hidden stack)
    on ``device`` (default ``"cuda"``), drawn from ``generator``."""
    return MLPRecognizer(MLP([]), _info_head(d_obs, d_latent, generator,
                                             dtype, device))


def linear_recognize(net, data):
    """data (..., d_obs) -> (J_diag, h) each (..., d_latent)."""
    return net(data)


class ConvSame(nn.Module):
    """Stride-2 SAME-padded convolution of NCHW frames, weights OIHW
    (C_out, C_in, k, k). SAME at stride 2 pads asymmetrically: the JAX
    package's ``_conv2d_im2col`` puts ``((Ho - 1) s + k - H) // 2`` rows
    before the frame and the rest after it (0 and 1 at H=16, k=3), which
    ``conv2d(padding=)`` cannot express, so the frame is padded first."""

    STRIDE = 2

    def __init__(self, W, b):
        super().__init__()
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)

    def forward(self, x, compute_dtype=None):
        k, s = self.W.shape[-1], self.STRIDE
        pads = []
        for n in (x.shape[-1], x.shape[-2]):  # F.pad's order: W, then H
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        x, W = F.pad(x, pads), self.W
        if compute_dtype is not None:
            # the operands rounded to compute_dtype, a float32 result (as
            # nets.mlp.matmul; each product of two bf16 values is exact)
            x, W = x.to(compute_dtype).float(), W.to(compute_dtype).float()
        return F.conv2d(x, W, self.b, stride=s)


class ConvRecognizer(nn.Module):
    """Per-frame conv feature stack and Gaussian info head, for
    image-sequence LDS models (BASELINE config 4): tanh after each
    stride-2 conv, then the head on the features flattened in H, W, C
    order, the JAX package's (so its head weights carry over as they
    are)."""

    def __init__(self, convs, head):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.head = head

    def forward(self, data, frame_shape, compute_dtype=None):
        H, W, C = _frame3(frame_shape)
        lead = data.shape[:-1]
        x = data.reshape(-1, H, W, C).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = torch.tanh(conv(x, compute_dtype))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        J_diag, h = self.head(x, compute_dtype)
        shape = lead + (h.shape[-1],)
        return J_diag.reshape(shape), h.reshape(shape)


def _frame3(frame_shape):
    """(H, W) or (H, W, C) -> (H, W, C)."""
    frame_shape = tuple(frame_shape)
    return frame_shape + (1,) if len(frame_shape) == 2 else frame_shape


def init_conv_recognize(frame_shape, channels, kernel_size, d_latent,
                        generator, dtype=torch.float32, device=None):
    """Random conv recognizer on ``device`` (default ``"cuda"``; pass
    ``"cpu"`` to run on the CPU), drawn from ``generator``: each kernel
    normal with std sqrt(2 / (fan_in + fan_out)), drawn in the JAX
    package's (k, k, C_in, C_out) layout, zero biases, a Glorot head.
    ``frame_shape`` = (H, W) or (H, W, C); frames are treated
    independently (the temporal structure lives in the PGM). The frame
    shape is not a parameter: apply with ``make_conv_recognize``."""
    H, W, C = _frame3(frame_shape)
    device = "cuda" if device is None else device
    convs, c_in = [], C
    for c_out in channels:
        std = math.sqrt(2.0 / (kernel_size * kernel_size * (c_in + c_out)))
        Wk = std * torch.randn((kernel_size, kernel_size, c_in, c_out),
                               generator=generator, dtype=dtype,
                               device=generator.device)
        convs.append(ConvSame(Wk.permute(3, 2, 0, 1).contiguous().to(device),
                              torch.zeros(c_out, dtype=dtype, device=device)))
        c_in = c_out
    # stride-2 convs halve each spatial dim per layer
    h_out, w_out = H, W
    for _ in channels:
        h_out, w_out = (h_out + 1) // 2, (w_out + 1) // 2
    feat = h_out * w_out * c_in
    head = GaussianInfoHead(
        init_dense(feat, d_latent, generator, dtype=dtype, device=device),
        init_dense(feat, d_latent, generator, dtype=dtype, device=device))
    return ConvRecognizer(convs, head)


def conv_recognize(net, data, frame_shape, compute_dtype=None):
    """data (..., H*W*C) -> (J_diag, h) on (..., d_latent). Every leading
    axis (batch, time) goes into one batch of frames.
    ``compute_dtype=torch.bfloat16`` runs the convs and the head on bf16
    operands with a float32 result (nets.mlp.matmul)."""
    return net(data, frame_shape, compute_dtype)


def make_conv_recognize(frame_shape, compute_dtype=None):
    """Close over the frame shape (and the optional reduced-precision
    compute dtype) -> ``recognize(net, data)``, usable directly as the
    training core's recognize function."""

    def recognize(net, data):
        return conv_recognize(net, data, frame_shape,
                              compute_dtype=compute_dtype)

    return recognize
