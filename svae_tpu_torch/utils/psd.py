"""Positive-definite matrix helpers for the expfam layer and the E-step
(port of svae_tpu/utils/psd.py).

Precision note: a float32 matmul that rounds its operands (TF32 on Hopper,
as the MXU's bf16 passes on the TPU) is enough to break positive
definiteness inside chained Schur complements. :func:`f32_linalg` turns
TF32 off for matmuls and cuDNN and sets float32 matmul precision to
"highest" for the duration of a call, and restores the caller's settings
afterwards.
"""

import contextlib
import math

import torch

from svae_tpu_torch.utils import smallchol


@contextlib.contextmanager
def f32_linalg():
    """No TF32 anywhere and float32 matmul precision "highest" for the
    duration: ``with f32_linalg():`` or ``@f32_linalg()``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def symmetrize(a):
    """(a + a^T)/2 on the last two axes."""
    return 0.5 * (a + a.mT)


def _chol(a):
    return smallchol.chol(symmetrize(a))


def eye_like(a):
    """Identity broadcast to the shape of the (..., d, d) tensor ``a``."""
    d = a.shape[-1]
    return torch.eye(d, dtype=a.dtype, device=a.device).expand(a.shape)


def solve_psd(a, b):
    """Solve ``a x = b`` for SPD ``a``; matrix RHS ``b`` (..., d, m)."""
    return smallchol.cho_solve_mat(_chol(a), b)


def logdet_psd(a):
    """log|a| for symmetric positive-definite ``a`` (batched ok)."""
    L = _chol(a)
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def inv_psd(a):
    """Inverse of a symmetric positive-definite matrix via Cholesky."""
    return smallchol.cho_solve_mat(_chol(a), eye_like(a))


def mvn_logZ_info(J, h):
    """Log-partition of an unnormalized Gaussian in information form:
    ``d/2 log(2 pi) - 1/2 log|J| + 1/2 h^T J^{-1} h``."""
    d = h.shape[-1]
    L = _chol(J)
    v = smallchol.solve_lower(L, h)
    half_quad = 0.5 * (v * v).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return 0.5 * d * math.log(2 * math.pi) - 0.5 * logdet + half_quad
