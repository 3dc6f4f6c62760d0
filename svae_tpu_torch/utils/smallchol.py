"""Small-matrix Cholesky factor and solves on ``torch.linalg``.

The JAX package unrolls these by hand because XLA:TPU lowers a batched
``cholesky`` to a serial While loop (svae_tpu/utils/smallchol.py). PyTorch
runs the batched factor and triangular solves as single ops with their own
backward, so thin wrappers suffice here.

``chol`` uses ``torch.linalg.cholesky_ex``: ``torch.linalg.cholesky``
copies its ``info`` to the host on every call to raise, which stalls the
launch queue on a card. A factor whose ``info`` is not 0 is poisoned with
NaN instead (as the unrolled factor of the JAX package and the CUDA kernels
give NaN from ``sqrt`` of a negative pivot), so one finiteness check at
the end of a phase (:func:`check_finite`) covers every factor in it.
"""

import torch

from svae_tpu_torch.utils.pytree import tree_leaves


def check_finite(tree, what):
    """Raise ``FloatingPointError`` unless every leaf of ``tree`` is finite.

    The one check of a phase: it costs one host sync. A factor that failed
    in :func:`chol` is NaN, as is everything computed from it, so a phase
    whose outputs are finite had every factor succeed."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    flat = torch.cat([torch.as_tensor(x, device=dev).detach().reshape(-1)
                      for x in leaves])
    if not bool(torch.isfinite(flat).all()):
        raise FloatingPointError(
            f"{what}: non-finite result; a Cholesky factor failed (a "
            f"precision that should be positive definite is not)")


def chol(A):
    """Lower Cholesky factor of SPD ``A`` (..., d, d); reads the lower
    triangle only (callers symmetrize first). NaN where it fails."""
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0)[..., None, None]
    return torch.where(ok, L, torch.full_like(L, float("nan")))


def solve_lower(L, b):
    """x = L^{-1} b for vector ``b`` (..., d); L broadcasts against b."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def solve_upper_from_lower(L, b):
    """x = L^{-T} b for vector ``b`` (..., d)."""
    return torch.linalg.solve_triangular(
        L.mT, b[..., None], upper=True)[..., 0]


def cho_solve(L, b):
    """Vector solve A x = b with A = L L^T; b (..., d)."""
    return solve_upper_from_lower(L, solve_lower(L, b))


def cho_solve_mat(L, B):
    """Matrix solve A X = B with A = L L^T; B (..., d, m)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)
