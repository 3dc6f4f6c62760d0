"""Multivariate Gaussian in natural (information) form (port of
svae_tpu/expfam/gaussian.py; the convention is documented there).

``p(x) = exp(<eta1, x x^T> + <eta2, x> - logZ(eta))`` with ``eta1 = -1/2
Lambda`` (Lambda the precision) and ``eta2 = Lambda mu``; the sufficient
statistics are ``(x x^T, x)``, so ``expectedstats`` equals the autograd of
``logZ`` (tested). Natural parameters are ``(eta1, eta2)`` tuples batched
over leading axes.
"""

import torch

from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import (inv_psd, mvn_logZ_info, solve_psd,
                                      symmetrize)
from svae_tpu_torch.utils.pytree import tree_dot, tree_sub


def standard_to_natural(mu, Sigma):
    """(mu, Sigma) -> (eta1, eta2) = (-1/2 Sigma^-1, Sigma^-1 mu)."""
    Lam = inv_psd(Sigma)
    return (-0.5 * Lam, (Lam @ mu[..., None])[..., 0])


def natural_to_standard(natparam):
    eta1, eta2 = natparam
    J = -2.0 * eta1
    return solve_psd(J, eta2[..., None])[..., 0], inv_psd(J)


def info_params(natparam):
    """Information form ``(J, h)``: J = -2 eta1 (the precision), h = eta2."""
    eta1, eta2 = natparam
    return -2.0 * eta1, eta2


def from_info(J, h):
    """Information form (J, h) -> natural (eta1, eta2)."""
    return (-0.5 * J, h)


def logZ(natparam):
    """Log-partition, batched over leading axes."""
    eta1, eta2 = natparam
    return mvn_logZ_info(-2.0 * eta1, eta2)


def expectedstats(natparam):
    """Closed-form ``(E[x x^T], E[x])``."""
    eta1, eta2 = natparam
    Sigma = inv_psd(-2.0 * eta1)
    mu = (Sigma @ eta2[..., None])[..., 0]
    return symmetrize(Sigma + mu[..., :, None] * mu[..., None, :]), mu


def natural_sample(natparam, generator, num_samples=(), eps=None):
    """Reparameterized samples ``x = mu + L^-T eps`` with J = L L^T, shaped
    ``num_samples + mu.shape`` (``num_samples`` an int or a shape tuple).
    ``generator`` draws the standard normal ``eps`` unless it is given:
    the JAX package's ``normal(key, num_samples + mu.shape)``.
    Differentiable with respect to the natural parameters."""
    if isinstance(num_samples, int):
        num_samples = (num_samples,)
    eta1, eta2 = natparam
    L = smallchol.chol(symmetrize(-2.0 * eta1))
    mu = smallchol.cho_solve(L, eta2)
    if eps is None:
        if generator is None:
            raise ValueError("natural_sample: pass a torch.Generator or eps; "
                             "the global RNG is not used")
        eps = torch.randn(tuple(num_samples) + tuple(mu.shape),
                          generator=generator, dtype=mu.dtype,
                          device=mu.device)
    return mu + smallchol.solve_upper_from_lower(L, eps)


def kl(natparam_q, natparam_p):
    """KL(q || p) between Gaussians in natural form."""
    return (tree_dot(tree_sub(natparam_q, natparam_p),
                     expectedstats(natparam_q))
            - logZ(natparam_q) + logZ(natparam_p))


def pack_dense(J_diag, h):
    """Diagonal node potentials (J_diag > 0, h) -> the dense natural form
    (eta1 = -1/2 diag(J_diag), eta2 = h)."""
    return (-0.5 * torch.diag_embed(J_diag), h)
