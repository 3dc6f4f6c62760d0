"""Normal-inverse-Wishart on a Gaussian's (mu, Sigma) (port of
svae_tpu/expfam/niw.py; the parameterizations are documented there).

Natural parameters ``eta = (Phi + kappa m m^T, kappa m, kappa, nu + d + 2)``
are a tuple of tensors; ``expectedstats`` is closed form and equals the
autograd of ``logZ`` (tested).
"""

import math

import torch

from svae_tpu_torch.utils.psd import symmetrize, logdet_psd, inv_psd


def standard_to_natural(Phi, m, kappa, nu):
    d = m.shape[-1]
    eta1 = Phi + kappa[..., None, None] * (m[..., :, None] * m[..., None, :])
    eta2 = kappa[..., None] * m
    return (eta1, eta2, kappa, nu + d + 2)


def natural_to_standard(natparam):
    eta1, eta2, eta3, eta4 = natparam
    d = eta2.shape[-1]
    kappa = eta3
    m = eta2 / kappa[..., None]
    Phi = eta1 - (eta2[..., :, None] * eta2[..., None, :]) / kappa[..., None, None]
    nu = eta4 - d - 2
    return symmetrize(Phi), m, kappa, nu


def logZ(natparam):
    """``d/2 log(2 pi / kappa) + nu d / 2 log 2 + log Gamma_d(nu/2)
    - nu/2 logdet(Phi)``"""
    Phi, m, kappa, nu = natural_to_standard(natparam)
    d = m.shape[-1]
    return (
        0.5 * d * (math.log(2 * math.pi) - torch.log(kappa))
        + 0.5 * nu * d * math.log(2.0)
        + torch.mvlgamma(0.5 * nu, d)
        - 0.5 * nu * logdet_psd(Phi)
    )


def expected_neg_half_logdet_sigma(Phi, nu, d):
    """E[-1/2 logdet Sigma] under IW(Phi, nu):
    E[logdet Sigma] = logdet Phi - d log 2 - sum_i digamma((nu + 1 - i)/2)."""
    i = torch.arange(1, d + 1, dtype=Phi.dtype, device=Phi.device)
    dig = torch.special.digamma(0.5 * (nu[..., None] + 1.0 - i)).sum(-1)
    return -0.5 * (logdet_psd(Phi) - d * math.log(2.0) - dig)


def expectedstats(natparam):
    """(E[-1/2 Sigma^-1], E[Sigma^-1 mu], E[-1/2 mu^T Sigma^-1 mu],
    E[-1/2 logdet Sigma]) in closed form."""
    Phi, m, kappa, nu = natural_to_standard(natparam)
    d = m.shape[-1]
    E_Lam = nu[..., None, None] * inv_psd(Phi)  # E[Sigma^-1]
    E_t1 = -0.5 * E_Lam
    E_t2 = (E_Lam @ m[..., None])[..., 0]
    E_t3 = -0.5 * (d / kappa + (m * E_t2).sum(-1))
    E_t4 = expected_neg_half_logdet_sigma(Phi, nu, d)
    return (E_t1, E_t2, E_t3, E_t4)


def expected_gaussian_natparam(natparam):
    """``((E_t1, E_t2), const)`` with const = E_t3 + E_t4 - d/2 log 2pi:
    the expected Gaussian potential on the latent the NIW governs."""
    E_t1, E_t2, E_t3, E_t4 = expectedstats(natparam)
    d = E_t2.shape[-1]
    const = E_t3 + E_t4 - 0.5 * d * math.log(2 * math.pi)
    return (E_t1, E_t2), const
