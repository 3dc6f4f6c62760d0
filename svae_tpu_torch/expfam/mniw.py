"""Matrix-normal-inverse-Wishart on linear-Gaussian dynamics (A, Sigma)
(port of svae_tpu/expfam/mniw.py; the parameterizations are documented
there).

Natural parameters ``eta = (Phi + M V^-1 M^T, M V^-1, V^-1, nu + d + 1 + n)``
are a tuple of tensors; ``expectedstats`` is closed form and equals the
autograd of ``logZ`` (tested).
"""

import math

import torch

from svae_tpu_torch.expfam.niw import expected_neg_half_logdet_sigma
from svae_tpu_torch.utils.psd import symmetrize, logdet_psd, inv_psd


def standard_to_natural(Phi, M, V, nu):
    d, n = M.shape[-2], M.shape[-1]
    V_inv = inv_psd(V)
    MVi = M @ V_inv
    eta1 = Phi + MVi @ M.mT
    return (eta1, MVi, V_inv, nu + d + 1 + n)


def natural_to_standard(natparam):
    eta1, eta2, eta3, eta4 = natparam
    d, n = eta2.shape[-2], eta2.shape[-1]
    V = inv_psd(eta3)
    M = eta2 @ V
    Phi = eta1 - eta2 @ V @ eta2.mT
    nu = eta4 - d - 1 - n
    return symmetrize(Phi), M, symmetrize(V), nu


def logZ(natparam):
    """``nd/2 log(2 pi) - d/2 logdet(V^-1) + nu d/2 log 2
    + log Gamma_d(nu/2) - nu/2 logdet(Phi)``"""
    eta3 = natparam[2]
    Phi, M, V, nu = natural_to_standard(natparam)
    d, n = M.shape[-2], M.shape[-1]
    return (
        0.5 * n * d * math.log(2 * math.pi)
        - 0.5 * d * logdet_psd(eta3)
        + 0.5 * nu * d * math.log(2.0)
        + torch.mvlgamma(0.5 * nu, d)
        - 0.5 * nu * logdet_psd(Phi)
    )


def expectedstats(natparam):
    """(E[-1/2 Sigma^-1], E[Sigma^-1 A], E[-1/2 A^T Sigma^-1 A],
    E[-1/2 logdet Sigma]) in closed form."""
    Phi, M, V, nu = natural_to_standard(natparam)
    d = M.shape[-2]
    E_Lam = nu[..., None, None] * inv_psd(Phi)  # E[Sigma^-1]
    E_t1 = -0.5 * E_Lam
    E_t2 = E_Lam @ M
    # E[A^T Sigma^-1 A] = M^T E[Sigma^-1] M + d V
    E_t3 = -0.5 * symmetrize(M.mT @ E_t2 + d * V)
    E_t4 = expected_neg_half_logdet_sigma(Phi, nu, d)
    return (E_t1, E_t2, E_t3, E_t4)


def posterior_mean_params(natparam):
    """The posterior-mean dynamics ``(E[A], E[Sigma]) = (M, Phi / (nu - d
    - 1))`` (the inverse-Wishart mean, nu > d + 1), for the forecasts of
    models.lds.predict and models.slds.predict."""
    Phi, M, V, nu = natural_to_standard(natparam)
    d = M.shape[-2]
    return M, symmetrize(Phi / (nu[..., None, None] - d - 1.0))


def expected_pair_potential(natparam):
    """``(E_t1, E_t2, E_t3, const)`` with const = E_t4 - d/2 log(2 pi): the
    expected LDS pair potential for the E-step."""
    E_t1, E_t2, E_t3, E_t4 = expectedstats(natparam)
    d = E_t2.shape[-2]
    const = E_t4 - 0.5 * d * math.log(2 * math.pi)
    return (E_t1, E_t2, E_t3, const)
