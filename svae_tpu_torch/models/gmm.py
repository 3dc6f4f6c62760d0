"""GMM-SVAE prior: a Gaussian mixture composed with a neural decoder (port
of svae_tpu/models/gmm.py).

Global natural parameters are ``(dirichlet_natparam (K,), niw_natparam)``
with every leaf of the NIW tuple batched over a leading K axis. The E-step
is block mean-field q(z) q(x) over the whole minibatch: a fixed number of
coordinate-ascent sweeps, each a few batched einsums, a 2x2 (d x d)
Cholesky per point and a softmax. There is no kernel here: the JAX package
runs no Pallas kernel on this path either.

Gradient flow, as in the JAX package: the first ``num_iters -
num_diff_iters`` sweeps run without a graph on detached globals and
potentials (the fixed point is not differentiated), the last
``num_diff_iters`` sweeps and one final pass carry it, so the gradient is
the truncated backprop through the fixed point. The statistics go to the
natural gradient detached (train/elbo.py).
"""

import torch

from svae_tpu_torch.expfam import dirichlet, gaussian, niw
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import f32_linalg
from svae_tpu_torch.utils.pytree import tree_dot, tree_map, tree_sub


def init_pgm_param(K, d, generator, alpha=1.0, niw_conc=10.0,
                   random_scale=1.0, dtype=torch.float32, device=None):
    """Random global natparams: a symmetric Dirichlet(``alpha``) on the
    weights and K NIW factors whose means are scattered by
    ``random_scale`` (which breaks the symmetry between the components).
    The draw is made on ``generator``'s device and the result placed on
    ``device`` (default ``"cuda"``; pass ``"cpu"`` to run on the CPU)."""
    device = "cuda" if device is None else device
    kw = dict(dtype=dtype, device=device)
    dir_natparam = dirichlet.standard_to_natural(alpha * torch.ones(K, **kw))
    m = random_scale * torch.randn((K, d), generator=generator, dtype=dtype,
                                   device=generator.device).to(device)
    kappa = niw_conc * torch.ones(K, **kw)
    nu = (d + niw_conc) * torch.ones(K, **kw)
    Phi = (nu[0] * torch.eye(d, **kw)).expand(K, d, d)
    return (dir_natparam, niw.standard_to_natural(Phi, m, kappa, nu))


def pgm_expectedstats(global_natparam):
    """(E[log pi], the NIW expected statistics) under q(theta)."""
    dir_natparam, niw_natparam = global_natparam
    return (dirichlet.expectedstats(dir_natparam),
            niw.expectedstats(niw_natparam))


# --------------------------------------------------------------------------
# mean-field E-step
# --------------------------------------------------------------------------


def _gaussian_meanfield(gauss_globals, node_natparam, label_probs):
    """q(x_n)'s natparam: sum_k r_nk E[eta_k] + psi_n."""
    (E_eta1, E_eta2), _ = gauss_globals                  # (K,d,d), (K,d)
    eta1_node, eta2_node = node_natparam                 # (B,d,d), (B,d)
    return (torch.einsum("bk,kij->bij", label_probs, E_eta1) + eta1_node,
            torch.einsum("bk,ki->bi", label_probs, E_eta2) + eta2_node)


def _label_logits(e_logpi, gauss_globals, gauss_stats):
    """logit_nk = E[log pi_k] + <E[eta_k], s_n> + const_k."""
    (E_eta1, E_eta2), const = gauss_globals
    ExxT, Ex = gauss_stats
    return (e_logpi + torch.einsum("kij,bij->bk", E_eta1, ExxT)
            + torch.einsum("ki,bi->bk", E_eta2, Ex) + const)


def _sweep(gauss_globals, node_natparam, e_logpi, label_probs):
    q_x = _gaussian_meanfield(gauss_globals, node_natparam, label_probs)
    logits = _label_logits(e_logpi, gauss_globals,
                           gaussian.expectedstats(q_x))
    return torch.softmax(logits, dim=-1)


@f32_linalg()
def local_meanfield(global_natparam, nn_potentials, num_iters=25,
                    num_diff_iters=2):
    """Block coordinate ascent on q(z) q(x) for a minibatch.

    ``nn_potentials`` = (J_diag, h), the recognizer's diagonal evidence,
    each (B, d). From uniform labels, ``num_iters`` sweeps run, the first
    ``num_iters - num_diff_iters`` without a graph; then one pass gives
    q(x), its statistics and the refreshed labels. Returns
    ``(label_probs (B, K), gauss_natparam, gauss_stats, local_kl)``."""
    dir_natparam, niw_natparam = global_natparam
    e_logpi = dirichlet.expectedstats(dir_natparam)               # (K,)
    gauss_globals = niw.expected_gaussian_natparam(niw_natparam)
    J_diag, h = nn_potentials
    node_natparam = gaussian.pack_dense(J_diag, h)
    B, K = h.shape[0], e_logpi.shape[0]

    num_diff = min(num_diff_iters, num_iters)
    r = torch.full((B, K), 1.0 / K, dtype=h.dtype, device=h.device)
    warm = num_iters - num_diff
    if warm > 0:
        frozen = tree_map(torch.Tensor.detach,
                          (gauss_globals, node_natparam, e_logpi))
        with torch.no_grad():
            for _ in range(warm):
                r = _sweep(*frozen, r)
    for _ in range(num_diff):
        r = _sweep(gauss_globals, node_natparam, e_logpi, r)

    # one differentiable pass around the fixed point
    gauss_natparam = _gaussian_meanfield(gauss_globals, node_natparam, r)
    gauss_stats = gaussian.expectedstats(gauss_natparam)
    logits = _label_logits(e_logpi, gauss_globals, gauss_stats)
    label_probs = torch.softmax(logits, dim=-1)

    # local KL: sum_n <psi_n, s_n> - logZ(q(x_n)) - logsumexp(logit_n)
    #           + sum_k r_nk <E[eta_k], s_n>
    (E_eta1, E_eta2), _ = gauss_globals
    ExxT, Ex = gauss_stats
    psi_term = ((node_natparam[0] * ExxT).sum((-2, -1))
                + (node_natparam[1] * Ex).sum(-1))
    pair_term = (label_probs * (torch.einsum("kij,bij->bk", E_eta1, ExxT)
                                + torch.einsum("ki,bi->bk", E_eta2, Ex))
                 ).sum(-1)
    local_kl = (psi_term - gaussian.logZ(gauss_natparam)
                - torch.logsumexp(logits, dim=-1) + pair_term).sum()
    return label_probs, gauss_natparam, gauss_stats, local_kl


# --------------------------------------------------------------------------
# statistics and KLs
# --------------------------------------------------------------------------


def _global_stats(label_probs, gauss_stats):
    """Statistics congruent with (Dirichlet natparam, NIW natparam), so the
    conjugate update is a tree addition."""
    ExxT, Ex = gauss_stats
    counts = label_probs.sum(0)                                   # (K,)
    return (counts, (torch.einsum("bk,bij->kij", label_probs, ExxT),
                     torch.einsum("bk,bi->ki", label_probs, Ex),
                     counts, counts))


def prior_kl(global_natparam, prior_natparam):
    """KL(q(theta) || p(theta)) for the conjugate globals."""
    dir_q, niw_q = global_natparam
    dir_p, niw_p = prior_natparam
    dir_kl = (((dir_q - dir_p) * dirichlet.expectedstats(dir_q)).sum()
              - dirichlet.logZ(dir_q) + dirichlet.logZ(dir_p))
    niw_kl = (tree_dot(tree_sub(niw_q, niw_p), niw.expectedstats(niw_q))
              - niw.logZ(niw_q).sum() + niw.logZ(niw_p).sum())
    return dir_kl + niw_kl


# --------------------------------------------------------------------------
# the model contract
# --------------------------------------------------------------------------


@f32_linalg()
def run_inference(prior_natparam, global_natparam, nn_potentials, generator,
                  num_samples=1, num_meanfield_iters=25, eps=None):
    """E-step + sampling + KLs.

    ``nn_potentials`` = (J_diag, h), each (B, d). Returns ``(samples
    (S, B, d), stats, global_kl, local_kl)`` with the statistics congruent
    with the globals and summed over the batch. ``generator`` draws the
    sampling noise; ``eps`` (S, B, d) overrides it (tests). Raises
    ``FloatingPointError`` if a Cholesky factor failed (one host sync per
    call)."""
    label_probs, gauss_natparam, gauss_stats, local_kl = local_meanfield(
        global_natparam, nn_potentials, num_iters=num_meanfield_iters)
    samples = gaussian.natural_sample(gauss_natparam, generator, num_samples,
                                      eps=eps)
    out = (samples, _global_stats(label_probs, gauss_stats),
           prior_kl(global_natparam, prior_natparam), local_kl)
    smallchol.check_finite(out, "run_inference")
    return out


@f32_linalg()
def classify(global_natparam, nn_potentials, num_meanfield_iters=25):
    """The responsibilities q(z) (B, K) of (new) data under trained
    globals: the label field of the mean-field E-step."""
    return local_meanfield(global_natparam, nn_potentials,
                           num_iters=num_meanfield_iters)[0]
