"""LDS-SVAE prior: the stationary inference path (port of
svae_tpu/models/lds.py).

Global natural parameters are ``(niw_natparam, mniw_natparam)``: a NIW
factor on the initial state and an MNIW factor on the homogeneous
dynamics. The E-step takes the expected init and pair potentials under
q(theta), adds the recognition net's diagonal evidence and runs the packed
E-step of :mod:`svae_tpu_torch.ops.estep` (CUDA kernels on a card, plain
twins on the CPU).

Statistics are congruent with the global natparams and summed over the
batch:
  NIW : (E[x_1 x_1^T], E[x_1], 1, 1) per sequence
  MNIW: (sum_t E[x_{t+1} x_{t+1}^T], sum_t E[x_{t+1} x_t^T],
         sum_t E[x_t x_t^T], T-1) per sequence
"""

import torch

from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.ops import estep
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import f32_linalg
from svae_tpu_torch.utils.pytree import tree_dot, tree_map, tree_sub

_RAGGED = ("ragged batches (lengths=) are not ported yet: ROADMAP.md "
           "Queue 1, 'Ragged and masked LDS'")
_PARALLEL = ("the parallel-in-time smoother (parallel=True) is not ported "
             "yet: ROADMAP.md Queue 1, 'Measured questions'")


def init_pgm_param(d, generator, niw_conc=10.0, mniw_conc=10.0, A_scale=0.9,
                   Q_scale=0.1, dtype=torch.float32, device=None):
    """Random global natparams: NIW on the initial state, MNIW centered on
    the slightly contractive dynamics ``A_scale * Q`` for a random
    orthogonal Q. The random draw is made on ``generator``'s device and the
    result placed on ``device`` (default ``"cuda"``; pass ``"cpu"`` to run
    on the CPU)."""
    device = "cuda" if device is None else device
    G = torch.randn((d, d), generator=generator, dtype=dtype,
                    device=generator.device).to(device)
    Q_, _ = torch.linalg.qr(G)
    kw = dict(dtype=dtype, device=device)
    eye = torch.eye(d, **kw)
    nu0 = torch.tensor(d + niw_conc, **kw)
    niw_natparam = niw.standard_to_natural(
        nu0 * eye, torch.zeros(d, **kw), torch.tensor(niw_conc, **kw), nu0)
    nu = torch.tensor(d + mniw_conc, **kw)
    mniw_natparam = mniw.standard_to_natural(
        Q_scale * nu * eye, A_scale * Q_, (1.0 / mniw_conc) * eye, nu)
    return (niw_natparam, mniw_natparam)


def mask_potentials(nn_potentials, mask):
    """Zero the recognition evidence at masked-out frames. ``mask`` is
    (T,) or (B, T), boolean or {0,1}; a zero node potential in information
    form is exactly "this frame is unobserved"."""
    J_diag, h = nn_potentials
    m = torch.as_tensor(mask, device=h.device).to(h.dtype)[..., None]
    return (J_diag * m, h * m)


def prior_kl(global_natparam, prior_natparam):
    """KL(q(theta) || p(theta)) = NIW KL + MNIW KL."""
    total = 0.0
    for fam, q, p in ((niw, global_natparam[0], prior_natparam[0]),
                      (mniw, global_natparam[1], prior_natparam[1])):
        total = total + (tree_dot(tree_sub(q, p), fam.expectedstats(q))
                         - fam.logZ(q).sum() + fam.logZ(p).sum())
    return total


def _expected_potentials(global_natparam, dtype):
    niw_np, mniw_np = global_natparam
    (I1, I2), Ic = niw.expected_gaussian_natparam(niw_np)
    pair_mats = mniw.expected_pair_potential(mniw_np)
    return tree_map(lambda a: a.to(dtype), ((I1, I2, Ic), pair_mats))


def _prepare(nn_potentials, mask, lengths, parallel):
    """Validate the options, apply ``mask`` and add a batch axis to an
    unbatched (T, d) input. Returns ``(J_diag, h, batched)``."""
    if lengths is not None:
        raise NotImplementedError(_RAGGED)
    if parallel:
        raise NotImplementedError(_PARALLEL)
    J_diag, h = nn_potentials
    batched = J_diag.dim() == 3
    if mask is not None:
        m = torch.as_tensor(mask, device=h.device)
        J_diag, h = mask_potentials((J_diag, h),
                                    m.broadcast_to(J_diag.shape[:-1]))
    if not batched:
        J_diag, h = J_diag[None], h[None]
    return J_diag, h, batched


@f32_linalg()
def run_inference(prior_natparam, global_natparam, nn_potentials, generator,
                  num_samples=1, parallel=False, mask=None, lengths=None,
                  eps=None):
    """E-step + sampling + KLs.

    ``nn_potentials`` = (J_diag, h), each (T, d) for one sequence or
    (B, T, d) for a minibatch. Returns ``(samples, stats, global_kl,
    local_kl)`` with samples (S, T, d) or (S, B, T, d) and the stats and
    local KL summed over the batch. ``generator`` draws the sampling noise;
    ``eps`` (S, B, T, d) overrides it (tests). ``mask``: optional (T,) or
    (B, T) evidence mask; falsy frames are missing observations, bridged
    through the dynamics. ``lengths`` and ``parallel=True`` are not ported
    yet and raise. Raises ``FloatingPointError`` if a Cholesky factor
    failed (one host sync per call)."""
    J_diag, h, batched = _prepare(nn_potentials, mask, lengths, parallel)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    samples, stats, local_kl = estep.lds_estep_stationary(
        init, pair_mats, (J_diag, h), generator, num_samples, eps=eps)
    if not batched:
        samples = samples[:, 0]
    out = (samples, stats, prior_kl(global_natparam, prior_natparam),
           local_kl)
    smallchol.check_finite(out, "run_inference")
    return out


@f32_linalg()
def posterior_moments(global_natparam, nn_potentials, parallel=False,
                      mask=None, lengths=None):
    """Smoothed posterior moments ``(Ex, ExxT, Exnxt, logZ)`` for one
    sequence or a batch, with ``mask`` and the failure check as in
    :func:`run_inference`."""
    J_diag, h, batched = _prepare(nn_potentials, mask, lengths, parallel)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    logZ, Ex, ExxT, Exnxt = estep.lds_moments_stationary(
        init, pair_mats, (J_diag, h))
    smallchol.check_finite((logZ, Ex, ExxT, Exnxt), "posterior_moments")
    if not batched:
        return Ex[0], ExxT[0], Exnxt[0], logZ[0]
    return Ex, ExxT, Exnxt, logZ
