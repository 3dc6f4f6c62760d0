"""LDS-SVAE prior (port of svae_tpu/models/lds.py).

Global natural parameters are ``(niw_natparam, mniw_natparam)``: a NIW
factor on the initial state and an MNIW factor on the homogeneous
dynamics. The E-step takes the expected init and pair potentials under
q(theta) and adds the recognition net's diagonal evidence. A batch of
sequences of one length runs the packed stationary E-step of
:mod:`svae_tpu_torch.ops.estep`; a ragged batch (``lengths=``) gives every
sequence its own pairs, with the normalized dummy transition at its pad
frames, and runs the per-sequence E-step of :mod:`svae_tpu_torch.ops.bpairs`.
Both run CUDA kernels on a card and plain twins on the CPU.

Statistics are congruent with the global natparams and summed over the
batch:
  NIW : (E[x_1 x_1^T], E[x_1], 1, 1) per sequence
  MNIW: (sum_t E[x_{t+1} x_{t+1}^T], sum_t E[x_{t+1} x_t^T],
         sum_t E[x_t x_t^T], T-1) per sequence, over its real transitions
"""

import math

import torch

from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.ops import bpairs, estep
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import f32_linalg
from svae_tpu_torch.utils.pytree import tree_dot, tree_map, tree_sub

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


def _length_mask(lengths, B, T, dtype, device):
    """(B,) per-sequence lengths -> (B, T) {0,1} validity mask."""
    lengths = torch.as_tensor(lengths, device=device)
    return (torch.arange(T, device=device)[None, :]
            < lengths[:, None]).to(dtype)


def _evidence_mask(mask, lengths, B, T, dtype, device):
    """An explicit evidence mask times the trailing-pad length mask, as a
    (B, T) {0,1} tensor, or None when neither is given."""
    out = None
    if mask is not None:
        out = torch.as_tensor(mask, device=device).to(dtype).broadcast_to(
            (B, T))
    if lengths is not None:
        v = _length_mask(lengths, B, T, dtype, device)
        out = v if out is None else out * v
    return out


def _pair_weight(lengths, T, dtype, device):
    """(B,) lengths -> (B, T-1) transition weights: transition t couples
    frames (t, t+1) and is real iff frame t+1 exists."""
    return (torch.arange(1, T, device=device)[None, :]
            < torch.as_tensor(lengths, device=device)[:, None]).to(dtype)


def dummy_blend_pairs(pairs, w):
    """Blend pair potentials ``(P1, P2, P3, Pc)`` with the normalized
    dummy transition x_{t+1} ~ N(0, I) wherever the transition weight ``w``
    is 0 (leading axes of the pairs broadcast against ``w``'s).

    Zero evidence alone would not do: the pair potentials are
    E_q[log p(x'|x, theta)], not a normalized conditional, so integrating
    a pad frame out would leak an x_t-dependent Jensen-gap term back into
    the real frames. Each dummy transition integrates to 1 and couples
    nothing, so logZ, the local KL and the real frames' marginals equal
    those of the unpadded chain."""
    P1, P2, P3, Pc = pairs
    d = P1.shape[-1]
    w = w.to(P1.dtype)
    wm = w[..., None, None]
    eye = torch.eye(d, dtype=P1.dtype, device=P1.device)
    return (wm * P1 + (1.0 - wm) * (-0.5) * eye, wm * P2, wm * P3,
            w * Pc + (1.0 - w) * (-0.5 * d * math.log(2.0 * math.pi)))


def _ragged_pairs(pairs, lengths, T, dtype):
    """Per-sequence (B, T-1, ...) pairs for a ragged batch: the shared
    (T-1, ...) pairs with the normalized dummy at pad transitions."""
    w = _pair_weight(lengths, T, dtype, pairs[0].device)
    return dummy_blend_pairs(tuple(p[None] for p in pairs), w)


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
    """Validate the options, add a batch axis to an unbatched (T, d)
    input and zero the evidence that ``mask`` and ``lengths`` drop.
    Returns ``(J_diag, h, batched)``."""
    if parallel:
        raise NotImplementedError(_PARALLEL)
    J_diag, h = nn_potentials
    batched = J_diag.dim() == 3
    if lengths is not None and not batched:
        raise ValueError("lengths= requires batched (B, T, d) potentials")
    if not batched:
        J_diag, h = J_diag[None], h[None]
    B, T = h.shape[:2]
    ev_mask = _evidence_mask(mask, lengths, B, T, h.dtype, h.device)
    if ev_mask is not None:
        J_diag, h = mask_potentials((J_diag, h), ev_mask)
    return J_diag, h, batched


def _ragged_chain(pair_mats, nn_potentials, lengths):
    """The per-sequence pairs and the node potentials (N1 = -1/2 diag
    J_diag, h) of a ragged batch."""
    J_diag, h = nn_potentials
    T = h.shape[1]
    pairs = tuple(p.expand((T - 1,) + p.shape) for p in pair_mats)
    return (_ragged_pairs(pairs, lengths, T, h.dtype),
            (-0.5 * torch.diag_embed(J_diag), h))


def _batched_inference_bpairs(init, pairs, nodes, generator, num_samples,
                              valid, eps=None):
    """Minibatch E-step on per-sequence pairs (port of
    lds._batched_inference_pallas): the kernels are mask-free, and the
    statistics weigh transition t -> t+1 by ``valid`` (B, T) at frame t+1,
    so pad frames add nothing to the MNIW statistics or counts; their zero
    evidence and dummy transitions make the local KL exact."""
    N1, h = nodes
    samples, (Ex, ExxT, Exnxt), logZ = bpairs.lds_estep(
        init, pairs, nodes, generator, num_samples, eps=eps)
    local_kl = (N1 * ExxT).sum() + (h * Ex).sum() - logZ.sum()
    cnt = torch.tensor(float(Ex.shape[0]), dtype=Ex.dtype, device=Ex.device)
    niw_stats = (ExxT[:, 0].sum(0), Ex[:, 0].sum(0), cnt, cnt)
    w = valid[:, 1:, None, None]
    mniw_stats = ((w * ExxT[:, 1:]).sum((0, 1)),
                  (w * Exnxt.mT).sum((0, 1)),        # E[x_{t+1} x_t^T]
                  (w * ExxT[:, :-1]).sum((0, 1)),
                  valid.sum() - cnt)
    return samples, (niw_stats, mniw_stats), local_kl


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
    through the dynamics. ``lengths``: optional (B,) lengths of a batch
    padded to a common T (batched input only): pad frames carry no
    evidence and no statistics, so the result equals that of the unpadded
    sequences. Both compose. ``parallel=True`` is not ported yet and
    raises. Raises ``FloatingPointError`` if a Cholesky factor failed (one
    host sync per call)."""
    J_diag, h, batched = _prepare(nn_potentials, mask, lengths, parallel)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    if lengths is None:
        samples, stats, local_kl = estep.lds_estep_stationary(
            init, pair_mats, (J_diag, h), generator, num_samples, eps=eps)
    else:
        pairs, nodes = _ragged_chain(pair_mats, (J_diag, h), lengths)
        valid = _length_mask(lengths, *h.shape[:2], h.dtype, h.device)
        samples, stats, local_kl = _batched_inference_bpairs(
            init, pairs, nodes, generator, num_samples, valid, eps=eps)
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
    sequence or a batch, with ``mask``, ``lengths`` and the failure check
    as in :func:`run_inference`. With ``lengths`` the moments cover the
    pad frames too (the dummy chain there), as the JAX package's do."""
    J_diag, h, batched = _prepare(nn_potentials, mask, lengths, parallel)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    if lengths is None:
        logZ, Ex, ExxT, Exnxt = estep.lds_moments_stationary(
            init, pair_mats, (J_diag, h))
    else:
        pairs, nodes = _ragged_chain(pair_mats, (J_diag, h), lengths)
        logZ, Ex, ExxT, Exnxt = bpairs.lds_smoother(init, pairs, nodes)
    smallchol.check_finite((logZ, Ex, ExxT, Exnxt), "posterior_moments")
    if not batched:
        return Ex[0], ExxT[0], Exnxt[0], logZ[0]
    return Ex, ExxT, Exnxt, logZ
