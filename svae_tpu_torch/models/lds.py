"""LDS-SVAE prior (port of svae_tpu/models/lds.py).

Global natural parameters are ``(niw_natparam, mniw_natparam)``: a NIW
factor on the initial state and an MNIW factor on the homogeneous
dynamics. The E-step takes the expected init and pair potentials under
q(theta) and adds the recognition net's diagonal evidence. A batch of
sequences of one length runs the packed stationary E-step of
:mod:`svae_tpu_torch.ops.estep`; a ragged batch (``lengths=``) gives every
sequence its own pairs, with the normalized dummy transition at its pad
frames, and runs the per-sequence E-step of :mod:`svae_tpu_torch.ops.bpairs`.
``parallel=`` picks a parallel-in-time E-step instead, with or without
``lengths=``: ``True`` the log-depth tree of :mod:`svae_tpu_torch.ops.kalman`
(torch ops), an int C the chunked scan of :mod:`svae_tpu_torch.ops.chunked`.
All run CUDA kernels on a card (the tree flavor has none, as the JAX package
runs ``lax.associative_scan`` there) and plain twins on the CPU.

Statistics are congruent with the global natparams and summed over the
batch:
  NIW : (E[x_1 x_1^T], E[x_1], 1, 1) per sequence
  MNIW: (sum_t E[x_{t+1} x_{t+1}^T], sum_t E[x_{t+1} x_t^T],
         sum_t E[x_t x_t^T], T-1) per sequence, over its real transitions
"""

import functools
import math
import operator

import torch

from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.ops import bpairs, chunked, estep, kalman
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import f32_linalg
from svae_tpu_torch.utils.pytree import tree_dot, tree_map, tree_sub

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


def pgm_expectedstats(global_natparam):
    """(NIW, MNIW) expected statistics under q(theta)."""
    niw_natparam, mniw_natparam = global_natparam
    return niw.expectedstats(niw_natparam), mniw.expectedstats(mniw_natparam)


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


def _prepare(nn_potentials, mask, lengths):
    """Validate the options, add a batch axis to an unbatched (T, d)
    input and zero the evidence that ``mask`` and ``lengths`` drop.
    Returns ``(J_diag, h, batched)``."""
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


def _chain(pair_mats, nn_potentials, lengths=None):
    """The pairs and the node potentials (N1 = -1/2 diag J_diag, h) of a
    batch: the shared pairs over its T-1 transitions or, for a ragged batch
    (``lengths``), per sequence with the dummy at its pad transitions."""
    J_diag, h = nn_potentials
    T = h.shape[1]
    pairs = tuple(p.expand((T - 1,) + p.shape) for p in pair_mats)
    if lengths is not None:
        pairs = _ragged_pairs(pairs, lengths, T, h.dtype)
    return pairs, (-0.5 * torch.diag_embed(J_diag), h)


def _check_parallel(parallel):
    """False, True or a chunk count, which may be any integral value (a
    NumPy integer too); 0 is False, as in the JAX package. Returns it as a
    bool or a Python int."""
    if isinstance(parallel, bool):
        return parallel
    try:
        chunks = operator.index(parallel)
    except TypeError:
        chunks = -1
    if chunks < 0:
        raise ValueError(f"parallel must be False, True or a chunk count "
                         f"(0 for False), got {parallel!r}")
    return chunks


def _route(parallel):
    """The ``(estep, smoother)`` pair of chain potentials (init, pairs,
    nodes) that ``parallel`` names: the estep returns ``(samples, (Ex,
    ExxT, Exnxt), logZ)``, the smoother ``(logZ, Ex, ExxT, Exnxt)``."""
    if parallel is True:
        return (functools.partial(kalman.lds_inference, parallel=True),
                functools.partial(kalman.lds_smoother, parallel=True))
    if parallel:
        return (functools.partial(chunked.lds_estep, chunks=parallel),
                functools.partial(chunked.lds_smoother, chunks=parallel))
    return bpairs.lds_estep, bpairs.lds_smoother


def _batched_inference(estep_fn, init, pairs, nodes, generator, num_samples,
                       valid, eps=None):
    """Minibatch E-step on streamed pairs through ``estep_fn`` (port of
    lds._batched_inference_pallas and of the vmapped _sequence_inference):
    the E-steps are mask-free, and the statistics weigh transition
    t -> t+1 by ``valid`` (B, T) at frame t+1, so pad frames add nothing to
    the MNIW statistics or counts; their zero evidence and dummy
    transitions make the local KL exact."""
    N1, h = nodes
    samples, (Ex, ExxT, Exnxt), logZ = estep_fn(
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
    sequences. Both compose. ``parallel``: ``False`` (or 0) runs the
    sequential kernels (the packed stationary E-step, or the per-sequence
    one with ``lengths``), ``True`` the log-depth tree of
    :mod:`~svae_tpu_torch.ops.kalman`, an int C the chunked scan of
    :mod:`~svae_tpu_torch.ops.chunked` with C chunks. Raises
    ``FloatingPointError`` if a Cholesky factor failed (one host sync per
    call)."""
    parallel = _check_parallel(parallel)
    J_diag, h, batched = _prepare(nn_potentials, mask, lengths)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    if lengths is None and not parallel:
        samples, stats, local_kl = estep.lds_estep_stationary(
            init, pair_mats, (J_diag, h), generator, num_samples, eps=eps)
    else:
        pairs, nodes = _chain(pair_mats, (J_diag, h), lengths)
        B, T = h.shape[:2]
        valid = (h.new_ones(B, T) if lengths is None else
                 _length_mask(lengths, B, T, h.dtype, h.device))
        samples, stats, local_kl = _batched_inference(
            _route(parallel)[0], init, pairs, nodes, generator, num_samples,
            valid, eps=eps)
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
    sequence or a batch, with ``parallel``, ``mask``, ``lengths`` and the
    failure check as in :func:`run_inference`. With ``lengths`` the
    moments cover the pad frames too (the dummy chain there), as the JAX
    package's do."""
    parallel = _check_parallel(parallel)
    J_diag, h, batched = _prepare(nn_potentials, mask, lengths)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    if lengths is None and not parallel:
        logZ, Ex, ExxT, Exnxt = estep.lds_moments_stationary(
            init, pair_mats, (J_diag, h))
    else:
        pairs, nodes = _chain(pair_mats, (J_diag, h), lengths)
        logZ, Ex, ExxT, Exnxt = _route(parallel)[1](init, pairs, nodes)
    smallchol.check_finite((logZ, Ex, ExxT, Exnxt), "posterior_moments")
    if not batched:
        return Ex[0], ExxT[0], Exnxt[0], logZ[0]
    return Ex, ExxT, Exnxt, logZ


@f32_linalg()
def predict(global_natparam, nn_potentials, generator, num_steps,
            num_samples=1, parallel=False, mask=None, eps=None,
            step_eps=None):
    """Forecast: condition on an observed window through the recognition
    potentials, then roll the posterior-mean dynamics (E[A], E[Sigma]) of
    the MNIW factor forward ``num_steps`` with process noise.

    ``nn_potentials`` = (J_diag, h), (T, d) or (B, T, d). Returns latent
    trajectories (S, T + num_steps, d) or, batched, (B, S, T + num_steps,
    d), as the JAX package's ``vmap`` lays them out: the first T frames are
    posterior samples of the window, drawn on the route that
    :func:`run_inference` takes for the same ``parallel`` (the stationary
    filter and sampler kernels for ``False``), the rest the rollout.
    ``mask`` marks missing frames of the window, as in
    :func:`run_inference`. ``generator`` draws the noise unless it is
    given: ``eps`` (S, B, T, d) for the window (the JAX package's
    ``normal(k1, (S, T, d))`` per sequence) and ``step_eps``
    (num_steps, S, B, d) for the rollout (its ``normal(k2, (num_steps, S,
    d))``), B = 1 for one sequence."""
    parallel = _check_parallel(parallel)
    J_diag, h, batched = _prepare(nn_potentials, mask, None)
    init, pair_mats = _expected_potentials(global_natparam, h.dtype)
    if parallel:
        pairs, nodes = _chain(pair_mats, (J_diag, h))
        xs = _route(parallel)[0](init, pairs, nodes, generator, num_samples,
                                 eps=eps)[0]
    else:
        xs = estep.lds_sample_stationary(init, pair_mats, (J_diag, h),
                                         generator, num_samples, eps=eps)
    S, B, _, d = xs.shape
    A, Sigma = tree_map(lambda a: a.to(h.dtype),
                        mniw.posterior_mean_params(global_natparam[1]))
    Ls = smallchol.chol(Sigma)
    if step_eps is None:
        step_eps = torch.randn((num_steps, S, B, d), generator=generator,
                               dtype=h.dtype, device=h.device)
    frames, x = [xs], xs[:, :, -1]
    for e in step_eps:
        x = (A @ x[..., None])[..., 0] + (Ls @ e[..., None])[..., 0]
        frames.append(x[:, :, None])
    traj = torch.cat(frames, 2).transpose(0, 1)
    return traj if batched else traj[0]
