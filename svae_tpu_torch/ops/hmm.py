"""Discrete-chain inference on plain torch ops (port of
svae_tpu/ops/hmm.py): the log-partition and its marginals, the
forward-backward posterior, the Viterbi decode and posterior path
sampling, each sequential or parallel in time.

The chain elements are M_t(i, j) = log_trans_t(i, j) + log_obs_{t+1}(j),
t = 0..T-2, as in :mod:`svae_tpu_torch.ops.hmm_fb`. ``parallel`` picks
the flavor: falsy runs the messages as a loop over T (the forward-backward
posterior on the kernels of :mod:`~svae_tpu_torch.ops.hmm_fb`), truthy
(``True`` or a chunk count, as in the JAX package) as a log-depth tree of
:func:`_logmatmul` (the temporal parallelization of Sarkka et al.,
arXiv:2102.05743) on :func:`svae_tpu_torch.ops.kalman._tree_scan`, or of
its max-plus twin for Viterbi. There is no kernel for the scans (the JAX
package runs ``lax.associative_scan`` there).

The differentiation contract is the JAX package's: ``grad(logZ)`` gives
the expected statistics, which :func:`hmm_marginals` packages.
"""

import math

import torch

from svae_tpu_torch.ops import hmm_fb
from svae_tpu_torch.ops.kalman import _flip, _tree_scan


# --------------------------------------------------------------------------
# the log-space matrix product and the chain elements
# --------------------------------------------------------------------------


def _logmatmul_parts(A, B):
    """exp(A - rowmax), exp(B - colmax) and their product clamped at
    sqrt(tiny), with the shifts: the non-finite maxima of an all -inf row
    or column are replaced by 0."""
    Ma = A.amax(-1, keepdim=True)
    Mb = B.amax(-2, keepdim=True)
    Ma = torch.where(torch.isfinite(Ma), Ma, torch.zeros_like(Ma))
    Mb = torch.where(torch.isfinite(Mb), Mb, torch.zeros_like(Mb))
    Ea, Eb = torch.exp(A - Ma), torch.exp(B - Mb)
    prodc = (Ea @ Eb).clamp_min(math.sqrt(torch.finfo(A.dtype).tiny))
    return Ea, Eb, prodc, Ma, Mb


class _LogMatmul(torch.autograd.Function):
    """C(i, k) = logsumexp_j A(i, j) + B(j, k), batched over leading axes,
    as a product of shifted exponentials.

    Its backward is the bounded softmax-weight form of the JAX package's
    custom VJP: dC/dA(i, j) = sum_k ct(i, k) W(i, j, k) with W(i, j, k) =
    exp(A(i, j) + B(j, k) - C(i, k)) in [0, 1], as two products whose
    intermediates are bounded by |ct| / sqrt(tiny). The backward that
    automatic differentiation derives from log(exp @ exp) forms 1/prod,
    which overflows to NaN once the messages sharpen. The backward
    recomputes its exponentials from A and B, so that it is itself
    differentiable (a second derivative through ``hmm_marginals``)."""

    @staticmethod
    def forward(ctx, A, B):
        Ea, Eb, prodc, Ma, Mb = _logmatmul_parts(A, B)
        ctx.save_for_backward(A, B)
        return torch.log(prodc) + Ma + Mb

    @staticmethod
    def backward(ctx, ct):
        A, B = ctx.saved_tensors
        Ea, Eb, prodc, _, _ = _logmatmul_parts(A, B)
        S = ct / prodc
        gA = Ea * (S @ Eb.mT)
        gB = Eb * (Ea.mT @ S)
        return gA.sum_to_size(A.shape), gB.sum_to_size(B.shape)


def _logmatmul(A, B):
    """Stable log-space matrix product with the bounded backward
    (:class:`_LogMatmul`)."""
    return _LogMatmul.apply(A, B)


def _elements(log_trans, log_obs):
    """The chain elements M_t (..., T-1, K, K). ``log_trans`` is (K, K),
    (..., K, K) with as many axes as ``log_obs`` (homogeneous per
    sequence) or (..., T-1, K, K) (time-varying); it broadcasts against
    ``log_obs`` (..., T, K)."""
    if log_trans.dim() == log_obs.dim():
        log_trans = log_trans[..., None, :, :]
    return log_trans + log_obs[..., 1:, None, :]


def _scan_elements(M, op2, reverse=False):
    """Inclusive prefix (or, ``reverse``, suffix) scan of ``op2(earlier,
    later)`` over the time axis of the elements M (..., T-1, K, K), as a
    log-depth tree; returns the scans in M's layout."""
    tm = (M.movedim(-3, 0),)
    if reverse:
        out = _flip(_tree_scan(_flip(tm), lambda a, b: op2(b, a)))
    else:
        out = _tree_scan(tm, op2)
    return out[0].movedim(0, -3)


def _logmatmul2(a, b):
    return (_logmatmul(a[0], b[0]),)


def _maxplus2(a, b):
    return ((a[0][..., :, :, None] + b[0][..., None, :, :]).amax(-2),)


# --------------------------------------------------------------------------
# log-partition and marginals
# --------------------------------------------------------------------------


def hmm_logZ(log_init, log_trans, log_obs, parallel=False):
    """Log-partition of each chain, over the leading axes of ``log_obs``
    (..., T, K) (``log_init`` (K,) and ``log_trans`` broadcast, as
    :func:`_elements` takes it). Differentiable: its gradients are the
    expected statistics (:func:`hmm_marginals`)."""
    a0 = log_init + log_obs[..., 0, :]
    M = _elements(log_trans, log_obs)
    if parallel:
        total = _scan_elements(M, _logmatmul2)[..., -1, :, :]
        aT = torch.logsumexp(a0[..., :, None] + total, -2)
    else:
        aT = a0
        for t in range(M.shape[-3]):
            aT = torch.logsumexp(aT[..., :, None] + M[..., t, :, :], -2)
    return torch.logsumexp(aT, -1)


def hmm_marginals(log_init, log_trans, log_obs, parallel=False):
    """``(logZ, node_marginals, pair_marginals, init_marginal)`` from one
    backward pass of the summed log-partition (logZ is that sum), the
    JAX package's ``expectedstats = grad(logZ)``. The pair marginals are
    (..., T-1, K, K) for time-varying ``log_trans``, else the transition
    counts summed over time and the batch (K, K), the Dirichlet
    statistic. Differentiable where the inputs carry a graph."""
    keep = any(x.requires_grad for x in (log_init, log_trans, log_obs))
    with torch.enable_grad():
        ins = [x if x.requires_grad else x.detach().requires_grad_()
               for x in (log_init, log_trans, log_obs)]
        logZ = hmm_logZ(*ins, parallel=parallel).sum()
        g_init, g_trans, g_obs = torch.autograd.grad(logZ, ins,
                                                     create_graph=keep)
    if not keep:
        logZ = logZ.detach()
    return logZ, g_obs, g_trans, g_init


def hmm_posterior(log_init, log_trans, log_obs, parallel=False,
                  pair_weights=None):
    """Forward-backward posterior of B chains: ``(logZ (B,), node
    (B, T, K), pair_sum (B, K, K), init_marginal (B, K))``, with the
    arguments of :func:`svae_tpu_torch.ops.hmm_fb.hmm_posterior`.
    ``parallel`` falsy runs that function (the HMM kernels on a card);
    truthy forms alpha from the prefix scan of :func:`_logmatmul` and beta
    from its suffix scan, each a log-depth tree, then the same materialized
    marginals exp(alpha + M + beta - logZ). Differentiable."""
    if not parallel:
        return hmm_fb.hmm_posterior(log_init, log_trans, log_obs,
                                    pair_weights=pair_weights)
    B, T, K = log_obs.shape
    if T < 2:
        raise ValueError("hmm_posterior: needs T >= 2 (a chain of at least "
                         "one transition)")
    dt = log_obs.dtype
    a0 = log_init.to(dt) + log_obs[:, 0]
    M = log_trans.to(dt) + log_obs[:, 1:, None, :]       # (B, T-1, K, K)
    prefix = _scan_elements(M, _logmatmul2)
    alpha = torch.cat([a0[:, None], torch.logsumexp(
        a0[:, None, :, None] + prefix, -2)], 1)
    suffix = _scan_elements(M, _logmatmul2, reverse=True)
    beta = torch.cat([torch.logsumexp(suffix, -1), a0.new_zeros(B, 1, K)],
                     1)
    return hmm_fb.marginals(alpha, beta, M, pair_weights)


# --------------------------------------------------------------------------
# MAP path and path samples
# --------------------------------------------------------------------------


def hmm_viterbi(log_init, log_trans, log_obs, parallel=False):
    """MAP state paths of B chains by max-plus message passing: ``(path
    int32 (B, T), score (B,))`` with ``score = max_z log p(z, y)`` up to
    the observation normalizer.

    ``log_init`` (K,); ``log_trans`` (K, K), shared, or (B, T-1, K, K);
    ``log_obs`` (B, T, K). The forward messages delta_t run as a loop
    (``parallel`` falsy) or as a log-depth tree of the max-plus product
    (truthy). The traceback needs no stored backpointers: with every
    forward message kept, z_t = argmax_i delta_t(i) + M_t(i, z_{t+1})
    re-derives them. Ties go to the lowest state, as in the JAX
    package."""
    B, T, K = log_obs.shape
    M = log_trans + log_obs[:, 1:, None, :]              # (B, T-1, K, K)
    d0 = log_init + log_obs[:, 0]
    if parallel:
        prefix = _scan_elements(M, _maxplus2)
        delta = torch.cat([d0[:, None], (d0[:, None, :, None]
                                         + prefix).amax(-2)], 1).unbind(1)
    else:
        delta = [d0]
        for t in range(T - 1):
            delta.append((delta[-1][:, :, None] + M[:, t]).amax(1))
    z = delta[-1].argmax(-1)
    score = delta[-1].gather(1, z[:, None])[:, 0]
    path = [z]
    rows = torch.arange(B, device=log_obs.device)
    for t in reversed(range(T - 1)):
        z = (delta[t] + M[rows, t, :, z]).argmax(-1)
        path.append(z)
    return torch.stack(path[::-1], 1).to(torch.int32), score


def gumbel(shape, generator, dtype, device):
    """Standard Gumbel noise ``-log(-log U)`` drawn by ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def hmm_sample(log_init, log_trans, log_obs, generator, num_samples=(),
               parallel=False, gumbel_noise=None):
    """Posterior path samples of B chains: backward log-messages, then
    forward sampling by Gumbel argmax (discrete; no reparameterization).
    Returns int32 paths ``(B,) + num_samples + (T,)`` (``num_samples`` an
    int or a shape tuple S).

    ``log_init`` (K,); ``log_trans`` (K, K), shared, or (B, T-1, K, K);
    ``log_obs`` (B, T, K). The backward messages run as a loop
    (``parallel`` falsy) or from the suffix scan of :func:`_logmatmul`
    (truthy). ``generator`` draws the Gumbel noise unless ``gumbel_noise``
    = (g0, gs) gives it in the JAX package's layout per sequence, a batch
    axis in front: g0 (B,) + S + (K,) for the first frame and gs
    (B, T-1) + S + (K,) for the rest."""
    if isinstance(num_samples, int):
        num_samples = (num_samples,)
    S = tuple(num_samples)
    B, T, K = log_obs.shape
    P = math.prod(S)
    M = log_trans + log_obs[:, 1:, None, :]              # (B, T-1, K, K)
    # beta[t](i): the log-mass of the futures given z_t = i
    if parallel:
        beta = torch.cat([torch.logsumexp(_scan_elements(
            M, _logmatmul2, reverse=True), -1), log_obs.new_zeros(B, 1, K)],
            1).unbind(1)
    else:
        beta = [log_obs.new_zeros(B, K)]
        for t in reversed(range(T - 1)):
            beta.append(torch.logsumexp(M[:, t] + beta[-1][:, None, :], -1))
        beta = beta[::-1]
    if gumbel_noise is None:
        kw = dict(dtype=log_obs.dtype, device=log_obs.device)
        gumbel_noise = (gumbel((B,) + S + (K,), generator, **kw),
                        gumbel((B, T - 1) + S + (K,), generator, **kw))
    g0, gs = gumbel_noise
    gs = gs.reshape(B, T - 1, P, K)
    a0 = log_init + log_obs[:, 0] + beta[0]                # (B, K)
    z = (a0[:, None] + g0.reshape(B, P, K)).argmax(-1)     # (B, P)
    path = [z]
    for t in range(T - 1):
        rows = M[:, t].gather(1, z[..., None].expand(B, P, K))
        z = (rows + beta[t + 1][:, None] + gs[:, t]).argmax(-1)
        path.append(z)
    return torch.stack(path, -1).reshape((B,) + S + (T,)).to(torch.int32)
