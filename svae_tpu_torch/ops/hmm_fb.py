"""Batched HMM forward-backward in log space (port of
svae_tpu/ops/pallas_hmm.py), the z-step of the SLDS structured mean-field.

Per sequence, with chain elements M_t(i, j) = log_trans_t(i, j) +
log_obs_{t+1}(j), t = 0..T-2, two independent recursions run:

  alpha_{t+1}(j) = logsumexp_i  alpha_t(i) + M_t(i, j)      (ascending)
  beta_t(i)      = logsumexp_j  M_t(i, j) + beta_{t+1}(j)   (descending)

from alpha_0 = log_init + log_obs_0 and beta_{T-1} = 0.

* :func:`hmm_fb_fwd` streams the K*K chain elements per step and lane;
* :func:`hmm_fb_stat_fwd` takes one stationary (K, K) transition matrix
  and streams only the K observations per step and lane;
* :func:`hmm_fb_adj` and :func:`hmm_fb_stat_adj` are their adjoints, the
  backward of :class:`HmmFb` and :class:`HmmFbStat`, in the bounded
  softmax-weight form: w_ij = exp(alpha_t(i) + M_t(i,j) - alpha_{t+1}(j))
  and v_ij = exp(M_t(i,j) + beta_{t+1}(j) - beta_t(i)) lie in [0, 1], so
  no intermediate can overflow (the form derived by automatic
  differentiation of log-of-sums gives NaN once messages sharpen).
  :func:`hmm_fb_adj` runs as three passes: the weights, which do not
  depend on the carried cotangent (:func:`hmm_fb_adj_weights`), the two
  serial chains of cotangents, products only (:func:`hmm_fb_adj_chain`),
  and dM from both (:func:`hmm_fb_adj_dM`). :func:`hmm_fb_stat_adj` runs
  the stationary weights (:func:`hmm_fb_stat_adj_weights`), the same
  chains, and the sums of dlo and dLT (:func:`hmm_fb_stat_adj_sums`).

Each of the four, and each pass, is a CUDA kernel (``csrc/hmm_fb.cu``,
``csrc/hmm_fb_adj.cu``) for tensors on a card and a plain PyTorch version
(``*_plain``) for tensors on the CPU, with the launch counters and the
no-fallback rule of :mod:`~svae_tpu_torch.ops.estep`: the forward twins
step batched ``torch.logsumexp`` over the lanes, the plain adjoints are
``torch.autograd``'s vector-Jacobian products of the twins, and each pass
has a plain version of its own. Streams keep the JAX package's packed
layout with the lane innermost ((T-1, K*K, B) and (T-1, K, B)), without
its 128-lane padding. :func:`hmm_posterior` assembles the marginals
around them with batched torch ops.
"""

import math

import torch

from svae_tpu_torch.ops import _build
from svae_tpu_torch.ops.estep import (_check_kernel_args, _forward, _launch,
                                      _vjp)

# The K with an instance of their own, a chain on segment_lanes(K) <= 32
# lanes of a warp; every K past them runs the runtime-K kernels, a chain a
# block (csrc/hmm_fb.cu, csrc/hmm_fb_adj.cu), so every K >= 1 is served.
KERNEL_STATES = tuple(range(1, 33))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_shapes(name, a0, stream, LT=None, outs=()):
    """``a0`` (K, B); ``stream`` (T-1, K*K, B), or (T-1, K, B) beside a
    stationary ``LT`` (K, K); ``outs`` (the messages and their cotangents)
    (T-1, K, B) each. Returns ``(K, B, T-1)``."""
    K, B = a0.shape
    T1 = stream.shape[0]
    want = [(T1, K * K if LT is None else K, B)]
    got = [stream]
    if LT is not None:
        want.append((K, K))
        got.append(LT)
    want += [(T1, K, B)] * len(outs)
    if T1 < 1 or [tuple(t.shape) for t in got + list(outs)] != want:
        raise ValueError(f"{name}: inconsistent shapes")
    return K, B, T1


def _check(name, K, tensors):
    if K < 1:
        raise ValueError(f"{name}: no kernel for K={K}; the kernels take "
                         f"K >= 1")
    _check_kernel_args(name, K, tensors, (K,), "K")


def hmm_fb_fwd(a0, M):
    """Both message recursions over B sequences.

    ``a0`` (K, B): alpha_0. ``M`` (T-1, K*K, B): the chain elements, entry
    i*K + j. Returns ``alpha`` (T-1, K, B), alpha_1..alpha_{T-1}, and
    ``beta`` (T-1, K, B), beta_0..beta_{T-2}."""
    if a0.device.type == "cpu":
        return hmm_fb_fwd_plain(a0, M)
    K, B, T1 = _check_shapes("hmm_fb_fwd", a0, M)
    _check("hmm_fb_fwd", K, (a0, M))
    alpha = torch.empty((T1, K, B), dtype=a0.dtype, device=a0.device)
    beta = torch.empty_like(alpha)
    _launch("hmm_fb_fwd", _build.load_library().svae_hmm_fb_fwd_f32,
            a0.device, K, B, T1, a0, M, alpha, beta)
    hmm_fb_fwd.launches += 1
    return alpha, beta


hmm_fb_fwd.launches = 0


def hmm_fb_stat_fwd(a0, LT, lo):
    """:func:`hmm_fb_fwd` for a stationary chain, M_t(i, j) = LT(i, j) +
    lo_t(j): ``LT`` (K, K) is shared by every sequence and step, ``lo``
    (T-1, K, B) holds the observations of frames 1..T-1."""
    if a0.device.type == "cpu":
        return hmm_fb_stat_fwd_plain(a0, LT, lo)
    K, B, T1 = _check_shapes("hmm_fb_stat_fwd", a0, lo, LT)
    _check("hmm_fb_stat_fwd", K, (a0, LT, lo))
    alpha = torch.empty((T1, K, B), dtype=a0.dtype, device=a0.device)
    beta = torch.empty_like(alpha)
    _launch("hmm_fb_stat_fwd", _build.load_library().svae_hmm_fb_stat_fwd_f32,
            a0.device, K, B, T1, a0, LT, lo, alpha, beta)
    hmm_fb_stat_fwd.launches += 1
    return alpha, beta


hmm_fb_stat_fwd.launches = 0


def hmm_fb_adj(a0, M, alpha, beta, dalpha, dbeta):
    """Adjoint of :func:`hmm_fb_fwd`: its inputs, its outputs and their
    cotangents -> ``(da0, dM)``, shaped as the inputs. On a card one C
    call runs the three passes of :func:`hmm_fb_adj_weights`,
    :func:`hmm_fb_adj_chain` and :func:`hmm_fb_adj_dM`."""
    if a0.device.type == "cpu":
        return hmm_fb_adj_plain(a0, M, alpha, beta, dalpha, dbeta)
    outs = (alpha, beta, dalpha, dbeta)
    K, B, T1 = _check_shapes("hmm_fb_adj", a0, M, outs=outs)
    _check("hmm_fb_adj", K, (a0, M) + outs)
    # the passes' scratch: W and V, g and h, one allocation each
    W, V = torch.empty((2,) + M.shape, dtype=M.dtype, device=M.device)
    g, h = torch.empty((2,) + alpha.shape, dtype=M.dtype, device=M.device)
    dM, da0 = torch.empty_like(M), torch.empty_like(a0)
    _launch("hmm_fb_adj", _build.load_library().svae_hmm_fb_adj_f32,
            a0.device, K, B, T1, a0, M, *outs, W, V, g, h, dM, da0)
    hmm_fb_adj.launches += 1
    return da0, dM


hmm_fb_adj.launches = 0


# The adjoint's passes one by one, for holding each kernel against its own
# plain version: hmm_fb_adj = (da0, hmm_fb_adj_dM(W, V, g, h)) with (W, V)
# = hmm_fb_adj_weights(a0, M, alpha, beta) and (g, h, da0) =
# hmm_fb_adj_chain(W, V, dalpha, dbeta). The model paths call hmm_fb_adj,
# which launches the same kernels from one C call.


def hmm_fb_adj_weights(a0, M, alpha, beta):
    """Pass 1 of :func:`hmm_fb_adj`, parallel over (step, entry,
    sequence): the alpha chains' weights ``W`` and the beta chains' ``V``
    (T-1, K*K, B), entry i*K + j, w_ij = exp(alpha_t(i) + M_t(i,j) -
    alpha_{t+1}(j)) and v_ij = exp(M_t(i,j) + beta_{t+1}(j) - beta_t(i)).
    Arguments as :func:`hmm_fb_adj`'s first four."""
    if a0.device.type == "cpu":
        return hmm_fb_adj_weights_plain(a0, M, alpha, beta)
    K, B, T1 = _check_shapes("hmm_fb_adj_weights", a0, M,
                             outs=(alpha, beta))
    _check("hmm_fb_adj_weights", K, (a0, M, alpha, beta))
    W, V = torch.empty_like(M), torch.empty_like(M)
    _launch("hmm_fb_adj_weights",
            _build.load_library().svae_hmm_fb_adj_weights_f32, a0.device, K,
            B, T1, a0, M, alpha, beta, W, V)
    hmm_fb_adj_weights.launches += 1
    return W, V


hmm_fb_adj_weights.launches = 0


def _check_pass_shapes(name, W, V, vecs):
    """``W``, ``V`` (T-1, K*K, B) and ``vecs`` (T-1, K, B) each; returns
    ``(K, B, T-1)``."""
    T1, KK, B = W.shape if W.dim() == 3 else (0, 0, 0)
    K = math.isqrt(KK)
    if (T1 < 1 or K * K != KK or V.shape != W.shape
            or any(x.shape != (T1, K, B) for x in vecs)):
        raise ValueError(f"{name}: inconsistent shapes")
    return K, B, T1


def hmm_fb_adj_chain(W, V, dalpha, dbeta):
    """Pass 2 of :func:`hmm_fb_adj`, serial in the steps, products only:
    from :func:`hmm_fb_adj_weights`' ``W`` and ``V`` and the cotangents
    ``dalpha``, ``dbeta`` (T-1, K, B) of the forward's outputs, the alpha
    chains' g_t = c + dalpha_t, c <- sum_j g_j w_t(i, j) (t descending) and
    the beta chains' h_t = c + dbeta_t, c <- sum_i h_i v_t(i, j) (t
    ascending). Returns ``(g, h (T-1, K, B), da0 (K, B))``."""
    if W.device.type == "cpu":
        return hmm_fb_adj_chain_plain(W, V, dalpha, dbeta)
    K, B, T1 = _check_pass_shapes("hmm_fb_adj_chain", W, V, (dalpha, dbeta))
    args = (W, V, dalpha, dbeta)
    _check("hmm_fb_adj_chain", K, args)
    g, h = torch.empty_like(dalpha), torch.empty_like(dalpha)
    da0 = torch.empty((K, B), dtype=W.dtype, device=W.device)
    _launch("hmm_fb_adj_chain",
            _build.load_library().svae_hmm_fb_adj_chain_f32, W.device, K, B,
            T1, *args, g, h, da0)
    hmm_fb_adj_chain.launches += 1
    return g, h, da0


hmm_fb_adj_chain.launches = 0


def hmm_fb_adj_dM(W, V, g, h):
    """Pass 3 of :func:`hmm_fb_adj`, parallel over (step, entry,
    sequence): dM_t(i, j) = g_t(j) w_ij + h_t(i) v_ij (T-1, K*K, B), both
    directions' parts of the chain elements' cotangent, from
    :func:`hmm_fb_adj_weights`' ``W``, ``V`` and
    :func:`hmm_fb_adj_chain`'s ``g``, ``h``."""
    if W.device.type == "cpu":
        return hmm_fb_adj_dM_plain(W, V, g, h)
    K, B, T1 = _check_pass_shapes("hmm_fb_adj_dM", W, V, (g, h))
    args = (W, V, g, h)
    _check("hmm_fb_adj_dM", K, args)
    dM = torch.empty_like(W)
    _launch("hmm_fb_adj_dM", _build.load_library().svae_hmm_fb_adj_dM_f32,
            W.device, K, B, T1, *args, dM)
    hmm_fb_adj_dM.launches += 1
    return dM


hmm_fb_adj_dM.launches = 0


def hmm_fb_stat_adj(a0, LT, lo, alpha, beta, dalpha, dbeta):
    """Adjoint of :func:`hmm_fb_stat_fwd` -> ``(da0, dLT, dlo)``, shaped as
    the inputs. On a card one C call runs the three passes of
    :func:`hmm_fb_stat_adj_weights`, :func:`hmm_fb_adj_chain` and
    :func:`hmm_fb_stat_adj_sums`."""
    if a0.device.type == "cpu":
        return hmm_fb_stat_adj_plain(a0, LT, lo, alpha, beta, dalpha, dbeta)
    outs = (alpha, beta, dalpha, dbeta)
    K, B, T1 = _check_shapes("hmm_fb_stat_adj", a0, lo, LT, outs)
    _check("hmm_fb_stat_adj", K, (a0, LT, lo) + outs)
    kw = dict(dtype=a0.dtype, device=a0.device)
    # the passes' scratch: W and V, g and h, one allocation each
    W, V = torch.empty((2, T1, K * K, B), **kw)
    g, h = torch.empty((2,) + alpha.shape, **kw)
    dlo, da0 = torch.empty_like(lo), torch.empty_like(a0)
    dLT = torch.empty((K, K), **kw)
    _launch("hmm_fb_stat_adj", _build.load_library().svae_hmm_fb_stat_adj_f32,
            a0.device, K, B, T1, a0, LT, lo, *outs, W, V, g, h, dlo, da0,
            dLT)
    hmm_fb_stat_adj.launches += 1
    return da0, dLT, dlo


hmm_fb_stat_adj.launches = 0


# The stationary adjoint's passes one by one, for holding each kernel
# against its own plain version: hmm_fb_stat_adj = (da0, *reversed(
# hmm_fb_stat_adj_sums(W, V, g, h))) with (W, V) = hmm_fb_stat_adj_weights(
# a0, LT, lo, alpha, beta) and (g, h, da0) = hmm_fb_adj_chain(W, V, dalpha,
# dbeta). hmm_posterior(kernel="stationary") calls hmm_fb_stat_adj, which
# launches the same kernels from one C call.


def hmm_fb_stat_adj_weights(a0, LT, lo, alpha, beta):
    """Pass 1 of :func:`hmm_fb_stat_adj`: :func:`hmm_fb_adj_weights` on the
    stationary chain elements M_t(i, j) = LT(i, j) + lo_t(j), which it
    forms from ``LT`` (K, K) and ``lo`` (T-1, K, B) without writing them.
    Returns ``(W, V)`` (T-1, K*K, B)."""
    if a0.device.type == "cpu":
        return hmm_fb_stat_adj_weights_plain(a0, LT, lo, alpha, beta)
    K, B, T1 = _check_shapes("hmm_fb_stat_adj_weights", a0, lo, LT,
                             (alpha, beta))
    args = (a0, LT, lo, alpha, beta)
    _check("hmm_fb_stat_adj_weights", K, args)
    W, V = (torch.empty((T1, K * K, B), dtype=a0.dtype, device=a0.device)
            for _ in range(2))
    _launch("hmm_fb_stat_adj_weights",
            _build.load_library().svae_hmm_fb_stat_adj_weights_f32,
            a0.device, K, B, T1, *args, W, V)
    hmm_fb_stat_adj_weights.launches += 1
    return W, V


hmm_fb_stat_adj_weights.launches = 0


def hmm_fb_stat_adj_sums(W, V, g, h):
    """Pass 3 of :func:`hmm_fb_stat_adj`, from the weights and the chains'
    ``g``, ``h`` (T-1, K, B): ``dlo`` (T-1, K, B), dlo_t(j) = g_t(j) +
    sum_i h_t(i) v_t(i, j), and ``dLT`` (K, K), the sum over steps and
    sequences of g_t(j) w_ij + h_t(i) v_ij. Returns ``(dlo, dLT)``."""
    if W.device.type == "cpu":
        return hmm_fb_stat_adj_sums_plain(W, V, g, h)
    K, B, T1 = _check_pass_shapes("hmm_fb_stat_adj_sums", W, V, (g, h))
    args = (W, V, g, h)
    _check("hmm_fb_stat_adj_sums", K, args)
    dlo = torch.empty_like(g)
    dLT = torch.empty((K, K), dtype=W.dtype, device=W.device)
    _launch("hmm_fb_stat_adj_sums",
            _build.load_library().svae_hmm_fb_stat_adj_sums_f32, W.device, K,
            B, T1, *args, dlo, dLT)
    hmm_fb_stat_adj_sums.launches += 1
    return dlo, dLT


hmm_fb_stat_adj_sums.launches = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _recursions(a0, elements, T1):
    """The two recursions over T1 steps, ``elements(t)`` giving the
    (B, K, K) chain elements of step t; returns packed (T-1, K, B) alpha
    and beta."""
    a = a0.T
    alphas = []
    for t in range(T1):
        a = torch.logsumexp(a[:, :, None] + elements(t), dim=1)
        alphas.append(a.T)
    b = torch.zeros_like(a0.T)
    betas = [None] * T1
    for t in reversed(range(T1)):
        b = torch.logsumexp(elements(t) + b[:, None, :], dim=2)
        betas[t] = b.T
    return torch.stack(alphas), torch.stack(betas)


def hmm_fb_fwd_plain(a0, M):
    """Plain PyTorch twin of :func:`hmm_fb_fwd` (same arguments)."""
    hmm_fb_fwd_plain.calls += 1
    T1, _, B = M.shape
    K = a0.shape[0]
    Mm = M.permute(0, 2, 1).reshape(T1, B, K, K)
    return _recursions(a0, lambda t: Mm[t], T1)


hmm_fb_fwd_plain.calls = 0


def hmm_fb_stat_fwd_plain(a0, LT, lo):
    """Plain PyTorch twin of :func:`hmm_fb_stat_fwd` (same arguments).
    The elements LT(i, j) + lo_t(j) are formed once, in the layout
    :func:`hmm_fb_fwd_plain` reads from M, so that the two reduce the same
    layout and give the same float32 messages on M = LT + lo."""
    hmm_fb_stat_fwd_plain.calls += 1
    Mm = (LT[None, :, :, None] + lo[:, None]).permute(0, 3, 1, 2)
    return _recursions(a0, lambda t: Mm[t], lo.shape[0])


hmm_fb_stat_fwd_plain.calls = 0


def hmm_fb_adj_plain(a0, M, alpha, beta, dalpha, dbeta):
    """Plain version of :func:`hmm_fb_adj` (same arguments, same outputs):
    the vector-Jacobian product of :func:`hmm_fb_fwd_plain` (``alpha`` and
    ``beta`` are not read)."""
    hmm_fb_adj_plain.calls += 1
    return tuple(_vjp(hmm_fb_fwd_plain, (a0, M), (dalpha, dbeta)))


hmm_fb_adj_plain.calls = 0


def hmm_fb_adj_weights_plain(a0, M, alpha, beta):
    """Plain version of :func:`hmm_fb_adj_weights` (same arguments, same
    outputs), batched over steps, entries and sequences in the kernel's op
    order."""
    hmm_fb_adj_weights_plain.calls += 1
    T1, KK, B = M.shape
    K = a0.shape[0]
    Mm = M.reshape(T1, K, K, B)
    prev = torch.cat([a0[None], alpha[:-1]])          # alpha_t, (T-1, K, B)
    nxt = torch.cat([beta[1:], torch.zeros_like(beta[:1])])  # beta_{t+1}
    W = torch.exp(prev[:, :, None] + Mm - alpha[:, None])
    V = torch.exp(Mm + nxt[:, None] - beta[:, :, None])
    return W.reshape(T1, KK, B), V.reshape(T1, KK, B)


hmm_fb_adj_weights_plain.calls = 0


def hmm_fb_adj_chain_plain(W, V, dalpha, dbeta):
    """Plain version of :func:`hmm_fb_adj_chain` (same arguments, same
    outputs): the two chains stepped over the lanes, the sums in the
    kernel's index order."""
    hmm_fb_adj_chain_plain.calls += 1
    T1, K, B = dalpha.shape
    Wm, Vm = W.reshape(T1, K, K, B), V.reshape(T1, K, K, B)
    g, h = torch.empty_like(dalpha), torch.empty_like(dbeta)
    c = torch.zeros_like(dalpha[0])
    for t in reversed(range(T1)):
        g[t] = c + dalpha[t]
        c = (Wm[t] * g[t][None]).sum(1)      # c(i) = sum_j g_j w_t(i, j)
    da0 = c
    c = torch.zeros_like(dbeta[0])
    for t in range(T1):
        h[t] = c + dbeta[t]
        c = (Vm[t] * h[t][:, None]).sum(0)   # c(j) = sum_i h_i v_t(i, j)
    return g, h, da0


hmm_fb_adj_chain_plain.calls = 0


def hmm_fb_adj_dM_plain(W, V, g, h):
    """Plain version of :func:`hmm_fb_adj_dM` (same arguments, same
    output)."""
    hmm_fb_adj_dM_plain.calls += 1
    T1, K, B = g.shape
    dM = (g[:, None] * W.reshape(T1, K, K, B)
          + h[:, :, None] * V.reshape(T1, K, K, B))
    return dM.reshape(T1, K * K, B)


hmm_fb_adj_dM_plain.calls = 0


def hmm_fb_stat_adj_plain(a0, LT, lo, alpha, beta, dalpha, dbeta):
    """Plain version of :func:`hmm_fb_stat_adj` (same arguments, same
    outputs): the vector-Jacobian product of
    :func:`hmm_fb_stat_fwd_plain`."""
    hmm_fb_stat_adj_plain.calls += 1
    return tuple(_vjp(hmm_fb_stat_fwd_plain, (a0, LT, lo), (dalpha, dbeta)))


hmm_fb_stat_adj_plain.calls = 0


def hmm_fb_stat_adj_weights_plain(a0, LT, lo, alpha, beta):
    """Plain version of :func:`hmm_fb_stat_adj_weights` (same arguments,
    same outputs): :func:`hmm_fb_adj_weights_plain` on the elements
    LT(i, j) + lo_t(j), the kernel's grouping."""
    hmm_fb_stat_adj_weights_plain.calls += 1
    T1, K, B = lo.shape
    M = LT[None, :, :, None] + lo[:, None]               # (T-1, K, K, B)
    return hmm_fb_adj_weights_plain(a0, M.reshape(T1, K * K, B), alpha,
                                    beta)


hmm_fb_stat_adj_weights_plain.calls = 0


def hmm_fb_stat_adj_sums_plain(W, V, g, h):
    """Plain version of :func:`hmm_fb_stat_adj_sums` (same arguments, same
    outputs)."""
    hmm_fb_stat_adj_sums_plain.calls += 1
    T1, K, B = g.shape
    dlo = g + (h[:, :, None] * V.reshape(T1, K, K, B)).sum(1)
    dLT = hmm_fb_adj_dM_plain(W, V, g, h).reshape(T1, K, K, B).sum((0, 3))
    return dlo, dLT


hmm_fb_stat_adj_sums_plain.calls = 0


# --------------------------------------------------------------------------
# autograd Functions (the JAX package's _prim / _stat_prim)
# --------------------------------------------------------------------------


class HmmFb(torch.autograd.Function):
    """:func:`hmm_fb_fwd` with :func:`hmm_fb_adj` as its backward."""

    @staticmethod
    def forward(ctx, a0, M):
        alpha, beta = hmm_fb_fwd(a0, M)
        ctx.save_for_backward(a0, M, alpha, beta)
        return alpha, beta

    @staticmethod
    def backward(ctx, dalpha, dbeta):
        return hmm_fb_adj(*ctx.saved_tensors, dalpha.contiguous(),
                          dbeta.contiguous())


class HmmFbStat(torch.autograd.Function):
    """:func:`hmm_fb_stat_fwd` with :func:`hmm_fb_stat_adj` as its
    backward."""

    @staticmethod
    def forward(ctx, a0, LT, lo):
        alpha, beta = hmm_fb_stat_fwd(a0, LT, lo)
        ctx.save_for_backward(a0, LT, lo, alpha, beta)
        return alpha, beta

    @staticmethod
    def backward(ctx, dalpha, dbeta):
        return hmm_fb_stat_adj(*ctx.saved_tensors, dalpha.contiguous(),
                               dbeta.contiguous())


# --------------------------------------------------------------------------
# the batched posterior
# --------------------------------------------------------------------------


def _pack(x):
    """(B, T-1, ...) -> the (T-1, m, B) stream."""
    return x.reshape(x.shape[0], x.shape[1], -1).permute(1, 2, 0).contiguous()


def hmm_posterior(log_init, log_trans, log_obs, pair_weights=None,
                  kernel="auto"):
    """Forward-backward posterior of B chains: ``(logZ (B,), node
    (B, T, K), pair_sum (B, K, K), init_marginal (B, K))``.

    ``log_init`` (K,); ``log_trans`` (K, K), shared, or (B, T-1, K, K),
    per sequence and transition (a ragged batch's pad transitions carry
    uniform rows); ``log_obs`` (B, T, K), T >= 2. ``pair_weights``
    (B, T-1) weights the sum of the pair marginals, so pad transitions
    drop out of it. ``kernel`` picks the recursion for a shared (K, K)
    ``log_trans``: ``"streamed"`` streams the K*K chain elements,
    ``"stationary"`` the K observations beside the whole matrix;
    ``"auto"`` is ``"streamed"``. Time-varying transitions always stream,
    and ``"stationary"`` with them raises ``ValueError``. Differentiable.

    The pair marginal keeps the materialized form exp(alpha_t(i) + M_t(i,j)
    + beta_{t+1}(j) - logZ), each exponent bounded by the posterior: a
    factorized form overflows when the observations force a transition
    whose log-probability is near -100 (0 * inf = NaN)."""
    B, T, K = log_obs.shape
    if T < 2:
        raise ValueError("hmm_posterior: needs T >= 2 (a chain of at least "
                         "one transition)")
    if kernel not in ("auto", "streamed", "stationary"):
        raise ValueError(f"kernel must be auto|streamed|stationary, got "
                         f"{kernel!r}")
    dt = log_obs.dtype
    log_init = log_init.to(dt)
    log_trans = log_trans.to(dt)
    stationary = log_trans.dim() == 2
    if kernel == "stationary" and not stationary:
        raise ValueError("hmm_posterior(kernel='stationary') requires a "
                         "stationary (K, K) log_trans; got time-varying "
                         "transitions: use kernel='auto' or 'streamed'")
    a0 = log_init + log_obs[:, 0]                          # (B, K)
    M = log_trans + log_obs[:, 1:, None, :]                # (B, T-1, K, K)
    if kernel == "stationary":
        args = (a0.T.contiguous(), log_trans.contiguous(),
                _pack(log_obs[:, 1:]))
        alpha_f, beta_f = _forward(hmm_fb_stat_fwd, hmm_fb_stat_fwd_plain,
                                   HmmFbStat, args)
    else:
        args = (a0.T.contiguous(), _pack(M))
        alpha_f, beta_f = _forward(hmm_fb_fwd, hmm_fb_fwd_plain, HmmFb, args)
    alpha = torch.cat([a0[:, None], alpha_f.permute(2, 0, 1)], 1)
    beta = torch.cat([beta_f.permute(2, 0, 1), a0.new_zeros(B, 1, K)], 1)
    return marginals(alpha, beta, M, pair_weights)


def marginals(alpha, beta, M, pair_weights=None):
    """``(logZ, node, pair_sum, init_marginal)`` from the messages alpha,
    beta (B, T, K) and the chain elements M (B, T-1, K, K) (the pair
    marginals weighted by ``pair_weights`` (B, T-1) in their sum), in the
    materialized form of :func:`hmm_posterior`."""
    logZ = torch.logsumexp(alpha[:, -1], -1)
    node = torch.exp(alpha + beta - logZ[:, None, None])
    pair = torch.exp(alpha[:, :-1, :, None] + M + beta[:, 1:, None, :]
                     - logZ[:, None, None, None])
    if pair_weights is None:
        pair_sum = pair.sum(1)
    else:
        pair_sum = torch.einsum("bt,btij->bij", pair_weights.to(M.dtype),
                                pair)
    return logZ, node, pair_sum, node[:, 0]
