"""Natural-parameter Kalman inference on the Gaussian chain-element algebra
(port of svae_tpu/ops/kalman.py), in batched torch ops.

An element is the log-potential of a contiguous time block as a joint
Gaussian potential over its (first, last) variables,

    e = (J11, J12, J22, h1, h2, c)
    e(xf, xl) = -1/2 xf^T J11 xf - xf^T J12 xl - 1/2 xl^T J22 xl
                + h1^T xf + h2^T xl + c,

and :func:`combine` joins two adjacent blocks by marginalizing the variable
they share (one Cholesky factor and one Schur complement). The join is
associative, so the forward filter (prefix scan), the backward filter
(suffix scan), the smoothed marginals and the log-partition (the total
element) can be evaluated in any order. Every entry point takes
``parallel``:

* ``False``: a Python loop over the leaves, T-1 combines in sequence;
* ``True``: a log-depth tree (Hillis-Steele): ceil(log2(T-1)) rounds of
  batched combines, equal to ``lax.associative_scan``'s result to
  rounding;
* an int ``C``: the blocked two-pass scan of :func:`_chunked_scan`, the C
  chunks combined side by side in ceil((T-1)/C) steps, then their totals
  in C steps, then one batched seeding combine.

The posterior sampler runs the same three flavors over affine maps.

Everything is batched over a leading sequence axis: nodes are (B, T, ...),
pairs are shared (T-1, ...) or per sequence (B, T-1, ...), and the
element trees of the scans are (B, T-1, ...). The scans themselves run
time-major, with time on axis 0, as the JAX package's ``lax.scan`` does.
The entry points turn TF32 off (:func:`~svae_tpu_torch.utils.psd.f32_linalg`)
so that no rounded matmul reaches the chained Schur complements; a failed
Cholesky factor is NaN (:mod:`~svae_tpu_torch.utils.smallchol`).

Left out: the JAX package's ``optimization_barrier`` in the smoother core,
which worked around an XLA:TPU miscompile and means nothing here.
"""

import math

import torch

from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import f32_linalg, inv_psd, solve_psd, symmetrize

LOG2PI = math.log(2 * math.pi)


# --------------------------------------------------------------------------
# element algebra
# --------------------------------------------------------------------------


def _solve_and_logdet(M, rhs_mat, rhs_vec):
    """M^-1 rhs_mat, M^-1 rhs_vec and log|M| from one factor of sym(M)."""
    L = smallchol.chol(symmetrize(M))
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return (smallchol.cho_solve_mat(L, rhs_mat), smallchol.cho_solve(L, rhs_vec),
            logdet)


def combine(ea, eb):
    """Associative combine: marginalize the variable shared between block a
    (ending at it) and block b (starting at it). Batched over any leading
    axes."""
    J11a, J12a, J22a, h1a, h2a, ca = ea
    J11b, J12b, J22b, h1b, h2b, cb = eb
    d = h1a.shape[-1]
    M = J22a + J11b
    b0 = h2a + h1b
    rhs = torch.cat(torch.broadcast_tensors(J12a.mT, J12b), dim=-1)
    sol, Minv_b0, logdetM = _solve_and_logdet(M, rhs, b0)
    Minv_J12aT, Minv_J12b = sol[..., :d], sol[..., d:]
    J11 = J11a - J12a @ Minv_J12aT
    J22 = J22b - J12b.mT @ Minv_J12b
    J12 = -J12a @ Minv_J12b
    h1 = h1a - (J12a @ Minv_b0[..., None])[..., 0]
    h2 = h2b - (J12b.mT @ Minv_b0[..., None])[..., 0]
    c = (ca + cb + 0.5 * d * LOG2PI - 0.5 * logdetM
         + 0.5 * (b0 * Minv_b0).sum(-1))
    return (symmetrize(J11), J12, symmetrize(J22), h1, h2, c)


def marginalize_first(e):
    """Integrate out xf -> information-form potential (J, h, c) on xl."""
    J11, J12, J22, h1, h2, c = e
    d = h1.shape[-1]
    Minv_J12, Minv_h1, logdet = _solve_and_logdet(J11, J12, h1)
    J = symmetrize(J22 - J12.mT @ Minv_J12)
    h = h2 - (J12.mT @ Minv_h1[..., None])[..., 0]
    c = c + 0.5 * d * LOG2PI - 0.5 * logdet + 0.5 * (h1 * Minv_h1).sum(-1)
    return J, h, c


def marginalize_last(e):
    """Integrate out xl -> information-form potential (J, h, c) on xf."""
    J11, J12, J22, h1, h2, c = e
    d = h1.shape[-1]
    Minv_J12T, Minv_h2, logdet = _solve_and_logdet(J22, J12.mT, h2)
    J = symmetrize(J11 - J12 @ Minv_J12T)
    h = h1 - (J12 @ Minv_h2[..., None])[..., 0]
    c = c + 0.5 * d * LOG2PI - 0.5 * logdet + 0.5 * (h2 * Minv_h2).sum(-1)
    return J, h, c


def _gauss_logZ_info(J, h, c):
    d = h.shape[-1]
    L = smallchol.chol(symmetrize(J))
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    v = smallchol.cho_solve(L, h)
    return 0.5 * d * LOG2PI - 0.5 * logdet + 0.5 * (h * v).sum(-1) + c


def build_leaves(init, pairs, nodes):
    """The T-1 leaf elements of each sequence, (B, T-1, ...): leaf t covers
    the pair (x_t, x_{t+1}) and owns node t+1; the first leaf also owns
    init and node 0, so the prefix scan's elements with x_1 marginalized
    are the filtered potentials, and suffix elements carry strictly-future
    information. ``init`` = (I1, I2, Ic); ``pairs`` = (P1, P2, P3, Pc),
    shared (T-1, ...) or per sequence (B, T-1, ...); ``nodes`` = (N1, N2),
    (B, T, d, d) and (B, T, d)."""
    I1, I2, Ic = init
    P1, P2, P3, Pc = pairs
    N1, N2 = nodes
    B, T, d = N2.shape
    first = torch.zeros(T - 1, dtype=N2.dtype, device=N2.device)
    first[0] = 1.0
    f = first[:, None, None]
    mat, vec, sc = (B, T - 1, d, d), (B, T - 1, d), (B, T - 1)
    J11 = (-2.0 * (P3 + f * (I1 + N1[:, :1]))).expand(mat)
    J12 = (-P2.mT).expand(mat)
    J22 = (-2.0 * (P1 + N1[:, 1:])).expand(mat)
    h1 = (first[:, None] * (I2 + N2[:, :1])).expand(vec)
    h2 = N2[:, 1:]
    c = (Pc + first * Ic).expand(sc)
    return (J11, J12, J22, h1, h2, c)


# --------------------------------------------------------------------------
# scans (time-major element trees: time on axis 0)
# --------------------------------------------------------------------------


def _time_major(tree):
    return tuple(a.movedim(1, 0) for a in tree)


def _batch_major(tree):
    return tuple(a.movedim(0, 1) for a in tree)


def _where(mask, x, y):
    """Leafwise ``torch.where`` with a mask over the leading axes."""
    return tuple(torch.where(mask.reshape(mask.shape + (1,) * (a.dim()
                                                               - mask.dim())),
                             a, b) for a, b in zip(x, y))


def _seq_scan(leaves, op2):
    """Inclusive prefix scan as a loop: out[t] = op2(out[t-1], leaf[t])."""
    carry = tuple(a[0] for a in leaves)
    outs = [carry]
    for t in range(1, leaves[0].shape[0]):
        carry = op2(carry, tuple(a[t] for a in leaves))
        outs.append(carry)
    return tuple(torch.stack(x) for x in zip(*outs))


def _tree_scan(leaves, op2):
    """Inclusive prefix scan in ceil(log2 n) rounds of batched ``op2``
    (Hillis-Steele): after the round of offset k, element t holds the
    combination of leaves max(0, t-2k+1) .. t."""
    cur = leaves
    n, k = leaves[0].shape[0], 1
    while k < n:
        joined = op2(tuple(a[:-k] for a in cur), tuple(a[k:] for a in cur))
        cur = tuple(torch.cat([a[:k], b]) for a, b in zip(cur, joined))
        k *= 2
    return cur


def _flip(tree):
    return tuple(a.flip(0) for a in tree)


def _scan(leaves, parallel, reverse=False, op2=None):
    """Inclusive prefix (or, ``reverse``, suffix) scan of an associative
    ``op2(earlier, later)`` (default :func:`combine`) over time-major
    leaves, in the flavor ``parallel`` names. A suffix scan is the prefix
    scan of the time-flipped leaves with the operands swapped, flipped
    back."""
    op2 = combine if op2 is None else op2
    if parallel is not True and parallel:
        return _chunked_scan(leaves, parallel, reverse, op2)[1]
    scan = _tree_scan if parallel is True else _seq_scan
    if not reverse:
        return scan(leaves, op2)
    return _flip(scan(_flip(leaves), lambda a, b: op2(b, a)))


def _chunked_scan(leaves, C, reverse=False, op2=None):
    """Two-pass prefix (or suffix, ``reverse``) scan of ``op2(earlier,
    later)`` (default :func:`combine`) over time-major leaves: the C chunks
    are scanned side by side (depth ceil(T1/C)), their totals in sequence
    (depth C), and every chunk but the first is seeded with the running
    total before it in one batched ``op2``. A length that C does not divide
    is front-padded with copies of the first row, which the masks below
    keep out of every combine (the algebra has no identity element): until
    a real leaf is absorbed the carry is a pad row and the first real leaf
    replaces it.

    Returns ``(total, scans)``, the scans shaped as the leaves."""
    op2 = combine if op2 is None else op2
    T1 = leaves[0].shape[0]
    C = max(1, min(int(C), T1))
    L = -(-T1 // C)
    npad = C * L - T1
    op = (lambda a, b: op2(b, a)) if reverse else op2
    if reverse:
        leaves = _flip(leaves)
    if npad:
        leaves = tuple(torch.cat([a[:1].expand((npad,) + a.shape[1:]), a])
                       for a in leaves)
    dev = leaves[0].device
    validc = (torch.arange(C * L, device=dev) >= npad).reshape(C, L)

    def mstep(carry, started, leaf, ok):
        new = _where(started, op(carry, leaf), leaf)
        return _where(ok, new, carry), started | ok

    lc = tuple(a.reshape((C, L) + a.shape[1:]) for a in leaves)
    carry, started = tuple(a[:, 0] for a in lc), validc[:, 0]
    local = [carry]
    for j in range(1, L):
        carry, started = mstep(carry, started, tuple(a[:, j] for a in lc),
                               validc[:, j])
        local.append(carry)
    local = tuple(torch.stack(x, 1) for x in zip(*local))   # (C, L, ...)

    # the chunk totals in sequence; leading all-pad chunks masked the same
    cvalid = validc.any(1)
    carry, started = tuple(a[0] for a in carry), cvalid[0]
    pincl, pvalid = [carry], [started]
    ends = tuple(a[:, -1] for a in local)
    for c in range(1, C):
        carry, started = mstep(carry, started, tuple(a[c] for a in ends),
                               cvalid[c])
        pincl.append(carry)
        pvalid.append(started)
    total = carry
    if C > 1:
        Pprev = tuple(torch.stack(x[:-1])[:, None].expand(
            (C - 1, L) + x[0].shape) for x in zip(*pincl))
        rest = tuple(a[1:] for a in local)
        seeded = _where(torch.stack(pvalid[:-1])[:, None].expand(C - 1, L),
                        op(Pprev, rest), rest)
        out = tuple(torch.cat([a[:1], s]) for a, s in zip(local, seeded))
    else:
        out = local
    out = tuple(a.reshape((C * L,) + a.shape[2:])[npad:] for a in out)
    if reverse:
        out = _flip(out)
    return total, out


def _prefix_suffix(leaves, parallel):
    """Total element (B, ...), inclusive prefix and suffix (B, T-1, ...) of
    batch-major ``leaves``."""
    tm = _time_major(leaves)
    prefix = _scan(tm, parallel)
    suffix = _scan(tm, parallel, reverse=True)
    return (tuple(a[-1] for a in prefix), _batch_major(prefix),
            _batch_major(suffix))


# --------------------------------------------------------------------------
# logZ / filter / smoother
# --------------------------------------------------------------------------


@f32_linalg()
def lds_logZ(init, pairs, nodes, parallel=False):
    """Log-partition (B,) of each chain. Differentiable: its gradients with
    respect to the nodes and pairs are the smoothed expected statistics."""
    prefix = _scan(_time_major(build_leaves(init, pairs, nodes)), parallel)
    return _gauss_logZ_info(*marginalize_first(tuple(a[-1] for a in prefix)))


@f32_linalg()
def lds_filter(init, pairs, nodes, parallel=False):
    """Forward filter: ``(logZ (B,), Jf (B, T, d, d), hf (B, T, d))``, with
    (Jf[:, t], hf[:, t]) the filtered information-form potential on x_t
    (node t included), from the prefix scan with x_1 marginalized."""
    prefix = _scan(_time_major(build_leaves(init, pairs, nodes)), parallel)
    Jp, hp, cp = marginalize_first(_batch_major(prefix))
    Jf, hf = _filtered(init, nodes, Jp, hp)
    return _gauss_logZ_info(Jp[:, -1], hp[:, -1], cp[:, -1]), Jf, hf


def _filtered(init, nodes, Jp, hp):
    """alpha_1 = init + node_1 ahead of the prefix's marginals."""
    N1, N2 = nodes
    J1 = (-2.0 * (init[0] + N1[:, 0]))[:, None]
    h1 = (init[1] + N2[:, 0])[:, None]
    return torch.cat([J1, Jp], 1), torch.cat([h1, hp], 1)


@f32_linalg()
def lds_smoother(init, pairs, nodes, parallel=False):
    """Two-filter smoother: ``(logZ (B,), Ex (B, T, d), ExxT (B, T, d, d),
    Exnxt (B, T-1, d, d))`` with Exnxt[:, t] = E[x_t x_{t+1}^T]."""
    return _smoother_core(init, pairs, nodes, parallel)[:4]


def _smoother_core(init, pairs, nodes, parallel=False):
    """The smoother, plus the filtered messages (Jf, hf) for the sampler."""
    total, prefix, suffix = _prefix_suffix(build_leaves(init, pairs, nodes),
                                           parallel)
    return assemble_moments(init, pairs, nodes, total, prefix, suffix)


def assemble_moments(init, pairs, nodes, total, prefix, suffix):
    """``(logZ, Ex, ExxT, Exnxt, Jf, hf)`` from the total element (B, ...)
    and the inclusive prefix and suffix element trees (B, T-1, ...) of any
    scan flavor, the chunked kernels' of :mod:`~svae_tpu_torch.ops.chunked`
    included."""
    N1, N2 = nodes
    B, T, d = N2.shape
    logZ = _gauss_logZ_info(*marginalize_first(total))

    # forward messages alpha_t: alpha_1 = init + node_1, then the prefixes
    # with x_1 marginalized
    Jg_f, hg_f, _ = marginalize_first(prefix)
    Jf, hf = _filtered(init, nodes, Jg_f, hg_f)

    # backward messages beta_t (pairs t..T-1, nodes t+1..T): the suffixes
    # with x_T marginalized, zero at t = T; suffix[0] also holds init and
    # node 1, which the first leaf owns: strip them
    Jg_b, hg_b, _ = marginalize_last(suffix)
    Jb = torch.cat([(Jg_b[:, 0] - Jf[:, 0])[:, None], Jg_b[:, 1:],
                    Jg_b.new_zeros(B, 1, d, d)], 1)
    hb = torch.cat([(hg_b[:, 0] - hf[:, 0])[:, None], hg_b[:, 1:],
                    hg_b.new_zeros(B, 1, d)], 1)

    Js, hs = Jf + Jb, hf + hb
    Sig = inv_psd(Js)
    Ex = (Sig @ hs[..., None])[..., 0]
    ExxT = symmetrize(Sig + Ex[..., :, None] * Ex[..., None, :])

    # pair marginals over (x_t, x_{t+1}): alpha_t + pair + node_{t+1} +
    # beta_{t+1}; the cross covariance from the 2d x 2d joint,
    # Cov12 = -J11^-1 J12 S^-1 with S = J22 - J12^T J11^-1 J12
    P1, P2, P3, _ = pairs
    J12l = -P2.mT
    J11 = -2.0 * P3 + Jf[:, :-1]
    J22 = -2.0 * (P1 + N1[:, 1:]) + Jb[:, 1:]
    J11inv_J12 = solve_psd(J11, J12l.expand(J11.shape))
    S = J22 - J12l.mT @ J11inv_J12
    Cov12 = -J11inv_J12 @ inv_psd(S)
    Exnxt = Cov12 + Ex[:, :-1, :, None] * Ex[:, 1:, None, :]
    return logZ, Ex, ExxT, Exnxt, Jf, hf


# --------------------------------------------------------------------------
# posterior sampling
# --------------------------------------------------------------------------


def _affine_combine(b, a):
    """Compose x -> F_b (F_a x + g_a) + g_b: ``b`` is the earlier (outer)
    map, ``a`` the later one."""
    Fb, gb = b
    Fa, ga = a
    return (Fb @ Fa, (Fb @ ga[..., None])[..., 0] + gb)


@f32_linalg()
def lds_sample(init, pairs, nodes, generator, num_samples, parallel=False,
               filtered=None, eps=None):
    """Reparameterized joint posterior samples (S, B, T, d).

    The backward conditionals x_t | x_{t+1} ~ N(F_t x_{t+1} + f_t, C_t)
    come from the forward filter (``filtered`` = (Jf, hf) skips
    recomputing it); the recursion runs as a loop (``parallel=False``) or
    as a suffix scan of affine maps in the tree or chunked flavor. (F, f,
    chol C) are shared by the samples of a sequence. ``generator`` draws
    the standard normal noise (S, B, T, d) unless ``eps`` gives it: per
    sequence it is the JAX package's draw ``normal(key, (S, T, d))``."""
    N1, N2 = nodes
    B, T, d = N2.shape
    if filtered is None:
        _, Jf, hf = lds_filter(init, pairs, nodes, parallel=parallel)
    else:
        Jf, hf = filtered
    P2, P3 = pairs[1], pairs[2]

    # x_t given x_{t+1}: precision Jc = Jf[t] - 2 P3_t, linear term
    # hf[t] + P2_t^T x_{t+1}
    Jc = Jf[:, :-1] - 2.0 * P3
    Lc = smallchol.chol(symmetrize(Jc))
    F = smallchol.cho_solve_mat(Lc, P2.mT.expand(Jc.shape))   # Jc^-1 P2^T
    f = smallchol.cho_solve(Lc, hf[:, :-1])
    LT = smallchol.chol(symmetrize(Jf[:, -1]))
    muT = smallchol.cho_solve(LT, hf[:, -1])

    S = int(num_samples)
    if eps is None:
        if generator is None:
            raise ValueError("lds_sample: pass a torch.Generator or eps; the "
                             "global RNG is not used")
        eps = torch.randn((S, B, T, d), generator=generator, dtype=N2.dtype,
                          device=N2.device)
    xT = muT + smallchol.solve_upper_from_lower(LT, eps[:, :, -1])
    g = f + smallchol.solve_upper_from_lower(Lc, eps[:, :, :-1])  # (S,B,T1,d)

    if not parallel:
        x, xs = xT, [None] * (T - 1)
        for t in reversed(range(T - 1)):
            x = (F[:, t] @ x[..., None])[..., 0] + g[:, :, t]
            xs[t] = x
        xs = torch.stack(xs, 2)
    else:
        # suffix composition: element t maps x_T to x_t
        maps = (F.expand(g.shape + (d,)).movedim(2, 0), g.movedim(2, 0))
        Fcum, gcum = _scan(maps, parallel, reverse=True, op2=_affine_combine)
        xs = ((Fcum @ xT[..., None])[..., 0] + gcum).movedim(0, 2)
    return torch.cat([xs, xT[:, :, None]], 2)


# --------------------------------------------------------------------------
# fused E-step
# --------------------------------------------------------------------------


@f32_linalg()
def lds_inference(init, pairs, nodes, generator, num_samples, parallel=False,
                  eps=None):
    """Full LDS E-step: ``(samples (S, B, T, d), (Ex, ExxT, Exnxt), logZ
    (B,))``; the sampler reuses the smoother's filtered messages."""
    logZ, Ex, ExxT, Exnxt, Jf, hf = _smoother_core(init, pairs, nodes,
                                                   parallel)
    samples = lds_sample(init, pairs, nodes, generator, num_samples,
                         parallel=parallel, filtered=(Jf, hf), eps=eps)
    return samples, (Ex, ExxT, Exnxt), logZ
