"""Chunked parallel-in-time LDS E-step (port of
svae_tpu/ops/pallas_chunked.py).

The T-1 chain-element leaves of each sequence (the algebra of
:mod:`svae_tpu_torch.ops.kalman`) are cut into C chunks that ride side by
side on separate lanes, so the serial depth drops from T-1 combines to
L = ceil((T-1)/C) within the chunks plus C across them:

  pass 1  one element prefix scan over B*C lanes, depth L: every
          within-chunk prefix; the suffixes are the same scan over the
          time-flipped, element-reversed leaves (:func:`_rev_elem` swaps
          J11 <-> J22 and h1 <-> h2 and transposes J12);
  pass 2  the chunk totals scanned the same way, prefix and suffix, over B
          lanes, depth C;
  pass 3  one batched seeding combine (torch ops) and the moment assembly
          shared with every scan flavor (kalman.assemble_moments).

The element scan is :func:`elem_scan`: a CUDA kernel (``csrc/elem_scan.cu``)
for tensors on a card and a plain PyTorch version for tensors on the CPU,
with the launch counters and the no-fallback rule of
:mod:`~svae_tpu_torch.ops.estep`. :class:`ElemScan` makes it
differentiable; its backward is :func:`elem_scan_adj`, the reverse sweep
in the closed form of the combine's vector-Jacobian product
(``csrc/elem_scan_adj.cu``), which runs on a card as two kernels from one
C call: a pass over every (combine, lane) for the combine's inverse and
products (:func:`elem_scan_adj_factor`) and the serial chain of the
carried cotangent (:func:`elem_scan_adj_chain`), each with a plain version
of its own. The plain versions of the scan and the adjoint loop
``kalman.combine`` over the steps, batched over the lanes, and take the
adjoint as ``torch.autograd``'s VJP of that loop, independent of the
kernels' algebra. Elements travel packed as (L, R, N) float32 with the lane
innermost, R = 3d^2 + 2d + 1 rows per element (J11, J12, J22 row-major,
then h1, h2, c), as the JAX package packs them.

A length that C does not divide needs no masks: the chain is extended with
decoupled pad steps, the pad leaf (J11 = 0, J12 = 0, J22 = I, h = 0,
c = -d/2 log 2 pi) appending an independent unit-Gaussian step whose
marginalization adds exactly zero to the running constant, so the real
steps' logZ, messages and moments are exact for any (T, C). The kernels
take any lane count: a lane is a warp (the scan), a thread (the adjoint's
factor pass) or a block (the adjoint's chain), so the JAX package's lane
pad to 128 has no counterpart.
"""

import math

import torch

from svae_tpu_torch.ops import _build, kalman
from svae_tpu_torch.ops.estep import (LOG2PI, _check_kernel_args, _forward,
                                      _launch, _vjp)
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import f32_linalg


def _nrows(d):
    return 3 * d * d + 2 * d + 1


def _nfac(d):
    """Rows of the adjoint's factor pass a combine: X, Y, W and v."""
    return 3 * d * d + d


def _dim(R):
    """The latent size d of an element of R = 3d^2 + 2d + 1 rows, or None."""
    d = (math.isqrt(max(12 * R - 8, 0)) - 2) // 6
    return d if d > 0 and _nrows(d) == R else None


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_shapes(name, leaves, *more):
    """``leaves`` (L, R, N) with R = 3d^2 + 2d + 1 and every tensor of
    ``more`` shaped alike. Returns ``(L, N, d)``."""
    if leaves.dim() != 3:
        raise ValueError(f"{name}: elements must be (L, R, N)")
    L, R, N = leaves.shape
    d = _dim(R)
    if (d is None or L < 1 or N < 1
            or any(t.shape != leaves.shape for t in more)):
        raise ValueError(f"{name}: inconsistent shapes")
    return L, N, d


def elem_scan(leaves):
    """Inclusive prefix scan of N independent chains of L packed elements:
    ``out[j] = combine(out[j-1], leaves[j])``, ``out[0] = leaves[0]``.
    ``leaves`` (L, R, N); returns (L, R, N)."""
    if leaves.device.type == "cpu":
        return elem_scan_plain(leaves)
    L, N, d = _check_shapes("elem_scan", leaves)
    _check_kernel_args("elem_scan", d, (leaves,))
    out = torch.empty_like(leaves)
    _launch("elem_scan", _build.load_library().svae_elem_scan_f32,
            leaves.device, d, L, N, leaves, out)
    elem_scan.launches += 1
    return out


elem_scan.launches = 0


def elem_scan_adj(leaves, pref, douts):
    """Adjoint of :func:`elem_scan`: its input ``leaves``, its output
    ``pref`` and the cotangent ``douts`` of that output, each (L, R, N) ->
    the cotangent of ``leaves``. On a card one C call runs the two passes
    of :func:`elem_scan_adj_factor` and :func:`elem_scan_adj_chain`."""
    if leaves.device.type == "cpu":
        return elem_scan_adj_plain(leaves, pref, douts)
    L, N, d = _check_shapes("elem_scan_adj", leaves, pref, douts)
    _check_kernel_args("elem_scan_adj", d, (leaves, pref, douts))
    dleaves = torch.empty_like(leaves)
    fac = torch.empty((L - 1, _nfac(d), N), dtype=leaves.dtype,
                      device=leaves.device)
    _launch("elem_scan_adj", _build.load_library().svae_elem_scan_adj_f32,
            leaves.device, d, L, N, leaves, pref, douts, dleaves, fac)
    elem_scan_adj.launches += 1
    return dleaves


elem_scan_adj.launches = 0


# The adjoint's passes one by one, for holding each kernel against its own
# plain version: elem_scan_adj = elem_scan_adj_chain(elem_scan_adj_factor(
# leaves, pref), douts). The chunked E-step calls elem_scan_adj, which
# launches the same kernels from one C call.


def elem_scan_adj_factor(leaves, pref):
    """Pass 1 of :func:`elem_scan_adj`, parallel over (step, lane): for
    every combine j >= 1 of every lane, with M = sym(J22 of ``pref[j-1]``
    + J11 of ``leaves[j]``) and W = M^-1, the products X = W J12a^T,
    Y = W J12b (J12a of ``pref[j-1]``, J12b of ``leaves[j]``), W and
    v = W (h2a + h1b), as ``fac`` (L-1, 3d^2 + d, N) = [X, Y, W (row-major),
    v], lane-minor. Arguments as :func:`elem_scan_adj`'s first two."""
    if leaves.device.type == "cpu":
        return elem_scan_adj_factor_plain(leaves, pref)
    L, N, d = _check_shapes("elem_scan_adj_factor", leaves, pref)
    _check_kernel_args("elem_scan_adj_factor", d, (leaves, pref))
    fac = torch.empty((L - 1, _nfac(d), N), dtype=leaves.dtype,
                      device=leaves.device)
    _launch("elem_scan_adj_factor",
            _build.load_library().svae_elem_scan_adj_factor_f32,
            leaves.device, d, L, N, leaves, pref, fac)
    elem_scan_adj_factor.launches += 1
    return fac


elem_scan_adj_factor.launches = 0


def elem_scan_adj_chain(fac, douts):
    """Pass 2 of :func:`elem_scan_adj`, serial in the steps: the carried
    cotangent walked back from j = L-1 to 0 through
    :func:`elem_scan_adj_factor`'s ``fac`` and the cotangents ``douts``
    (L, R, N). Returns the cotangent of the leaves, (L, R, N)."""
    if fac.device.type == "cpu":
        return elem_scan_adj_chain_plain(fac, douts)
    L, N, d = _check_shapes("elem_scan_adj_chain", douts)
    if fac.shape != (L - 1, _nfac(d), N):
        raise ValueError("elem_scan_adj_chain: inconsistent shapes")
    _check_kernel_args("elem_scan_adj_chain", d, (fac, douts))
    dleaves = torch.empty_like(douts)
    _launch("elem_scan_adj_chain",
            _build.load_library().svae_elem_scan_adj_chain_f32, douts.device,
            d, L, N, fac, douts, dleaves)
    elem_scan_adj_chain.launches += 1
    return dleaves


elem_scan_adj_chain.launches = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def elem_scan_plain(leaves):
    """Plain PyTorch twin of :func:`elem_scan` (same argument): a loop of
    ``kalman.combine`` over the L steps, batched over the N lanes."""
    elem_scan_plain.calls += 1
    tm = kalman._time_major(_unpack(leaves, _dim(leaves.shape[1])))
    return _pack(kalman._batch_major(kalman._seq_scan(tm, kalman.combine)),
                 leaves.shape[0])


elem_scan_plain.calls = 0


def elem_scan_adj_plain(leaves, pref, douts):
    """Plain version of :func:`elem_scan_adj` (same arguments, same
    output): the vector-Jacobian product of :func:`elem_scan_plain`
    (``pref`` is not read)."""
    elem_scan_adj_plain.calls += 1
    return _vjp(elem_scan_plain, (leaves,), (douts,))[0]


elem_scan_adj_plain.calls = 0


def _sym(X):
    return 0.5 * (X + X.mT)


def elem_scan_adj_factor_plain(leaves, pref):
    """Plain version of :func:`elem_scan_adj_factor` (same arguments, same
    output), batched over lanes and steps."""
    elem_scan_adj_factor_plain.calls += 1
    L, R, N = leaves.shape
    d = _dim(R)
    _, J12a, J22a, _, h2a, _ = _unpack(pref[:-1], d)
    J11b, J12b, _, h1b, _, _ = _unpack(leaves[1:], d)
    W = torch.cholesky_inverse(smallchol.chol(_sym(J22a) + _sym(J11b)))
    X = W @ J12a.mT
    Y = W @ J12b
    v = (W @ (h2a + h1b)[..., None])[..., 0]
    flat = lambda M: M.reshape(N, L - 1, d * d)
    fac = torch.cat([flat(X), flat(Y), flat(W), v], dim=-1)
    return fac.permute(1, 2, 0).contiguous()


elem_scan_adj_factor_plain.calls = 0


def elem_scan_adj_chain_plain(fac, douts):
    """Plain version of :func:`elem_scan_adj_chain` (same arguments, same
    output): the closed-form vector-Jacobian product of the combine (the
    form of pallas_chunked's ``_combine_vjp_rows``), one step at a time
    over all lanes."""
    elem_scan_adj_chain_plain.calls += 1
    L, R, N = douts.shape
    d = _dim(R)
    dd = d * d
    fac = fac.permute(2, 0, 1)                            # (N, L-1, F)
    X, Y, W = (fac[..., k * dd:(k + 1) * dd].reshape(N, L - 1, d, d)
               for k in range(3))
    v = fac[..., 3 * dd:]
    g_out = _unpack(douts, d)                             # (N, L, ...)
    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    mv = lambda M, x: (M @ x[..., None])[..., 0]
    carry = tuple(torch.zeros_like(a[:, 0]) for a in g_out)
    dleaves = [None] * L
    for j in reversed(range(1, L)):
        G11, G12, G22, g1, g2, gc = (c + a[:, j] for c, a in
                                     zip(carry, g_out))
        G11, G22 = _sym(G11), _sym(G22)
        Xj, Yj, Wj, vj = X[:, j - 1], Y[:, j - 1], W[:, j - 1], v[:, j - 1]
        db0 = gc[:, None] * vj - mv(Xj, g1) - mv(Yj, g2)
        Q1 = G11 @ Xj.mT + G12 @ Yj.mT + outer(g1, vj)
        Q2 = G22 @ Yj.mT + outer(g2, vj)
        dM = (_sym(Xj @ Q1 + Yj @ Q2)
              - 0.5 * gc[:, None, None] * (Wj + outer(vj, vj)))
        dJ12a = -(Q1 + G11 @ Xj.mT)
        dJ12b = -(Xj @ G12 + 2.0 * Yj @ G22 + outer(vj, g2))
        dleaves[j] = (dM, dJ12b, G22, db0, g2, gc)
        carry = (G11, dJ12a, dM, g1, db0, gc)
    dleaves[0] = tuple(c + a[:, 0] for c, a in zip(carry, g_out))
    stacked = tuple(torch.stack([e[k] for e in dleaves], 1)
                    for k in range(6))
    return _pack(stacked, L)


elem_scan_adj_chain_plain.calls = 0


class ElemScan(torch.autograd.Function):
    """:func:`elem_scan` with :func:`elem_scan_adj` as its backward (the
    JAX package's ``custom_vjp`` primitive)."""

    @staticmethod
    def forward(ctx, leaves):
        out = elem_scan(leaves)
        ctx.save_for_backward(leaves, out)
        return out

    @staticmethod
    def backward(ctx, douts):
        return elem_scan_adj(*ctx.saved_tensors, douts.contiguous())


def _scan_packed(packed):
    return _forward(elem_scan, elem_scan_plain, ElemScan, (packed,))


# --------------------------------------------------------------------------
# packing (torch ops)
# --------------------------------------------------------------------------


def _pad_leaf(d, dtype, device):
    """Decoupled unit-Gaussian pad step; its marginalization adds exactly
    zero to the running constant (module docstring)."""
    kw = dict(dtype=dtype, device=device)
    z = torch.zeros((d, d), **kw)
    return (z, z, torch.eye(d, **kw), torch.zeros(d, **kw),
            torch.zeros(d, **kw), torch.tensor(-0.5 * d * LOG2PI, **kw))


def _pack(tree, L):
    """Element tree with leading axes (N, L, ...) -> contiguous (L, R, N)."""
    N = tree[0].shape[0]
    return torch.cat([a.reshape(N, L, -1).permute(1, 2, 0) for a in tree],
                     1).contiguous()


def _unpack(arr, d):
    """(L, R, N) -> element tree with leading axes (N, L, ...)."""
    L, _, N = arr.shape
    shapes = [(d, d)] * 3 + [(d,)] * 2 + [()]
    parts = torch.split(arr, [d * d] * 3 + [d] * 2 + [1], dim=1)
    return tuple(p.permute(2, 0, 1).reshape((N, L) + s)
                 for p, s in zip(parts, shapes))


def _rev_elem(e):
    J11, J12, J22, h1, h2, c = e
    return (J22, J12.mT, J11, h2, h1, c)


def _flip1(tree):
    return tuple(a.flip(1) for a in tree)


def _scan_tree(tree):
    """Prefix scan of an element tree with leading axes (N, L, ...) along
    L, through the packed element scan."""
    return _unpack(_scan_packed(_pack(tree, tree[0].shape[1])),
                   tree[3].shape[-1])


def _suffix_tree(tree):
    """Suffix scan of the same: the prefix scan of the time-flipped,
    element-reversed tree, flipped and reversed back."""
    return _rev_elem(_flip1(_scan_tree(_flip1(_rev_elem(tree)))))


# --------------------------------------------------------------------------
# chunked scans and the E-step entries
# --------------------------------------------------------------------------


def _fold(leaves, C):
    """Cut the (B, T-1, ...) leaves into C chunks of L steps, the last one
    filled up with pad leaves, and fold the chunks onto the lanes: returns
    the (B*C, L, ...) tree, C and L (C at most T-1)."""
    B, T1 = leaves[0].shape[:2]
    C = max(1, min(int(C), T1))
    L = -(-T1 // C)
    npad = C * L - T1
    if npad:
        pad = _pad_leaf(leaves[3].shape[-1], leaves[0].dtype,
                        leaves[0].device)
        leaves = tuple(torch.cat([a, p.expand((B, npad) + a.shape[2:])], 1)
                       for a, p in zip(leaves, pad))
    return tuple(a.reshape((B * C, L) + a.shape[2:]) for a in leaves), C, L


def _chunk_scans(leaves, C):
    """Total element (B, ...), inclusive prefix and suffix (B, T-1, ...) of
    a batch of chains; ``leaves`` has leading axes (B, T-1)."""
    B, T1 = leaves[0].shape[:2]
    fold, C, L = _fold(leaves, C)
    pref_c = tuple(a.reshape((B, C, L) + a.shape[2:])
                   for a in _scan_tree(fold))
    suff_c = tuple(a.reshape((B, C, L) + a.shape[2:])
                   for a in _suffix_tree(fold))

    # the chunk totals, scanned over C steps on B lanes
    ends = tuple(a[:, :, -1] for a in pref_c)
    Pincl = _scan_tree(ends)
    Sincl = _suffix_tree(ends)
    total = tuple(a[:, -1] for a in Pincl)

    # seed every chunk with the running element before (after) it: one
    # batched combine each way
    if C > 1:
        Pprev = tuple(a[:, :-1, None].expand((B, C - 1, L) + a.shape[2:])
                      for a in Pincl)
        seeded_p = kalman.combine(Pprev, tuple(a[:, 1:] for a in pref_c))
        pref_c = tuple(torch.cat([a[:, :1], s], 1)
                       for a, s in zip(pref_c, seeded_p))
        Snext = tuple(a[:, 1:, None].expand((B, C - 1, L) + a.shape[2:])
                      for a in Sincl)
        seeded_s = kalman.combine(tuple(a[:, :-1] for a in suff_c), Snext)
        suff_c = tuple(torch.cat([s, a[:, -1:]], 1)
                       for a, s in zip(suff_c, seeded_s))
    prefix = tuple(a.reshape((B, C * L) + a.shape[3:])[:, :T1]
                   for a in pref_c)
    suffix = tuple(a.reshape((B, C * L) + a.shape[3:])[:, :T1]
                   for a in suff_c)
    return total, prefix, suffix


def _smoother_core(init, pairs, nodes, chunks):
    leaves = kalman.build_leaves(init, pairs, nodes)
    total, prefix, suffix = _chunk_scans(leaves, chunks)
    return kalman.assemble_moments(init, pairs, nodes, total, prefix, suffix)


@f32_linalg()
def lds_smoother(init, pairs, nodes, chunks=8):
    """Chunked smoother: ``(logZ (B,), Ex (B, T, d), ExxT (B, T, d, d),
    Exnxt (B, T-1, d, d))``. ``init`` = (I1, I2, Ic); ``pairs`` shared
    (T-1, ...) or per sequence (B, T-1, ...); ``nodes`` = (N1 (B, T, d, d),
    N2 (B, T, d))."""
    return _smoother_core(init, pairs, nodes, chunks)[:4]


@f32_linalg()
def lds_estep(init, pairs, nodes, generator, num_samples, chunks=8,
              eps=None):
    """Chunked fused E-step: ``(samples (S, B, T, d), (Ex, ExxT, Exnxt),
    logZ (B,))``. The sampler's affine suffix composition runs the chunked
    scan of :mod:`~svae_tpu_torch.ops.kalman` in torch ops on the filtered
    messages of the element scans. ``generator`` draws the noise unless
    ``eps`` (S, B, T, d) gives it."""
    logZ, Ex, ExxT, Exnxt, Jf, hf = _smoother_core(init, pairs, nodes,
                                                   chunks)
    samples = kalman.lds_sample(init, pairs, nodes, generator, num_samples,
                                parallel=int(chunks), filtered=(Jf, hf),
                                eps=eps)
    return samples, (Ex, ExxT, Exnxt), logZ
