"""Time-axis sharding of the Gaussian chain across ranks, the PGM analogue
of context parallelism (port of svae_tpu/parallel/time_shard.py).

The chain's T-1 leaf elements are split into C contiguous chunks, one a
rank of a process group. Inference is the blocked two-pass algorithm
(the distributed form of ``ops/kalman._chunked_scan``; temporal
parallelization per arXiv:1905.13002):

  pass 1   each rank combines its local leaves in sequence (depth T/C),
           keeping every local prefix and suffix;
  exchange ONE ``all_gather`` of the C chunk elements (an element is
           3 d^2 + 2 d + 1 numbers a sequence: the boundary messages);
  reduce   every rank reduces the C gathered elements (depth C,
           replicated work);
  pass 2   every rank seeds its local scans with its global prefix and
           suffix in ONE batched combine and assembles its local smoothed
           moments;

and one more ``all_gather`` assembles the full ``(T, ...)`` moments on
every rank, as the JAX package's ``out_specs=P(axis)`` does.

Layout contract: T = C * L. The T-1 pairs are padded with one leading
dummy leaf so that leaves and nodes split evenly: rank c owns nodes
[cL, cL+L) and padded leaf rows [cL, cL+L), where row j is global pair
cL+j-1. In the JAX package every device runs one SPMD program, so rank
0's row 0, the dummy, is masked out of the combines; here each rank runs
its own program and rank 0 starts its scans at row 1. Cross-boundary
messages come from the replicated chunk reductions, so no rank sends to a
neighbour.
"""

import torch
import torch.distributed as dist

from svae_tpu_torch.ops import kalman
from svae_tpu_torch.parallel.mesh import Mesh
from svae_tpu_torch.utils.psd import (f32_linalg, inv_psd, solve_psd,
                                      symmetrize)


def build_padded_leaves(init, pairs, nodes):
    """The (B, T-1, ...) leaves of ``kalman.build_leaves`` -> (B, T, ...)
    with a leading dummy row (row k is global leaf k-1). The dummy, a
    benign finite element, takes part in no combine."""
    leaves = kalman.build_leaves(init, pairs, nodes)
    B, _, d = nodes[1].shape
    N2 = nodes[1]
    eye = torch.eye(d, dtype=N2.dtype, device=N2.device).expand(B, 1, d, d)
    vec = N2.new_zeros(B, 1, d)
    dummy = (eye, 0.0 * eye, eye, vec, vec, N2.new_zeros(B, 1))
    return tuple(torch.cat([dm, a], 1) for dm, a in zip(dummy, leaves))


def _stack(rows):
    return tuple(torch.stack(x) for x in zip(*rows))


def _row(tree, j):
    return tuple(a[j] for a in tree)


def _local_scans(loc, lo):
    """Inclusive prefix and suffix of the time-major rows ``loc[lo:]``
    (rows before ``lo`` keep their raw values in the prefix and the suffix
    of row ``lo`` in the suffix: none of them is read)."""
    L = loc[0].shape[0]
    pre = [_row(loc, j) for j in range(lo + 1)]
    for j in range(lo + 1, L):
        pre.append(kalman.combine(pre[-1], _row(loc, j)))
    suf = [_row(loc, L - 1)]
    for j in range(L - 2, lo - 1, -1):
        suf.append(kalman.combine(_row(loc, j), suf[-1]))
    suf = suf[::-1]
    return _stack(pre), _stack([suf[0]] * lo + suf)


def _gather_elements(e, group, C):
    """All-gather one element (six fields, leading axis B) from each of
    the C ranks: one collective. Returns the C elements in rank order."""
    B = e[0].shape[0]
    sizes = [a[0].numel() for a in e]
    buf = torch.cat([a.reshape(B, -1) for a in e], 1).contiguous()
    out = [torch.empty_like(buf) for _ in range(C)]
    dist.all_gather(out, buf, group=group)
    return [tuple(x.reshape(a.shape) for x, a in
                  zip(o.split(sizes, 1), e)) for o in out]


def _expand(e, L):
    return tuple(a.expand((L,) + a.shape) for a in e)


@f32_linalg()
def lds_smoother_timeshard(init, pairs, nodes, mesh_or_group=None,
                           axis="data"):
    """Time-sharded two-filter smoother over a group of C ranks: the
    outputs of ``kalman.lds_smoother`` for the same inputs, ``(logZ (B,),
    Ex (B, T, d), ExxT (B, T, d, d), Exnxt (B, T-1, d, d))`` on every rank,
    with the time axis split over the group and two ``all_gather``s as the
    only collectives (the chunk elements, then the moments). Each rank is
    given the full inputs (``nodes`` (B, T, ...), ``pairs`` shared or per
    sequence) and works on its own T/C rows. ``mesh_or_group``: a
    :class:`~svae_tpu_torch.parallel.mesh.Mesh` (its group over ``axis``),
    a process group, or ``None`` for the default group. Requires T
    divisible by C and T >= 2C."""
    group = mesh_or_group
    if isinstance(group, Mesh):
        group = group.groups[axis]
    elif group is None:
        group = dist.group.WORLD
    C, c = dist.get_world_size(group), dist.get_rank(group)
    N1, N2 = nodes
    B, T, d = N2.shape
    if T % C:
        raise ValueError(f"T={T} not divisible by time-axis size {C}")
    L = T // C
    if L < 2:
        raise ValueError(f"need T >= 2*{C} (device 0 holds the pad row)")
    rows = slice(c * L, (c + 1) * L)
    lo = 1 if c == 0 else 0   # rank 0's row 0 is the dummy
    loc = tuple(a[:, rows].movedim(1, 0)
                for a in build_padded_leaves(init, pairs, nodes))

    # ---- pass 1: local prefix and suffix scans ----
    local_prefix, local_suffix = _local_scans(loc, lo)

    # ---- exchange + replicated chunk reductions ----
    E_all = _gather_elements(_row(local_prefix, L - 1), group, C)
    Pincl = [E_all[0]]                      # Pincl[k] = E_0 .. E_k
    for k in range(1, C):
        Pincl.append(kalman.combine(Pincl[-1], E_all[k]))
    Sincl = [E_all[-1]]                     # Sincl[k] = E_k .. E_{C-1}
    for k in range(C - 2, -1, -1):
        Sincl.insert(0, kalman.combine(E_all[k], Sincl[0]))

    # ---- pass 2: seed the local scans with the global prefix / suffix ----
    g_prefix = (kalman.combine(_expand(Pincl[c - 1], L), local_prefix)
                if c > 0 else local_prefix)
    g_suffix = (kalman.combine(local_suffix, _expand(Sincl[c + 1], L))
                if c < C - 1 else local_suffix)

    # filtered alpha at nodes [cL, cL+L); node 0's is init + node 0
    Jf, hf, _ = kalman.marginalize_first(g_prefix)
    if c == 0:
        Jf = torch.cat([(-2.0 * (init[0] + N1[:, 0]))[None], Jf[1:]])
        hf = torch.cat([(init[1] + N2[:, 0])[None], hf[1:]])

    # beta at nodes [cL, cL+L): row j of g_suffix is beta at node cL+j-1,
    # so shift by one and take the last node's from the next chunk's
    # suffix (zero at node T-1); node 0's also holds init + node 0, which
    # leaf 0 owns: strip them
    Jb, hb, _ = kalman.marginalize_last(g_suffix)
    if c < C - 1:
        JbS, hbS, _ = kalman.marginalize_last(Sincl[c + 1])
    else:
        JbS, hbS = torch.zeros_like(Jb[0]), torch.zeros_like(hb[0])
    Jb = torch.cat([Jb[1:], JbS[None]])
    hb = torch.cat([hb[1:], hbS[None]])
    if c == 0:
        Jb = torch.cat([(Jb[0] - Jf[0])[None], Jb[1:]])
        hb = torch.cat([(hb[0] - hf[0])[None], hb[1:]])

    # ---- node moments ----
    Sig = inv_psd(Jf + Jb)
    Ex = (Sig @ (hf + hb)[..., None])[..., 0]
    ExxT = symmetrize(Sig + Ex[..., :, None] * Ex[..., None, :])

    # ---- pair moments of rows lo..L-1: row j is pair (cL+j-1, cL+j) ----
    # alpha and Ex at node cL-1 (row 0) come from the replicated boundary
    # messages: alpha from Pincl[c-1], beta from Sincl[c]
    Jf_t, Ex_t = Jf[:-1], Ex[:-1]
    if c > 0:
        Ja, ha, _ = kalman.marginalize_first(Pincl[c - 1])
        JbP, hbP, _ = kalman.marginalize_last(Sincl[c])
        ExP = (inv_psd(Ja + JbP) @ (ha + hbP)[..., None])[..., 0]
        Jf_t = torch.cat([Ja[None], Jf_t])
        Ex_t = torch.cat([ExP[None], Ex_t])

    def pair_rows(P):
        # pair cL+j-1 for rows lo..L-1, time-major; shared (T-1, d, d)
        # pairs broadcast over the batch
        p = slice(c * L + lo - 1, (c + 1) * L - 1)
        return P[p][:, None] if P.dim() == 3 else P[:, p].movedim(1, 0)

    P1, P2, P3, _ = pairs
    J12l = -pair_rows(P2).mT
    J11 = -2.0 * pair_rows(P3) + Jf_t
    J22 = -2.0 * (pair_rows(P1) + N1[:, c * L + lo:(c + 1) * L]
                  .movedim(1, 0)) + Jb[lo:]
    J11inv_J12 = solve_psd(J11, J12l.expand(J11.shape))
    S = J22 - J12l.mT @ J11inv_J12
    Cov12 = -J11inv_J12 @ inv_psd(S)
    Exnxt = Cov12 + Ex_t[..., :, None] * Ex[lo:, :, None, :]
    if lo:
        Exnxt = torch.cat([torch.zeros_like(Exnxt[:1]), Exnxt])

    # ---- the full moments on every rank: one all_gather ----
    parts = (Ex, ExxT, Exnxt)
    buf = torch.cat([a.reshape(L, B, -1) for a in parts], -1).contiguous()
    out = [torch.empty_like(buf) for _ in range(C)]
    dist.all_gather(out, buf, group=group)
    full = torch.cat(out).split([d, d * d, d * d], -1)
    Ex, ExxT, Exnxt = (a.reshape((T, B) + p.shape[2:]).movedim(0, 1)
                       for a, p in zip(full, parts))
    logZ = kalman._gauss_logZ_info(*kalman.marginalize_first(Pincl[-1]))
    return logZ, Ex, ExxT, Exnxt[:, 1:]
