"""LDS E-step on per-sequence ("bpairs") pair potentials (port of
svae_tpu/ops/pallas_bidir.py and of the per-sequence half of
svae_tpu/ops/pallas_vjp.py).

Ragged batches give every sequence its own pair potentials: pad
transitions carry the normalized N(0, I) dummy (models/lds.py), so the
pairs stream per step and per sequence instead of sitting still as in
:mod:`svae_tpu_torch.ops.estep`. Two recursions carry the E-step:

* :func:`bidir_fwd` runs ONE generic information-filter step over every
  lane,

      M = J + A_t,  J' = C_t - D_t M^-1 D_t^T,
      h' = D_t M^-1 (h + f_t) + e_t,
      ln += d/2 log 2pi - 1/2 log|M| + 1/2 (h+f)^T M^-1 (h+f) + pc_t,

  with the forward filter of sequence b on lane b and its time-reversed
  backward filter on lane B + b: the backward streams are the forward ones
  flipped in time with (A, C) and (e, f) swapped and D transposed
  (:func:`bidir_inputs` packs them);
* :func:`sampler_bp_fwd` draws the S samples backward in time from the
  forward filter's messages, on lane ``s*B + b``; on a card as two
  kernels from one C call, a pass over every (step, sequence) for the
  step's matrix and offsets (:func:`sampler_bp_fwd_factor`) and the
  serial chain of the samples (:func:`sampler_bp_fwd_chain`).

:func:`bidir_adj` and :func:`sampler_bp_adj` are their adjoints, the
backward of :class:`BidirFwd` and :class:`SamplerBp`. On a card
:func:`bidir_adj` runs as two kernels from one C call, a pass over every
(step, lane) for the step's inverse (:func:`bidir_adj_factor`) and the
serial chain of the carried cotangents (:func:`bidir_adj_chain`);
:func:`sampler_bp_adj` as three, a pass over every (step, sequence) for
the step's inverse (:func:`sampler_bp_adj_factor`), the serial chain of
the sample cotangents (:func:`sampler_bp_adj_chain`) and a pass over every
(step, sequence) that sums the cotangents of the pairs and messages over
the samples (:func:`sampler_bp_adj_dJc`). Each pass has a plain version of
its own. The lanes are
independent chains, so :func:`lds_filter` and :func:`lds_backward` (the
counterparts of pallas_vjp's) run one direction's B lanes alone. Each of
the four is a CUDA kernel (``csrc/bpairs.cu``, ``csrc/bidir_adj.cu``,
``csrc/sampler_bp_adj.cu``) for tensors on a card and a plain PyTorch
version (``*_plain``) for tensors on the CPU, with the launch counters and
the no-fallback rule of :mod:`~svae_tpu_torch.ops.estep`: the forward
twins step batched ``torch.linalg`` ops over the lanes, the plain adjoints
are ``torch.autograd``'s vector-Jacobian products of the twins.

Streams keep the JAX package's packed layout with the lane innermost
((T-1, d*d, lanes) and (T-1, d, lanes)), without its 128-lane padding: on
the card a lane is a warp in ``bidir_fwd``, a block in the samplers'
chains and a thread elsewhere. The packing, the smoothed-moment assembly
(estep.smoother_assembly, shared with the stationary E-step) and the
terminal sample are batched torch ops, differentiable by autograd.
"""

import math

import torch

from svae_tpu_torch.ops import _build
from svae_tpu_torch.ops.estep import (LOG2PI, _check_kernel_args, _forward,
                                      _lane_minor, _launch, _next_samples,
                                      _vjp, filter_adj_chain_step,
                                      sampler_dJc, smoother_assembly)
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import mvn_logZ_info, symmetrize


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_bidir_shapes(name, J0, h0, A, C, D, E, F, Pc, *outs):
    """Shapes of :func:`bidir_fwd`'s inputs and, for the adjoint, of its
    outputs and their cotangents ``(J, h, dJ, dh, dln)``."""
    T1, dd, NL = A.shape
    d = h0.shape[0]
    want = ([(dd, NL), (d, NL)] + [(T1, dd, NL)] * 3 + [(T1, d, NL)] * 2
            + [(T1, NL)])
    if outs:
        want += [(T1, dd, NL), (T1, d, NL)] * 2 + [(NL,)]
    if (T1 < 1 or dd != d * d or [tuple(t.shape) for t in
                                  (J0, h0, A, C, D, E, F, Pc, *outs)] != want):
        raise ValueError(f"{name}: inconsistent shapes")


def _check_sampler_shapes(name, P2, P3, Jf, hf, eps, xT, *outs):
    """Shapes of :func:`sampler_bp_fwd`'s inputs and, for the adjoint, of
    its output and its cotangent ``(x, dx)``."""
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    want = ([(T1, dd, B)] * 3 + [(T1, d, B), (T1, d, SB), (d, SB)]
            + [(T1, d, SB)] * len(outs))
    if (T1 < 1 or dd != d * d or SB % B
            or [tuple(t.shape) for t in (P2, P3, Jf, hf, eps, xT, *outs)]
            != want):
        raise ValueError(f"{name}: inconsistent shapes")


def bidir_fwd(J0, h0, A, C, D, E, F, Pc):
    """The generic information filter over NL independent lanes.

    ``J0`` (d*d, NL), ``h0`` (d, NL): initial messages. Per stream row t
    and lane: ``A``, ``C``, ``D`` (T-1, d*d, NL) the offset added to the
    carried message (lower triangle read), the next message's offset and
    the coupling block, ``E``, ``F`` (T-1, d, NL) the evidence added after
    and before the step, ``Pc`` (T-1, NL) the log-normalizer offset.
    Returns per row ``J`` (T-1, d*d, NL), ``h`` (T-1, d, NL) and the summed
    log-normalizer ``ln`` (NL,)."""
    if J0.device.type == "cpu":
        return bidir_fwd_plain(J0, h0, A, C, D, E, F, Pc)
    args = (J0, h0, A, C, D, E, F, Pc)
    _check_bidir_shapes("bidir_fwd", *args)
    T1, dd, NL = A.shape
    d = h0.shape[0]
    _check_kernel_args("bidir_fwd", d, args)
    kw = dict(dtype=J0.dtype, device=J0.device)
    J = torch.empty((T1, dd, NL), **kw)
    h = torch.empty((T1, d, NL), **kw)
    ln = torch.empty((NL,), **kw)
    lib = _build.load_library()
    _launch("bidir_fwd", lib.svae_bidir_fwd_f32, J0.device, d, NL, T1, *args,
            J, h, ln)
    bidir_fwd.launches += 1
    return J, h, ln


bidir_fwd.launches = 0


def bidir_adj(J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln):
    """Adjoint of :func:`bidir_fwd`: its inputs, its outputs ``J``, ``h``
    and their cotangents ``dJ``, ``dh``, ``dln`` -> the cotangents of its
    inputs ``(dJ0, dh0, dA, dC, dD, dE, dF, dPc)``, shaped as the inputs.
    On a card one C call runs the two passes of :func:`bidir_adj_factor`
    and :func:`bidir_adj_chain`."""
    if J0.device.type == "cpu":
        return bidir_adj_plain(J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln)
    args = (J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln)
    _check_bidir_shapes("bidir_adj", *args)
    T1, dd, NL = A.shape
    d = h0.shape[0]
    _check_kernel_args("bidir_adj", d, args)
    kw = dict(dtype=A.dtype, device=A.device)
    fac = torch.empty((T1, 2 * dd + d, NL), **kw)
    outs = _bidir_adj_outputs(T1, d, NL, **kw)
    lib = _build.load_library()
    _launch("bidir_adj", lib.svae_bidir_adj_f32, J0.device, d, NL, T1, J0,
            h0, A, D, F, J, h, dJ, dh, dln, fac, *outs)
    bidir_adj.launches += 1
    dA, dC, dD, dE, dF, dJ0, dh0 = outs
    return dJ0, dh0, dA, dC, dD, dE, dF, dln.expand(T1, NL)


bidir_adj.launches = 0


# The adjoint's passes one by one, for holding each kernel against its own
# plain version: bidir_adj = bidir_adj_chain(bidir_adj_factor(...), ...)
# and the cotangent of Pc, which is dln on every step. The model paths
# call bidir_adj, which launches the same kernels from one C call.


def _bidir_adj_outputs(T1, d, NL, **kw):
    """Empty outputs of the chain pass: ``(dA, dC, dD, dE, dF, dJ0,
    dh0)``."""
    mats = [torch.empty((T1, d * d, NL), **kw) for _ in range(3)]
    vecs = [torch.empty((T1, d, NL), **kw) for _ in range(2)]
    return (*mats, *vecs, torch.empty((d * d, NL), **kw),
            torch.empty((d, NL), **kw))


def bidir_adj_factor(J0, h0, A, C, D, E, F, Pc, J, h):
    """Pass 1 of :func:`bidir_adj`, parallel over (step, lane): per step t
    of every lane the inverse W of M = J_pre + A_t (J_pre = ``J0`` at t = 0,
    ``J[t-1]`` after), K = W D_t^T and w = W (h_pre + f_t), as ``fac``
    (T-1, 2d^2 + d, NL) = [W, K (row-major), w], lane-minor. Arguments as
    :func:`bidir_adj`'s first ten (``C``, ``E`` and ``Pc`` are not
    read)."""
    if J0.device.type == "cpu":
        return bidir_adj_factor_plain(J0, h0, A, C, D, E, F, Pc, J, h)
    args = (J0, h0, A, C, D, E, F, Pc)
    _check_bidir_shapes("bidir_adj_factor", *args)
    T1, dd, NL = A.shape
    d = h0.shape[0]
    if J.shape != (T1, dd, NL) or h.shape != (T1, d, NL):
        raise ValueError("bidir_adj_factor: inconsistent shapes")
    _check_kernel_args("bidir_adj_factor", d, args + (J, h))
    fac = torch.empty((T1, 2 * dd + d, NL), dtype=A.dtype, device=A.device)
    _launch("bidir_adj_factor", _build.load_library().svae_bidir_adj_factor_f32,
            J0.device, d, NL, T1, J0, h0, A, D, F, J, h, fac)
    bidir_adj_factor.launches += 1
    return fac


bidir_adj_factor.launches = 0


def bidir_adj_chain(fac, dJ, dh, dln):
    """Pass 2 of :func:`bidir_adj`, serial in the steps: the carried
    cotangents walked back through the steps from
    :func:`bidir_adj_factor`'s ``fac`` and the cotangents ``dJ``, ``dh``,
    ``dln``. Returns ``(dJ0, dh0, dA, dC, dD, dE, dF)``, :func:`bidir_adj`'s
    outputs but the last."""
    if fac.device.type == "cpu":
        return bidir_adj_chain_plain(fac, dJ, dh, dln)
    T1, R, NL = fac.shape
    d = dh.shape[1] if dh.dim() == 3 else 0
    if (R != 2 * d * d + d or dJ.shape != (T1, d * d, NL)
            or dh.shape != (T1, d, NL) or dln.shape != (NL,)):
        raise ValueError("bidir_adj_chain: inconsistent shapes")
    args = (fac, dJ, dh, dln)
    _check_kernel_args("bidir_adj_chain", d, args)
    outs = _bidir_adj_outputs(T1, d, NL, dtype=fac.dtype, device=fac.device)
    _launch("bidir_adj_chain", _build.load_library().svae_bidir_adj_chain_f32,
            fac.device, d, NL, T1, *args, *outs)
    bidir_adj_chain.launches += 1
    dA, dC, dD, dE, dF, dJ0, dh0 = outs
    return dJ0, dh0, dA, dC, dD, dE, dF


bidir_adj_chain.launches = 0


def sampler_bp_fwd(P2, P3, Jf, hf, eps, xT):
    """Backward conditional sampler for S*B chains (lane ``s*B + b``) on
    per-sequence pairs.

    ``P2``, ``P3`` (T-1, d*d, B): the pair blocks of transitions 0..T-2.
    ``Jf`` (T-1, d*d, B) and ``hf`` (T-1, d, B): forward-filter messages of
    frames 0..T-2. All four are shared by the S samples of a sequence.
    ``eps`` (T-1, d, S*B): standard normal noise; ``xT`` (d, S*B): the
    terminal samples. Returns ``x`` (T-1, d, S*B), frames 0..T-2. On a
    card one C call runs the two passes of :func:`sampler_bp_fwd_factor`
    and :func:`sampler_bp_fwd_chain`."""
    if P2.device.type == "cpu":
        return sampler_bp_fwd_plain(P2, P3, Jf, hf, eps, xT)
    args = (P2, P3, Jf, hf, eps, xT)
    _check_sampler_shapes("sampler_bp_fwd", *args)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    _check_kernel_args("sampler_bp_fwd", d, args)
    kw = dict(dtype=xT.dtype, device=xT.device)
    Q = torch.empty((T1, dd, B), **kw)
    c = torch.empty((T1, d, SB), **kw)
    x = torch.empty_like(eps)
    lib = _build.load_library()
    _launch("sampler_bp_fwd", lib.svae_sampler_bp_fwd_f32, xT.device, d, B,
            SB // B, T1, *args, Q, c, x)
    sampler_bp_fwd.launches += 1
    return x


sampler_bp_fwd.launches = 0


# The sampler's passes one by one, for holding each kernel against its own
# plain version: x_t = c_t + Q_t x_{t+1} with Q_t = W_t P2_t^T, W_t =
# Jc_t^-1 and c_t = W_t hf_t + L_t^-T eps_t (L_t = chol(Jc_t), Jc_t = Jf_t -
# 2 P3_t), the first carry-free, the second the serial chain:
# sampler_bp_fwd = sampler_bp_fwd_chain(*sampler_bp_fwd_factor(P2, P3, Jf,
# hf, eps), xT). The model paths call sampler_bp_fwd, which launches the
# same kernels from one C call.


def sampler_bp_fwd_factor(P2, P3, Jf, hf, eps):
    """Pass 1 of :func:`sampler_bp_fwd`, parallel over (step, sequence):
    ``Q`` (T-1, d*d, B) = W_t P2_t^T per sequence, shared by its S samples,
    in ``Jf``'s layout, and ``c`` (T-1, d, S*B) = W_t hf_t + L_t^-T eps_t per
    lane. Arguments as :func:`sampler_bp_fwd`'s first five."""
    if P2.device.type == "cpu":
        return sampler_bp_fwd_factor_plain(P2, P3, Jf, hf, eps)
    T1, dd, B = Jf.shape
    d, SB = (hf.shape[1], eps.shape[2]) if eps.dim() == 3 else (0, 0)
    if (T1 < 1 or dd != d * d or SB % B or P2.shape != Jf.shape
            or P3.shape != Jf.shape or hf.shape != (T1, d, B)
            or eps.shape != (T1, d, SB)):
        raise ValueError("sampler_bp_fwd_factor: inconsistent shapes")
    args = (P2, P3, Jf, hf, eps)
    _check_kernel_args("sampler_bp_fwd_factor", d, args)
    kw = dict(dtype=Jf.dtype, device=Jf.device)
    Q = torch.empty((T1, dd, B), **kw)
    c = torch.empty((T1, d, SB), **kw)
    _launch("sampler_bp_fwd_factor",
            _build.load_library().svae_sampler_bp_fwd_factor_f32, Jf.device,
            d, B, SB // B, T1, *args, Q, c)
    sampler_bp_fwd_factor.launches += 1
    return Q, c


sampler_bp_fwd_factor.launches = 0


def sampler_bp_fwd_chain(Q, c, xT):
    """Pass 2 of :func:`sampler_bp_fwd`, serial in time: per sample chain
    x_t = c_t + Q_t x_{t+1} from the terminal ``xT`` (d, S*B) and
    :func:`sampler_bp_fwd_factor`'s ``Q``, ``c``. Returns ``x`` (T-1, d,
    S*B)."""
    if Q.device.type == "cpu":
        return sampler_bp_fwd_chain_plain(Q, c, xT)
    T1, dd, B = Q.shape
    d, SB = xT.shape if xT.dim() == 2 else (0, 0)
    if T1 < 1 or dd != d * d or SB % B or c.shape != (T1, d, SB):
        raise ValueError("sampler_bp_fwd_chain: inconsistent shapes")
    args = (Q, c, xT)
    _check_kernel_args("sampler_bp_fwd_chain", d, args)
    x = torch.empty((T1, d, SB), dtype=xT.dtype, device=xT.device)
    _launch("sampler_bp_fwd_chain",
            _build.load_library().svae_sampler_bp_fwd_chain_f32, Q.device, d,
            B, SB // B, T1, *args, x)
    sampler_bp_fwd_chain.launches += 1
    return x


sampler_bp_fwd_chain.launches = 0


def _sampler_adj_outputs(T1, d, B, **kw):
    """Empty outputs of the dJc pass: ``(dP2, dP3, dJf (T-1, d*d, B), dhf
    (T-1, d, B))``, summed over the S samples of a sequence."""
    return (*(torch.empty((T1, d * d, B), **kw) for _ in range(3)),
            torch.empty((T1, d, B), **kw))


def sampler_bp_adj(P2, P3, Jf, hf, eps, xT, x, dx):
    """Adjoint of :func:`sampler_bp_fwd`: its inputs, its output ``x`` and
    the cotangent ``dx`` -> the cotangents ``(dP2, dP3, dJf, dhf, dxT)`` of
    its inputs other than the noise, which has none. On a card one C call
    runs the three passes of :func:`sampler_bp_adj_factor`,
    :func:`sampler_bp_adj_chain` and :func:`sampler_bp_adj_dJc`."""
    if P2.device.type == "cpu":
        return sampler_bp_adj_plain(P2, P3, Jf, hf, eps, xT, x, dx)
    args = (P2, P3, Jf, hf, eps, xT, x, dx)
    _check_sampler_shapes("sampler_bp_adj", *args)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    _check_kernel_args("sampler_bp_adj", d, args)
    kw = dict(dtype=xT.dtype, device=xT.device)
    W = torch.empty((T1, dd, B), **kw)
    bbar = torch.empty((T1, d, SB), **kw)
    outs = _sampler_adj_outputs(T1, d, B, **kw)
    dxT = torch.empty((d, SB), **kw)
    lib = _build.load_library()
    _launch("sampler_bp_adj", lib.svae_sampler_bp_adj_f32, xT.device, d, B,
            SB // B, T1, *args, W, bbar, *outs, dxT)
    sampler_bp_adj.launches += 1
    return (*outs, dxT)


sampler_bp_adj.launches = 0


# The sampler adjoint's passes one by one, for holding each kernel against
# its own plain version: sampler_bp_adj = sampler_bp_adj_dJc(...,
# sampler_bp_adj_chain(sampler_bp_adj_factor(P3, Jf), P2, dx)[0]) and the
# chain's dxT. The model paths call sampler_bp_adj, which launches the
# same kernels from one C call.


def sampler_bp_adj_factor(P3, Jf):
    """Pass 1 of :func:`sampler_bp_adj`, parallel over (step, sequence):
    ``W`` (T-1, d*d, B), the inverse of Jc_t = Jf_t - 2 P3_t (lower
    triangles read) per sequence, shared by its S samples, in ``Jf``'s
    layout. ``P3``, ``Jf`` (T-1, d*d, B)."""
    if P3.device.type == "cpu":
        return sampler_bp_adj_factor_plain(P3, Jf)
    T1, dd, B = Jf.shape
    d = math.isqrt(dd)
    if T1 < 1 or d * d != dd or P3.shape != Jf.shape:
        raise ValueError("sampler_bp_adj_factor: inconsistent shapes")
    _check_kernel_args("sampler_bp_adj_factor", d, (P3, Jf))
    W = torch.empty((T1, dd, B), dtype=Jf.dtype, device=Jf.device)
    _launch("sampler_bp_adj_factor",
            _build.load_library().svae_sampler_bp_adj_factor_f32, Jf.device,
            d, B, T1, P3, Jf, W)
    sampler_bp_adj_factor.launches += 1
    return W


sampler_bp_adj_factor.launches = 0


def sampler_bp_adj_chain(W, P2, dx):
    """Pass 2 of :func:`sampler_bp_adj`, serial in the steps: per sample
    chain b-bar_t = W_t (x-bar_t + dx_t), x-bar_{t+1} = P2_t b-bar_t from
    :func:`sampler_bp_adj_factor`'s ``W``. Returns ``(bbar (T-1, d, S*B),
    dxT (d, S*B))``."""
    if W.device.type == "cpu":
        return sampler_bp_adj_chain_plain(W, P2, dx)
    T1, dd, B = W.shape
    d, SB = dx.shape[1:] if dx.dim() == 3 else (0, 0)
    if (dd != d * d or SB % B or P2.shape != W.shape
            or dx.shape != (T1, d, SB)):
        raise ValueError("sampler_bp_adj_chain: inconsistent shapes")
    args = (W, P2, dx)
    _check_kernel_args("sampler_bp_adj_chain", d, args)
    kw = dict(dtype=W.dtype, device=W.device)
    bbar = torch.empty((T1, d, SB), **kw)
    dxT = torch.empty((d, SB), **kw)
    _launch("sampler_bp_adj_chain",
            _build.load_library().svae_sampler_bp_adj_chain_f32, W.device, d,
            B, SB // B, T1, *args, bbar, dxT)
    sampler_bp_adj_chain.launches += 1
    return bbar, dxT


sampler_bp_adj_chain.launches = 0


def sampler_bp_adj_dJc(P2, P3, Jf, hf, eps, xT, x, bbar):
    """Pass 3 of :func:`sampler_bp_adj`, parallel over (step, sequence):
    from :func:`sampler_bp_adj_chain`'s ``bbar`` and the sampler's inputs
    and output (arguments as :func:`sampler_bp_adj`'s first seven), the
    cotangents ``(dP2, dP3, dJf, dhf)`` of the pairs and messages, summed
    over the S samples of each sequence."""
    if P2.device.type == "cpu":
        return sampler_bp_adj_dJc_plain(P2, P3, Jf, hf, eps, xT, x, bbar)
    args = (P2, P3, Jf, hf, eps, xT, x, bbar)
    _check_sampler_shapes("sampler_bp_adj_dJc", *args)
    T1, _, B = Jf.shape
    d, SB = xT.shape
    _check_kernel_args("sampler_bp_adj_dJc", d, args)
    outs = _sampler_adj_outputs(T1, d, B, dtype=Jf.dtype, device=Jf.device)
    _launch("sampler_bp_adj_dJc",
            _build.load_library().svae_sampler_bp_adj_dJc_f32, Jf.device, d,
            B, SB // B, T1, *args, *outs)
    sampler_bp_adj_dJc.launches += 1
    return outs


sampler_bp_adj_dJc.launches = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _mats(x, d):
    """(T-1, d*d, L) stream -> (T-1, L, d, d)."""
    return x.permute(0, 2, 1).reshape(x.shape[0], x.shape[2], d, d)


def bidir_fwd_plain(J0, h0, A, C, D, E, F, Pc):
    """Plain PyTorch twin of :func:`bidir_fwd` (same arguments)."""
    bidir_fwd_plain.calls += 1
    T1, dd, NL = A.shape
    d = h0.shape[0]
    Am, Cm, Dm = _mats(A, d), _mats(C, d), _mats(D, d)
    Ev, Fv = E.permute(0, 2, 1), F.permute(0, 2, 1)
    J = J0.T.reshape(NL, d, d)
    h = h0.T
    ln = Pc.sum(0)
    Js, hs = [], []
    for t in range(T1):
        L = smallchol.chol(J + Am[t])
        v = smallchol.solve_lower(L, h + Fv[t])
        ln = ln + (0.5 * d * LOG2PI
                   - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
                   + 0.5 * (v * v).sum(-1))
        Y = torch.linalg.solve_triangular(L, Dm[t].mT, upper=False)
        J = Cm[t] - Y.mT @ Y                            # C - D M^-1 D^T
        h = (Y.mT @ v[..., None])[..., 0] + Ev[t]       # D M^-1 (h+f) + e
        Js.append(J.reshape(NL, dd).T)
        hs.append(h.T)
    return torch.stack(Js), torch.stack(hs), ln


bidir_fwd_plain.calls = 0


def sampler_bp_fwd_plain(P2, P3, Jf, hf, eps, xT):
    """Plain PyTorch twin of :func:`sampler_bp_fwd` (same arguments)."""
    sampler_bp_fwd_plain.calls += 1
    T1, _, B = Jf.shape
    d, SB = xT.shape
    tile = lambda M: M.repeat(1, SB // B, 1, 1)        # lane s*B + b
    L = tile(smallchol.chol(_mats(Jf, d) - 2.0 * _mats(P3, d)))
    P2l = tile(_mats(P2, d))
    hfl = hf.permute(0, 2, 1).repeat(1, SB // B, 1)
    x = xT.T
    xs = [None] * T1
    for t in reversed(range(T1)):
        b = hfl[t] + (x[:, None, :] @ P2l[t])[:, 0]     # hf + P2^T x
        y = smallchol.solve_lower(L[t], b)
        x = smallchol.solve_upper_from_lower(L[t], y + eps[t].T)
        xs[t] = x.T
    return torch.stack(xs)


sampler_bp_fwd_plain.calls = 0


def sampler_bp_fwd_factor_plain(P2, P3, Jf, hf, eps):
    """Plain version of :func:`sampler_bp_fwd_factor` (same arguments, same
    outputs), batched over steps and sequences."""
    sampler_bp_fwd_factor_plain.calls += 1
    d = hf.shape[1]
    S = eps.shape[2] // Jf.shape[2]
    L = smallchol.chol(_mats(Jf, d) - 2.0 * _mats(P3, d))  # (T1, B, d, d)
    y = smallchol.solve_lower(L, hf.permute(0, 2, 1)).repeat(1, S, 1)
    c = smallchol.solve_upper_from_lower(L.repeat(1, S, 1, 1),
                                         y + eps.permute(0, 2, 1))
    Q = smallchol.cho_solve_mat(L, _mats(P2, d).mT)
    return _lane_minor(Q), _lane_minor(c)


sampler_bp_fwd_factor_plain.calls = 0


def sampler_bp_fwd_chain_plain(Q, c, xT):
    """Plain version of :func:`sampler_bp_fwd_chain` (same arguments, same
    output), one step at a time over all lanes."""
    sampler_bp_fwd_chain_plain.calls += 1
    T1, _, B = Q.shape
    d, SB = xT.shape
    Ql = _mats(Q, d).repeat(1, SB // B, 1, 1)           # lane s*B + b
    x = xT.T
    xs = [None] * T1
    for t in reversed(range(T1)):
        x = c[t].T + (Ql[t] @ x[..., None])[..., 0]
        xs[t] = x.T
    return torch.stack(xs)


sampler_bp_fwd_chain_plain.calls = 0


def bidir_adj_plain(J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln):
    """Plain version of :func:`bidir_adj` (same arguments, same outputs):
    the vector-Jacobian product of :func:`bidir_fwd_plain` (``J`` and
    ``h`` are not read)."""
    bidir_adj_plain.calls += 1
    return tuple(_vjp(bidir_fwd_plain, (J0, h0, A, C, D, E, F, Pc),
                      (dJ, dh, dln)))


bidir_adj_plain.calls = 0


def bidir_adj_factor_plain(J0, h0, A, C, D, E, F, Pc, J, h):
    """Plain version of :func:`bidir_adj_factor` (same arguments, same
    output), batched over lanes and steps."""
    bidir_adj_factor_plain.calls += 1
    T1, dd, NL = A.shape
    d = h0.shape[0]
    lanes = lambda X: X.permute(2, 0, 1)                # (T1, k, NL) -> lanes
    Jpre = lanes(torch.cat([J0[None], J[:-1]])).reshape(NL, T1, d, d)
    hpre = lanes(torch.cat([h0[None], h[:-1]]))
    Dm = lanes(D).reshape(NL, T1, d, d)
    W = torch.cholesky_inverse(smallchol.chol(
        Jpre + lanes(A).reshape(NL, T1, d, d)))
    K = W @ Dm.mT
    w = (W @ (hpre + lanes(F))[..., None])[..., 0]
    fac = torch.cat([W.reshape(NL, T1, dd), K.reshape(NL, T1, dd), w],
                    dim=-1)
    return fac.permute(1, 2, 0).contiguous()


bidir_adj_factor_plain.calls = 0


def bidir_adj_chain_plain(fac, dJ, dh, dln):
    """Plain version of :func:`bidir_adj_chain` (same arguments, same
    outputs): ``estep.filter_adj_chain_step`` one step at a time over all
    lanes, every output kept per step."""
    bidir_adj_chain_plain.calls += 1
    T1, R, NL = fac.shape
    d = dh.shape[1]
    dd = d * d
    fac = fac.permute(2, 0, 1)                            # (NL, T1, R)
    W = fac[..., :dd].reshape(NL, T1, d, d)
    K = fac[..., dd:2 * dd].reshape(NL, T1, d, d)
    w = fac[..., 2 * dd:]
    Mc = fac.new_zeros((NL, d, d))
    hc = fac.new_zeros((NL, d))
    steps = [None] * T1
    for t in reversed(range(T1)):
        wt = w[:, t]
        G = Mc + dJ[t].T.reshape(NL, d, d)
        g = hc + dh[t].T
        Mc, hc, P = filter_adj_chain_step(K[:, t], wt, W[:, t], G, g, dln)
        dD = g[..., :, None] * wt[..., None, :] - P.mT
        steps[t] = (Mc, G, dD, g, hc)
    stream = lambda k: _pack(torch.stack([s[k] for s in steps], 1))
    dA, dC, dD, dE, dF = (stream(k) for k in range(5))
    return (Mc.reshape(NL, dd).T.contiguous(), hc.T.contiguous(),
            dA, dC, dD, dE, dF)


bidir_adj_chain_plain.calls = 0


def sampler_bp_adj_plain(P2, P3, Jf, hf, eps, xT, x, dx):
    """Plain version of :func:`sampler_bp_adj` (same arguments, same
    outputs): the vector-Jacobian product of :func:`sampler_bp_fwd_plain`
    (``x`` is not read)."""
    sampler_bp_adj_plain.calls += 1
    fwd = lambda P2, P3, Jf, hf, xT: sampler_bp_fwd_plain(P2, P3, Jf, hf,
                                                           eps, xT)
    return tuple(_vjp(fwd, (P2, P3, Jf, hf, xT), (dx,)))


sampler_bp_adj_plain.calls = 0


def sampler_bp_adj_factor_plain(P3, Jf):
    """Plain version of :func:`sampler_bp_adj_factor` (same arguments, same
    output), batched over steps and sequences."""
    sampler_bp_adj_factor_plain.calls += 1
    d = math.isqrt(Jf.shape[1])
    L = smallchol.chol(_mats(Jf, d) - 2.0 * _mats(P3, d))
    return _lane_minor(torch.cholesky_inverse(L))


sampler_bp_adj_factor_plain.calls = 0


def sampler_bp_adj_chain_plain(W, P2, dx):
    """Plain version of :func:`sampler_bp_adj_chain` (same arguments, same
    outputs), one step at a time over all lanes."""
    sampler_bp_adj_chain_plain.calls += 1
    T1, _, B = W.shape
    d, SB = dx.shape[1:]
    tile = lambda M: _mats(M, d).repeat(1, SB // B, 1, 1)  # lane s*B + b
    Wl, P2l = tile(W), tile(P2)
    xc = dx.new_zeros((SB, d))
    bbar = []
    for t in range(T1):
        bb = (Wl[t] @ (xc + dx[t].T)[..., None])[..., 0]
        xc = (P2l[t] @ bb[..., None])[..., 0]
        bbar.append(bb.T)
    return torch.stack(bbar), xc.T.contiguous()


sampler_bp_adj_chain_plain.calls = 0


def sampler_bp_adj_dJc_plain(P2, P3, Jf, hf, eps, xT, x, bbar):
    """Plain version of :func:`sampler_bp_adj_dJc` (same arguments, same
    outputs), batched over steps and lanes: per lane dJc =
    ``estep.sampler_dJc``, dhf = bbar, dP2 = x_{t+1} bbar^T, then the S
    samples of each sequence summed."""
    sampler_bp_adj_dJc_plain.calls += 1
    T1, _, B = Jf.shape
    d, SB = xT.shape
    S = SB // B
    tile = lambda M: M.repeat(1, S, 1, 1)                  # lane s*B + b
    L = tile(smallchol.chol(_mats(Jf, d) - 2.0 * _mats(P3, d)))
    lanes = lambda X: X.permute(0, 2, 1)                   # (T1, SB, k)
    xn = lanes(_next_samples(xT, x))
    b = (lanes(hf).repeat(1, S, 1)
         + (xn[..., None, :] @ tile(_mats(P2, d)))[..., 0, :])
    bb = lanes(bbar)
    dJc = sampler_dJc(L, smallchol.cho_solve(L, b), bb, lanes(eps))
    fold = lambda X: _lane_minor(X.reshape(T1, S, B, *X.shape[2:]).sum(1))
    dJf = fold(dJc)
    return (fold(xn[..., :, None] * bb[..., None, :]), -2.0 * dJf, dJf,
            fold(bb))


sampler_bp_adj_dJc_plain.calls = 0


# --------------------------------------------------------------------------
# autograd Functions (the JAX package's bidir_prim / sampler_prim)
# --------------------------------------------------------------------------


class BidirFwd(torch.autograd.Function):
    """:func:`bidir_fwd` with :func:`bidir_adj` as its backward."""

    @staticmethod
    def forward(ctx, J0, h0, A, C, D, E, F, Pc):
        J, h, ln = bidir_fwd(J0, h0, A, C, D, E, F, Pc)
        ctx.save_for_backward(J0, h0, A, C, D, E, F, Pc, J, h)
        return J, h, ln

    @staticmethod
    def backward(ctx, dJ, dh, dln):
        return bidir_adj(*ctx.saved_tensors, dJ.contiguous(),
                         dh.contiguous(), dln.contiguous())


class SamplerBp(torch.autograd.Function):
    """:func:`sampler_bp_fwd` with :func:`sampler_bp_adj` as its backward;
    the noise gets no cotangent."""

    @staticmethod
    def forward(ctx, P2, P3, Jf, hf, eps, xT):
        x = sampler_bp_fwd(P2, P3, Jf, hf, eps, xT)
        ctx.save_for_backward(P2, P3, Jf, hf, eps, xT, x)
        return x

    @staticmethod
    def backward(ctx, dx):
        dP2, dP3, dJf, dhf, dxT = sampler_bp_adj(*ctx.saved_tensors,
                                                 dx.contiguous())
        return dP2, dP3, dJf, dhf, None, dxT


# --------------------------------------------------------------------------
# packing glue and public entries (batched torch ops, autograd)
# --------------------------------------------------------------------------


def _per_sequence(pairs, B):
    """Shared (T-1, ...) pairs -> (B, T-1, ...); per-sequence pairs as they
    are."""
    if pairs[0].dim() == 3:
        return tuple(p.expand((B,) + p.shape) for p in pairs)
    return tuple(pairs)


def _pack(x):
    """(lanes, T-1, ...) -> the (T-1, m, lanes) stream."""
    return x.reshape(x.shape[0], x.shape[1], -1).permute(1, 2, 0).contiguous()


def _unpack(x, tail):
    """(T-1, m, lanes) stream -> (lanes, T-1, *tail)."""
    return x.permute(2, 0, 1).reshape((x.shape[2], x.shape[0]) + tail)


def _streams(pairs, nodes):
    """The forward filter's streams ``(A, C, D, e, f, pc)``, lanes leading
    ((B, T-1, ...)): A = -2 P3, C = -2 P1 - 2 N1', D = P2, e = N2', f and
    pc as they come (f zero)."""
    N1, N2 = nodes
    P1, P2, P3, Pc = _per_sequence(pairs, N2.shape[0])
    e = N2[:, 1:]
    return (-2.0 * P3, -2.0 * P1 - 2.0 * N1[:, 1:], P2, e,
            torch.zeros_like(e), Pc)


def _reversed(streams):
    """The backward filter's streams: the forward ones flipped in time with
    (A, C) and (e, f) swapped, D transposed and pc zero (the forward f is
    zero, and so is the backward e)."""
    A, C, D, E, F, Pc = streams
    flip = lambda x: x.flip(1)
    return flip(C), flip(A), flip(D).mT, F, flip(E), torch.zeros_like(Pc)


def _initial(init, nodes):
    """The forward filter's initial message, the t=0 marginal:
    ``(J0 (B, d, d), h0 (B, d))``."""
    I1, I2 = init[:2]
    N1, N2 = nodes
    return -2.0 * (I1 + N1[:, 0]), I2 + N2[:, 0]


def _packed(J0, h0, streams):
    """Initial messages and streams, lanes leading -> the arguments of
    :func:`bidir_fwd`."""
    NL, d = h0.shape
    A, C, D, E, F, Pc = streams
    return (J0.reshape(NL, d * d).T.contiguous(), h0.T.contiguous(),
            *(_pack(x) for x in (A, C, D, E, F)), Pc.T.contiguous())


def bidir_inputs(init, pairs, nodes):
    """The packed arguments of :func:`bidir_fwd` for a batch (the glue of
    pallas_bidir.fb_pass): forward lanes [0, B) start from the t=0
    marginal, backward lanes [B, 2B) from 0 and read the forward streams
    reversed (:func:`_reversed`).

    ``init`` = (I1, I2, Ic); ``pairs`` = (P1, P2, P3, Pc), per sequence
    (B, T-1, ...) or shared (T-1, ...); ``nodes`` = (N1 (B, T, d, d),
    N2 (B, T, d))."""
    J0, h0 = _initial(init, nodes)
    fwd = _streams(pairs, nodes)
    both = lambda f, b: torch.cat([f, b])
    return _packed(both(J0, torch.zeros_like(J0)),
                   both(h0, torch.zeros_like(h0)),
                   [both(f, b) for f, b in zip(fwd, _reversed(fwd))])


def _alpha(J0, h0, J, h):
    """Initial messages (m, lanes) and outputs (T-1, m, lanes) of forward
    lanes -> the forward messages ``(Jf (B, T, d, d), hf (B, T, d))``."""
    d = h0.shape[0]
    return (_unpack(torch.cat([J0[None], J]), (d, d)),
            _unpack(torch.cat([h0[None], h]), (d,)))


def _beta(J, h):
    """Outputs (T-1, m, lanes) of backward lanes -> the backward messages
    in frame order, ``(Jb (B, T, d, d), hb (B, T, d))``, zero at
    t = T-1."""
    d, B = h.shape[1:]
    Jb, hb = _unpack(J, (d, d)).flip(1), _unpack(h, (d,)).flip(1)
    return (torch.cat([Jb, Jb.new_zeros(B, 1, d, d)], 1),
            torch.cat([hb, hb.new_zeros(B, 1, d)], 1))


def messages(args, J, h):
    """:func:`bidir_fwd`'s arguments ``args`` (as :func:`bidir_inputs`
    packs them) and outputs ``J``, ``h`` -> the forward and backward
    messages in frame order, ``(Jf, hf, Jb, hb)`` of (B, T, d, d) and
    (B, T, d), the backward ones zero at t = T-1."""
    J0, h0 = args[:2]
    B = h0.shape[1] // 2
    return (_alpha(J0[:, :B], h0[:, :B], J[..., :B], h[..., :B])
            + _beta(J[..., B:], h[..., B:]))


def fb_pass(init, pairs, nodes):
    """Both information filters in one :func:`bidir_fwd` pass (port of
    pallas_bidir.fb_pass), arguments as :func:`bidir_inputs`'. Returns
    ``(logZ (B,), Jf, hf, Jb, hb)`` as :func:`messages` gives them."""
    args = bidir_inputs(init, pairs, nodes)
    J, h, ln = _forward(bidir_fwd, bidir_fwd_plain, BidirFwd, args)
    Jf, hf, Jb, hb = messages(args, J, h)
    logZ = ln[:Jf.shape[0]] + init[2] + mvn_logZ_info(Jf[:, -1], hf[:, -1])
    return logZ, Jf, hf, Jb, hb


def lds_filter(init, pairs, nodes):
    """The forward information filter alone (port of pallas_vjp.lds_filter,
    whose kernel is ``_filter_fwd_kernel``): :func:`bidir_fwd` over the B
    forward lanes only, differentiable through :class:`BidirFwd`.
    Arguments as :func:`bidir_inputs`'; returns ``(logZ (B,), Jf, hf)``."""
    args = _packed(*_initial(init, nodes), _streams(pairs, nodes))
    J, h, ln = _forward(bidir_fwd, bidir_fwd_plain, BidirFwd, args)
    Jf, hf = _alpha(args[0], args[1], J, h)
    return ln + init[2] + mvn_logZ_info(Jf[:, -1], hf[:, -1]), Jf, hf


def lds_backward(pairs, nodes):
    """The backward information filter alone (port of
    pallas_vjp.lds_backward, whose kernel is ``_backward_fwd_kernel``):
    :func:`bidir_fwd` over the B backward lanes only, differentiable
    through :class:`BidirFwd`. Returns ``(Jb (B, T, d, d), hb (B, T, d))``,
    zero at t = T-1."""
    N2 = nodes[1]
    B, _, d = N2.shape
    args = _packed(N2.new_zeros(B, d, d), N2.new_zeros(B, d),
                   _reversed(_streams(pairs, nodes)))
    J, h, _ = _forward(bidir_fwd, bidir_fwd_plain, BidirFwd, args)
    return _beta(J, h)


def lds_smoother(init, pairs, nodes):
    """Smoothed posterior moments, no sampling: ``(logZ (B,), Ex, ExxT,
    Exnxt)``, batch leading."""
    logZ, Jf, hf, Jb, hb = fb_pass(init, pairs, nodes)
    return (logZ,) + smoother_assembly(pairs, nodes, Jf, hf, Jb, hb)


def terminal_sample(Jf, hf, eps):
    """The samples of the last frame, ``xT`` (S, B, d), from the forward
    messages ``Jf`` (B, T, d, d), ``hf`` (B, T, d) and the noise ``eps``
    (S, B, T, d): one batched solve."""
    LT = smallchol.chol(symmetrize(Jf[:, -1]))
    return (smallchol.cho_solve(LT, hf[:, -1])
            + smallchol.solve_upper_from_lower(LT, eps[:, :, -1]))


def sampler_noise(hf, generator, num_samples, eps=None):
    """``eps`` if given, else (S, B, T, d) standard normal noise shaped and
    typed as the forward messages ``hf`` (B, T, d), drawn by
    ``generator``."""
    if eps is not None:
        return eps
    if generator is None:
        raise ValueError("lds_sample: pass a torch.Generator or eps; the "
                         "global RNG is not used")
    return torch.randn((int(num_samples),) + tuple(hf.shape),
                       generator=generator, dtype=hf.dtype, device=hf.device)


def sampler_inputs(pairs, Jf, hf, eps):
    """The arguments of :func:`sampler_bp_fwd` from the pairs, the forward
    messages ``Jf`` (B, T, d, d), ``hf`` (B, T, d) and the noise ``eps``
    (S, B, T, d), plus the terminal samples ``xT`` (S, B, d) drawn here."""
    S, B, T, d = eps.shape
    xT = terminal_sample(Jf, hf, eps)
    P2, P3 = _per_sequence(pairs, B)[1:3]
    args = (_pack(P2), _pack(P3), _pack(Jf[:, :-1]), _pack(hf[:, :-1]),
            _pack(eps[:, :, :-1].reshape(S * B, T - 1, d)),
            xT.reshape(S * B, d).T.contiguous())
    return args, xT


def lds_sample(pairs, filtered, generator, num_samples, eps=None):
    """Reparameterized posterior samples (S, B, T, d) (port of
    pallas_vjp.lds_sample) from the forward filter's messages ``filtered``
    = (Jf, hf), as :func:`fb_pass` returns them. ``generator`` draws the
    (S, B, T, d) noise unless ``eps`` gives it."""
    Jf, hf = filtered
    eps = sampler_noise(hf, generator, num_samples, eps)
    S, B, T, d = eps.shape
    args, xT = sampler_inputs(pairs, Jf, hf, eps)
    xb = _forward(sampler_bp_fwd, sampler_bp_fwd_plain, SamplerBp, args)
    x_body = _unpack(xb, (d,)).reshape(S, B, T - 1, d)
    return torch.cat([x_body, xT[:, :, None]], 2)


def lds_estep(init, pairs, nodes, generator, num_samples, eps=None):
    """Differentiable E-step on per-sequence pairs: one :func:`fb_pass`
    shared by the smoother assembly and, through the forward messages, the
    sampler. Returns ``(samples (S, B, T, d), (Ex, ExxT, Exnxt), logZ
    (B,))``."""
    logZ, Jf, hf, Jb, hb = fb_pass(init, pairs, nodes)
    moments = smoother_assembly(pairs, nodes, Jf, hf, Jb, hb)
    samples = lds_sample(pairs, (Jf, hf), generator, num_samples, eps=eps)
    return samples, moments, logZ
