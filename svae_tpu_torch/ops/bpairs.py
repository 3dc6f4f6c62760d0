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
  forward filter's messages, on lane ``s*B + b``.

:func:`bidir_adj` and :func:`sampler_bp_adj` are their adjoints, the
backward of :class:`BidirFwd` and :class:`SamplerBp`. Each of the four is a
CUDA kernel (``csrc/bpairs.cu``, ``csrc/bidir_adj.cu``,
``csrc/sampler_bp_adj.cu``) for tensors on a card and a plain PyTorch
version (``*_plain``) for tensors on the CPU, with the launch counters and
the no-fallback rule of :mod:`~svae_tpu_torch.ops.estep`: the forward
twins step batched ``torch.linalg`` ops over the lanes, the plain adjoints
are ``torch.autograd``'s vector-Jacobian products of the twins.

Streams keep the JAX package's packed layout with the lane innermost
((T-1, d*d, lanes) and (T-1, d, lanes)), without its 128-lane padding: on
the card a lane is a thread. The packing, the smoothed-moment assembly
(estep.smoother_assembly, shared with the stationary E-step) and the
terminal sample are batched torch ops, differentiable by autograd.
"""

import torch

from svae_tpu_torch.ops import _build
from svae_tpu_torch.ops.estep import (LOG2PI, _check_kernel_args, _forward,
                                      _launch, _vjp, smoother_assembly)
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
    inputs ``(dJ0, dh0, dA, dC, dD, dE, dF, dPc)``, shaped as the inputs."""
    if J0.device.type == "cpu":
        return bidir_adj_plain(J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln)
    args = (J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln)
    _check_bidir_shapes("bidir_adj", *args)
    T1, dd, NL = A.shape
    d = h0.shape[0]
    _check_kernel_args("bidir_adj", d, args)
    dA, dC, dD = (torch.empty_like(A) for _ in range(3))
    dE, dF = torch.empty_like(E), torch.empty_like(F)
    dJ0, dh0 = torch.empty_like(J0), torch.empty_like(h0)
    lib = _build.load_library()
    _launch("bidir_adj", lib.svae_bidir_adj_f32, J0.device, d, NL, T1, J0,
            h0, A, D, F, J, h, dJ, dh, dln, dA, dC, dD, dE, dF, dJ0, dh0)
    bidir_adj.launches += 1
    return dJ0, dh0, dA, dC, dD, dE, dF, dln.expand(T1, NL)


bidir_adj.launches = 0


def sampler_bp_fwd(P2, P3, Jf, hf, eps, xT):
    """Backward conditional sampler for S*B chains (lane ``s*B + b``) on
    per-sequence pairs.

    ``P2``, ``P3`` (T-1, d*d, B): the pair blocks of transitions 0..T-2.
    ``Jf`` (T-1, d*d, B) and ``hf`` (T-1, d, B): forward-filter messages of
    frames 0..T-2. All four are shared by the S samples of a sequence.
    ``eps`` (T-1, d, S*B): standard normal noise; ``xT`` (d, S*B): the
    terminal samples. Returns ``x`` (T-1, d, S*B), frames 0..T-2."""
    if P2.device.type == "cpu":
        return sampler_bp_fwd_plain(P2, P3, Jf, hf, eps, xT)
    args = (P2, P3, Jf, hf, eps, xT)
    _check_sampler_shapes("sampler_bp_fwd", *args)
    T1, _, B = Jf.shape
    d, SB = xT.shape
    _check_kernel_args("sampler_bp_fwd", d, args)
    x = torch.empty_like(eps)
    lib = _build.load_library()
    _launch("sampler_bp_fwd", lib.svae_sampler_bp_fwd_f32, xT.device, d, B,
            SB // B, T1, *args, x)
    sampler_bp_fwd.launches += 1
    return x


sampler_bp_fwd.launches = 0


def _sampler_adj_outputs(dJc, dhf, dP2, dxT, B):
    """The adjoint kernel's per-lane outputs -> the cotangents of
    :func:`sampler_bp_fwd`'s inputs ``(dP2, dP3, dJf, dhf, dxT)``: the S
    samples of a sequence summed, dP3 = -2 dJf."""
    S = dJc.shape[-1] // B
    fold = lambda x: x.reshape(x.shape[:2] + (S, B)).sum(2)
    dJf = fold(dJc)
    return fold(dP2), -2.0 * dJf, dJf, fold(dhf), dxT


def sampler_bp_adj(P2, P3, Jf, hf, eps, xT, x, dx):
    """Adjoint of :func:`sampler_bp_fwd`: its inputs, its output ``x`` and
    the cotangent ``dx`` -> the cotangents ``(dP2, dP3, dJf, dhf, dxT)`` of
    its inputs other than the noise, which has none."""
    if P2.device.type == "cpu":
        return sampler_bp_adj_plain(P2, P3, Jf, hf, eps, xT, x, dx)
    args = (P2, P3, Jf, hf, eps, xT, x, dx)
    _check_sampler_shapes("sampler_bp_adj", *args)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    _check_kernel_args("sampler_bp_adj", d, args)
    kw = dict(dtype=xT.dtype, device=xT.device)
    dJc = torch.empty((T1, dd, SB), **kw)
    dhf = torch.empty((T1, d, SB), **kw)
    dP2 = torch.empty((T1, dd, SB), **kw)
    dxT = torch.empty((d, SB), **kw)
    lib = _build.load_library()
    _launch("sampler_bp_adj", lib.svae_sampler_bp_adj_f32, xT.device, d, B,
            SB // B, T1, *args, dJc, dhf, dP2, dxT)
    sampler_bp_adj.launches += 1
    return _sampler_adj_outputs(dJc, dhf, dP2, dxT, B)


sampler_bp_adj.launches = 0


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


def bidir_adj_plain(J0, h0, A, C, D, E, F, Pc, J, h, dJ, dh, dln):
    """Plain version of :func:`bidir_adj` (same arguments, same outputs):
    the vector-Jacobian product of :func:`bidir_fwd_plain` (``J`` and
    ``h`` are not read)."""
    bidir_adj_plain.calls += 1
    return tuple(_vjp(bidir_fwd_plain, (J0, h0, A, C, D, E, F, Pc),
                      (dJ, dh, dln)))


bidir_adj_plain.calls = 0


def sampler_bp_adj_plain(P2, P3, Jf, hf, eps, xT, x, dx):
    """Plain version of :func:`sampler_bp_adj` (same arguments, same
    outputs): the vector-Jacobian product of :func:`sampler_bp_fwd_plain`
    (``x`` is not read)."""
    sampler_bp_adj_plain.calls += 1
    fwd = lambda P2, P3, Jf, hf, xT: sampler_bp_fwd_plain(P2, P3, Jf, hf,
                                                           eps, xT)
    return tuple(_vjp(fwd, (P2, P3, Jf, hf, xT), (dx,)))


sampler_bp_adj_plain.calls = 0


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


def bidir_inputs(init, pairs, nodes):
    """The packed arguments of :func:`bidir_fwd` for a batch (the glue of
    pallas_bidir.fb_pass): forward lanes [0, B) start from the t=0
    marginal, backward lanes [B, 2B) from 0 and read the forward streams
    flipped in time with (A, C) and (e, f) swapped, D transposed and pc
    zero.

    ``init`` = (I1, I2, Ic); ``pairs`` = (P1, P2, P3, Pc), per sequence
    (B, T-1, ...) or shared (T-1, ...); ``nodes`` = (N1 (B, T, d, d),
    N2 (B, T, d))."""
    I1, I2 = init[:2]
    N1, N2 = nodes
    B, T, d = N2.shape
    P1, P2, P3, Pc = _per_sequence(pairs, B)
    A_f = -2.0 * P3
    C_f = -2.0 * P1 - 2.0 * N1[:, 1:]
    e_f = N2[:, 1:]
    flip = lambda x: x.flip(1)
    zvec = torch.zeros_like(e_f)
    J0_f = -2.0 * (I1 + N1[:, 0])
    h0_f = I2 + N2[:, 0]
    return (torch.cat([J0_f, torch.zeros_like(J0_f)]).reshape(2 * B, d * d)
            .T.contiguous(),
            torch.cat([h0_f, torch.zeros_like(h0_f)]).T.contiguous(),
            _pack(torch.cat([A_f, flip(C_f)])),
            _pack(torch.cat([C_f, flip(A_f)])),
            _pack(torch.cat([P2, flip(P2).mT])),
            _pack(torch.cat([e_f, zvec])),
            _pack(torch.cat([zvec, flip(e_f)])),
            torch.cat([Pc, torch.zeros_like(Pc)]).T.contiguous())


def messages(args, J, h):
    """:func:`bidir_fwd`'s arguments ``args`` (as :func:`bidir_inputs`
    packs them) and outputs ``J``, ``h`` -> the forward and backward
    messages in frame order, ``(Jf, hf, Jb, hb)`` of (B, T, d, d) and
    (B, T, d), the backward ones zero at t = T-1."""
    J0, h0 = args[:2]
    d, NL = h0.shape
    B = NL // 2
    Jall = _unpack(torch.cat([J0[None], J]), (d, d))    # (2B, T, d, d)
    hall = _unpack(torch.cat([h0[None], h]), (d,))
    Jb = torch.cat([Jall[B:, 1:].flip(1), Jall.new_zeros(B, 1, d, d)], 1)
    hb = torch.cat([hall[B:, 1:].flip(1), hall.new_zeros(B, 1, d)], 1)
    return Jall[:B], hall[:B], Jb, hb


def fb_pass(init, pairs, nodes):
    """Both information filters in one :func:`bidir_fwd` pass (port of
    pallas_bidir.fb_pass), arguments as :func:`bidir_inputs`'. Returns
    ``(logZ (B,), Jf, hf, Jb, hb)`` as :func:`messages` gives them."""
    args = bidir_inputs(init, pairs, nodes)
    J, h, ln = _forward(bidir_fwd, bidir_fwd_plain, BidirFwd, args)
    Jf, hf, Jb, hb = messages(args, J, h)
    logZ = ln[:Jf.shape[0]] + init[2] + mvn_logZ_info(Jf[:, -1], hf[:, -1])
    return logZ, Jf, hf, Jb, hb


def lds_smoother(init, pairs, nodes):
    """Smoothed posterior moments, no sampling: ``(logZ (B,), Ex, ExxT,
    Exnxt)``, batch leading."""
    logZ, Jf, hf, Jb, hb = fb_pass(init, pairs, nodes)
    return (logZ,) + smoother_assembly(pairs, nodes, Jf, hf, Jb, hb)


def sampler_inputs(pairs, Jf, hf, eps):
    """The arguments of :func:`sampler_bp_fwd` from the pairs, the forward
    messages ``Jf`` (B, T, d, d), ``hf`` (B, T, d) and the noise ``eps``
    (S, B, T, d), plus the terminal samples ``xT`` (S, B, d) drawn here."""
    S, B, T, d = eps.shape
    LT = smallchol.chol(symmetrize(Jf[:, -1]))
    xT = (smallchol.cho_solve(LT, hf[:, -1])
          + smallchol.solve_upper_from_lower(LT, eps[:, :, -1]))
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
    B, T, d = hf.shape
    S = int(num_samples)
    if eps is None:
        if generator is None:
            raise ValueError("lds_sample: pass a torch.Generator or eps; the "
                             "global RNG is not used")
        eps = torch.randn((S, B, T, d), generator=generator, dtype=hf.dtype,
                          device=hf.device)
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
