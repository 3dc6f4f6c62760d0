"""Packed stationary-diagonal LDS E-step (port of
svae_tpu/ops/pallas_estep.py).

The chain is time-homogeneous (one expected pair potential under q(theta))
and the recognition evidence is diagonal, so the two serial recursions of
the E-step take the pair blocks once and stream only the per-frame
evidence:

* :func:`filter_fwd` runs the forward information filter and the
  time-reversed backward filter side by side (lanes ``[0, B)`` and
  ``[B, 2B)``);
* :func:`sampler_fwd` draws the S posterior samples backward in time from
  the forward filter's messages; on a card it runs as two passes, one
  kernel each: a parallel factor pass (:func:`sampler_fwd_factor`) and the
  serial chain (:func:`sampler_fwd_chain`), each with a plain version of
  its own;
* :func:`filter_adj` and :func:`sampler_adj` are their adjoints, the
  backward of :class:`FilterFwd` and :class:`SamplerFwd`
  (``torch.autograd.Function``s, the counterparts of the JAX package's
  ``custom_vjp`` primitives). On a card each runs as passes, one kernel
  each, from one C call: a parallel factor pass, the serial chain and,
  for the sampler, a parallel pass for the cotangent of each step's
  precision (:func:`filter_adj_factor`, :func:`filter_adj_chain`;
  :func:`sampler_adj_factor`, :func:`sampler_adj_chain`,
  :func:`sampler_adj_dJc`, each with a plain version of its own).

Each is a CUDA kernel (``csrc/*.cu``) for tensors on a card and a plain
PyTorch version (``*_plain``) for tensors on the CPU: the forward twins run
the same recursion as batched ``torch.linalg`` ops over the lanes, one step
at a time, and each plain adjoint is the vector-Jacobian product of its
forward twin by ``torch.autograd``, independent of the kernels'
hand-derived algebra. A wrapper never falls back: on a CUDA tensor it
launches its kernel or raises. Each wrapper counts its launches in
``.launches``; each plain version counts its calls in ``.calls``.

On a card the E-step runs the Functions where a gradient may be taken, so
it goes through the adjoint kernels, and the forward kernels alone where
none can be; on the CPU it runs the forward twins and its gradient is
torch's own autograd through them.

Between the two recursions sits plain batched algebra: the smoothed-moment
assembly, the statistics, the local KL and the terminal sample.
"""

import math

import torch

from svae_tpu_torch.ops import _build
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import eye_like, mvn_logZ_info, symmetrize

LOG2PI = math.log(2 * math.pi)
KERNEL_DIMS = (2, 3, 4, 8, 10, 16)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_kernel_args(name, d, tensors, dims=KERNEL_DIMS, dim_name="d"):
    if d not in dims:
        raise ValueError(f"{name}: no kernel for {dim_name}={d}; built for "
                         f"{dim_name} in {dims}")
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {t.device}")


def _check_filter_shapes(name, J0, h0, A, C, D, jd, n2, *outs):
    """Shapes of :func:`filter_fwd`'s inputs and, for the adjoint, of its
    outputs and their cotangents ``(J, h, dJ, dh, dln)``."""
    T, d, B = jd.shape
    if T < 2:
        raise ValueError(f"{name}: needs T >= 2")
    want = [(d * d, 2 * B), (d, 2 * B)] + [(2, d, d)] * 3 + [jd.shape] * 2
    if outs:
        step = [(T - 1, d * d, 2 * B), (T - 1, d, 2 * B)]
        want += step * 2 + [(2 * B,)]
    if [tuple(t.shape) for t in (J0, h0, A, C, D, jd, n2, *outs)] != want:
        raise ValueError(f"{name}: inconsistent shapes")


def _check_sampler_shapes(name, P2, P3, Jf, hf, eps, xT, *outs):
    """Shapes of :func:`sampler_fwd`'s inputs and, for the adjoint, of its
    output and its cotangent ``(x, dx)``."""
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    want = ([(d, d)] * 2 + [(T1, d * d, B), (T1, d, B), (T1, d, SB),
                             (d, SB)] + [(T1, d, SB)] * len(outs))
    if (T1 < 1 or SB % B
            or [tuple(t.shape) for t in (P2, P3, Jf, hf, eps, xT, *outs)]
            != want):
        raise ValueError(f"{name}: inconsistent shapes")


def _launch(name, fn, dev, *args):
    ptr = lambda a: a.data_ptr() if isinstance(a, torch.Tensor) else a
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(ptr(a) for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def filter_fwd(J0, h0, A, C, D, jd, n2):
    """Both information filters over a batch of stationary chains.

    ``J0`` (d*d, 2B) and ``h0`` (d, 2B): initial messages, forward lanes
    first. ``A``, ``C``, ``D`` (2, d, d): per direction [forward, backward]
    the offset added to the carried message, the next marginal's offset and
    the coupling block. ``jd``, ``n2`` (T, d, B): diagonal node evidence
    (precision contribution -1/2 diag(jd)) in frame order; forward lanes
    read frames 1..T-1, backward lanes frames T-1..1, and the evidence goes
    into C forward and into A backward. Returns per step ``J``
    (T-1, d*d, 2B), ``h`` (T-1, d, 2B) and the summed log-normalizer
    increments ``ln`` (2B,)."""
    if J0.device.type == "cpu":
        return filter_fwd_plain(J0, h0, A, C, D, jd, n2)
    T, d, B = jd.shape
    args = (J0, h0, A, C, D, jd, n2)
    _check_filter_shapes("filter_fwd", *args)
    _check_kernel_args("filter_fwd", d, args)
    J = torch.empty((T - 1, d * d, 2 * B), dtype=J0.dtype, device=J0.device)
    h = torch.empty((T - 1, d, 2 * B), dtype=J0.dtype, device=J0.device)
    ln = torch.empty((2 * B,), dtype=J0.dtype, device=J0.device)
    lib = _build.load_library()
    _launch("filter_fwd", lib.svae_filter_fwd_f32, J0.device, d, B, T,
            *args, J, h, ln)
    filter_fwd.launches += 1
    return J, h, ln


filter_fwd.launches = 0


def sampler_fwd(P2, P3, Jf, hf, eps, xT):
    """Backward conditional sampler for S*B chains (lane ``s*B + b``).

    ``P2``, ``P3`` (d, d): the stationary pair blocks. ``Jf`` (T-1, d*d, B)
    and ``hf`` (T-1, d, B): forward-filter messages of frames 0..T-2,
    shared by the S samples of a sequence. ``eps`` (T-1, d, S*B): standard
    normal noise. ``xT`` (d, S*B): the terminal samples. Returns ``x``
    (T-1, d, S*B), frames 0..T-2. On a card one C call runs the two passes
    of :func:`sampler_fwd_factor` and :func:`sampler_fwd_chain`."""
    if P2.device.type == "cpu":
        return sampler_fwd_plain(P2, P3, Jf, hf, eps, xT)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    args = (P2, P3, Jf, hf, eps, xT)
    _check_sampler_shapes("sampler_fwd", *args)
    _check_kernel_args("sampler_fwd", d, args)
    W = torch.empty((T1, dd, B), dtype=xT.dtype, device=xT.device)
    c = torch.empty((T1, d, SB), dtype=xT.dtype, device=xT.device)
    x = torch.empty((T1, d, SB), dtype=xT.dtype, device=xT.device)
    lib = _build.load_library()
    _launch("sampler_fwd", lib.svae_sampler_fwd_f32, xT.device, d, B,
            SB // B, T1 + 1, *args, W, c, x)
    sampler_fwd.launches += 1
    return x


sampler_fwd.launches = 0


# The forward sampler's passes: x_t = c_t + W_t P2^T x_{t+1}, with W_t =
# Jc_t^-1 and c_t = W_t hf_t + L_t^-T eps_t (L_t = chol(Jc_t), Jc_t = Jf_t -
# 2 P3), the first carry-free, the second the serial chain.


def sampler_fwd_factor(P3, Jf, hf, eps):
    """Pass 1 of :func:`sampler_fwd`, parallel over (sequence, step):
    ``W`` (T-1, d*d, B), the inverse of Jc_t = Jf_t - 2 P3 per sequence, in
    ``Jf``'s layout (as :func:`sampler_adj_factor`'s), and ``c`` (T-1, d,
    S*B) = W_t hf_t + L_t^-T eps_t per lane. Arguments as
    :func:`sampler_fwd`'s ``P3``, ``Jf``, ``hf``, ``eps``."""
    if P3.device.type == "cpu":
        return sampler_fwd_factor_plain(P3, Jf, hf, eps)
    T1, dd, B = Jf.shape
    d, SB = P3.shape[0], eps.shape[-1]
    if (T1 < 1 or P3.shape != (d, d) or dd != d * d or SB % B
            or hf.shape != (T1, d, B) or eps.shape != (T1, d, SB)):
        raise ValueError("sampler_fwd_factor: inconsistent shapes")
    args = (P3, Jf, hf, eps)
    _check_kernel_args("sampler_fwd_factor", d, args)
    W = torch.empty((T1, dd, B), dtype=Jf.dtype, device=Jf.device)
    c = torch.empty((T1, d, SB), dtype=Jf.dtype, device=Jf.device)
    lib = _build.load_library()
    _launch("sampler_fwd_factor", lib.svae_sampler_fwd_factor_f32,
            Jf.device, d, B, SB // B, T1 + 1, *args, W, c)
    sampler_fwd_factor.launches += 1
    return W, c


sampler_fwd_factor.launches = 0


def sampler_fwd_chain(W, c, P2, xT):
    """Pass 2 of :func:`sampler_fwd`, serial in time: per sample chain
    x_t = c_t + W_t P2^T x_{t+1} from the terminal ``xT`` (d, S*B) and
    :func:`sampler_fwd_factor`'s ``W``, ``c``. Returns ``x`` (T-1, d,
    S*B)."""
    if W.device.type == "cpu":
        return sampler_fwd_chain_plain(W, c, P2, xT)
    T1, dd, B = W.shape
    d, SB = xT.shape
    if (T1 < 1 or dd != d * d or SB % B or P2.shape != (d, d)
            or c.shape != (T1, d, SB)):
        raise ValueError("sampler_fwd_chain: inconsistent shapes")
    args = (W, c, P2, xT)
    _check_kernel_args("sampler_fwd_chain", d, args)
    x = torch.empty((T1, d, SB), dtype=xT.dtype, device=xT.device)
    lib = _build.load_library()
    _launch("sampler_fwd_chain", lib.svae_sampler_fwd_chain_f32, W.device,
            d, B, SB // B, T1 + 1, *args, x)
    sampler_fwd_chain.launches += 1
    return x


sampler_fwd_chain.launches = 0


def _filter_adj_outputs(dnode, dJ0, dh0, dpar, d, B):
    """The adjoint kernel's per-direction and per-lane outputs -> the
    cotangents of :func:`filter_fwd`'s inputs: node cotangents summed over
    the two directions, parameter partials summed over each direction's
    lanes into (2, d, d)."""
    djd, dn2 = dnode.sum(1)
    dA, dC, dD = (dpar.reshape(3, d * d, 2, B).sum(-1).transpose(1, 2)
                  .reshape(3, 2, d, d))
    return dJ0, dh0, dA, dC, dD, djd, dn2


def filter_adj(J0, h0, A, C, D, jd, n2, J, h, dJ, dh, dln):
    """Adjoint of :func:`filter_fwd`: its inputs, its outputs ``J``, ``h``
    and their cotangents ``dJ``, ``dh``, ``dln`` -> the cotangents of its
    inputs ``(dJ0, dh0, dA, dC, dD, djd, dn2)``, shaped as the inputs. On
    a card one C call runs the two passes of :func:`filter_adj_factor` and
    :func:`filter_adj_chain`."""
    if J0.device.type == "cpu":
        return filter_adj_plain(J0, h0, A, C, D, jd, n2, J, h, dJ, dh, dln)
    T, d, B = jd.shape
    args = (J0, h0, A, C, D, jd, n2, J, h, dJ, dh, dln)
    _check_filter_shapes("filter_adj", *args)
    _check_kernel_args("filter_adj", d, args)
    kw = dict(dtype=J0.dtype, device=J0.device)
    fac = torch.empty((T - 1, 2 * d * d + d, 2 * B), **kw)
    dnode = torch.empty((2, 2, T, d, B), **kw)
    dJ0 = torch.empty((d * d, 2 * B), **kw)
    dh0 = torch.empty((d, 2 * B), **kw)
    dpar = torch.empty((3, d * d, 2 * B), **kw)
    lib = _build.load_library()
    _launch("filter_adj", lib.svae_filter_adj_f32, J0.device, d, B, T, J0,
            h0, A, D, jd, n2, J, h, dJ, dh, dln, fac, dnode, dJ0, dh0, dpar)
    filter_adj.launches += 1
    return _filter_adj_outputs(dnode, dJ0, dh0, dpar, d, B)


filter_adj.launches = 0


def _sampler_adj_outputs(dJc, dhf, dxT, dP2, B):
    """The adjoint kernel's per-lane outputs -> the cotangents of
    :func:`sampler_fwd`'s inputs ``(dP2, dP3, dJf, dhf, dxT)``: the S
    samples of a sequence summed, dP3 = -2 sum dJc, dP2 summed over the
    lanes."""
    T1, dd, SB = dJc.shape
    d = dhf.shape[1]
    dJf = dJc.reshape(T1, dd, SB // B, B).sum(2)
    dhf = dhf.reshape(T1, d, SB // B, B).sum(2)
    dP3 = -2.0 * dJf.sum((0, 2)).reshape(d, d)
    return dP2.sum(1).reshape(d, d), dP3, dJf, dhf, dxT


def sampler_adj(P2, P3, Jf, hf, eps, xT, x, dx):
    """Adjoint of :func:`sampler_fwd`: its inputs, its output ``x`` and
    the cotangent ``dx`` -> the cotangents ``(dP2, dP3, dJf, dhf, dxT)`` of
    its inputs other than the noise (which has none: it is i.i.d. and
    nothing upstream depends on it). On a card one C call runs the three
    passes of :func:`sampler_adj_factor`, :func:`sampler_adj_chain` and
    :func:`sampler_adj_dJc`."""
    if P2.device.type == "cpu":
        return sampler_adj_plain(P2, P3, Jf, hf, eps, xT, x, dx)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    args = (P2, P3, Jf, hf, eps, xT, x, dx)
    _check_sampler_shapes("sampler_adj", *args)
    _check_kernel_args("sampler_adj", d, args)
    kw = dict(dtype=xT.dtype, device=xT.device)
    W = torch.empty((T1, dd, B), **kw)
    dJc = torch.empty((T1, dd, SB), **kw)
    dhf = torch.empty((T1, d, SB), **kw)
    dxT = torch.empty((d, SB), **kw)
    dP2 = torch.empty((dd, SB), **kw)
    lib = _build.load_library()
    _launch("sampler_adj", lib.svae_sampler_adj_f32, xT.device, d, B,
            SB // B, T1 + 1, *args, W, dJc, dhf, dxT, dP2)
    sampler_adj.launches += 1
    return _sampler_adj_outputs(dJc, dhf, dxT, dP2, B)


sampler_adj.launches = 0


# The adjoints' passes one by one, for holding each kernel against its own
# plain version: filter_adj = _filter_adj_outputs(filter_adj_chain(
# filter_adj_factor(...), ...)), sampler_adj = _sampler_adj_outputs of
# sampler_adj_factor, sampler_adj_chain and sampler_adj_dJc. The model
# path calls filter_adj and sampler_adj, which launch the same kernels from
# one C call each.


def filter_adj_factor(J0, h0, A, C, D, jd, n2, J, h):
    """Pass 1 of :func:`filter_adj`, parallel over (lane, step): per step
    t of lane r*B + b the inverse W of M = J_pre + A_r (+ diag jd on the
    backward lanes), K = W D_r^T and w = W v, v = h_pre (+ n2 backward),
    as ``fac`` (T-1, 2d^2 + d, 2B) = [W, K (row-major), w] in the layout
    of the forward's messages. Arguments as :func:`filter_adj`'s first
    nine (``C`` is not read)."""
    if J0.device.type == "cpu":
        return filter_adj_factor_plain(J0, h0, A, C, D, jd, n2, J, h)
    T, d, B = jd.shape
    args = (J0, h0, A, C, D, jd, n2, J, h)
    _check_filter_shapes("filter_adj_factor", *args[:7])
    if J.shape != (T - 1, d * d, 2 * B) or h.shape != (T - 1, d, 2 * B):
        raise ValueError("filter_adj_factor: inconsistent shapes")
    _check_kernel_args("filter_adj_factor", d, args)
    fac = torch.empty((T - 1, 2 * d * d + d, 2 * B), dtype=J0.dtype,
                      device=J0.device)
    lib = _build.load_library()
    _launch("filter_adj_factor", lib.svae_filter_adj_factor_f32, J0.device,
            d, B, T, J0, h0, A, D, jd, n2, J, h, fac)
    filter_adj_factor.launches += 1
    return fac


filter_adj_factor.launches = 0


def _check_chain_shapes(name, fac, dJ, dh, dln):
    T1, R, NL = fac.shape
    d = dh.shape[1] if dh.dim() == 3 else 0
    if (NL % 2 or R != 2 * d * d + d or dJ.shape != (T1, d * d, NL)
            or dh.shape != (T1, d, NL) or dln.shape != (NL,)):
        raise ValueError(f"{name}: inconsistent shapes")
    return NL // 2, T1 + 1, d


def filter_adj_chain(fac, dJ, dh, dln):
    """Pass 2 of :func:`filter_adj`, serial in time: the carried
    cotangents walked back through the steps from :func:`filter_adj_factor`'s
    ``fac`` and the cotangents ``dJ``, ``dh``, ``dln``. Returns the
    per-direction and per-lane outputs ``(dnode (2, 2, T, d, B), dJ0
    (d*d, 2B), dh0 (d, 2B), dpar (3, d*d, 2B))`` that
    :func:`_filter_adj_outputs` reduces."""
    if fac.device.type == "cpu":
        return filter_adj_chain_plain(fac, dJ, dh, dln)
    B, T, d = _check_chain_shapes("filter_adj_chain", fac, dJ, dh, dln)
    args = (fac, dJ, dh, dln)
    _check_kernel_args("filter_adj_chain", d, args)
    kw = dict(dtype=fac.dtype, device=fac.device)
    dnode = torch.empty((2, 2, T, d, B), **kw)
    dJ0 = torch.empty((d * d, 2 * B), **kw)
    dh0 = torch.empty((d, 2 * B), **kw)
    dpar = torch.empty((3, d * d, 2 * B), **kw)
    lib = _build.load_library()
    _launch("filter_adj_chain", lib.svae_filter_adj_chain_f32, fac.device,
            d, B, T, *args, dnode, dJ0, dh0, dpar)
    filter_adj_chain.launches += 1
    return dnode, dJ0, dh0, dpar


filter_adj_chain.launches = 0


def sampler_adj_factor(P3, Jf):
    """Pass 1 of :func:`sampler_adj`, parallel over (sequence, step): ``W``
    (T-1, d*d, B), the inverse of Jf_t - 2 P3 per sequence (shared by its
    S samples), in ``Jf``'s layout. ``P3`` (d, d), ``Jf`` (T-1, d*d, B)."""
    if P3.device.type == "cpu":
        return sampler_adj_factor_plain(P3, Jf)
    T1, dd, B = Jf.shape
    d = P3.shape[0]
    if T1 < 1 or P3.shape != (d, d) or dd != d * d:
        raise ValueError("sampler_adj_factor: inconsistent shapes")
    _check_kernel_args("sampler_adj_factor", d, (P3, Jf))
    W = torch.empty((T1, dd, B), dtype=Jf.dtype, device=Jf.device)
    lib = _build.load_library()
    _launch("sampler_adj_factor", lib.svae_sampler_adj_factor_f32,
            Jf.device, d, B, T1 + 1, P3, Jf, W)
    sampler_adj_factor.launches += 1
    return W


sampler_adj_factor.launches = 0


def sampler_adj_chain(W, P2, xT, x, dx):
    """Pass 2 of :func:`sampler_adj`, serial in time: per sample chain
    b-bar_t = W_t (x-bar_t + dx_t), x-bar_{t+1} = P2 b-bar_t from
    :func:`sampler_adj_factor`'s ``W``. Returns the per-lane ``(dhf
    (T-1, d, S*B) = b-bar, dxT (d, S*B), dP2 (d*d, S*B))``."""
    if W.device.type == "cpu":
        return sampler_adj_chain_plain(W, P2, xT, x, dx)
    T1, dd, B = W.shape
    d, SB = xT.shape
    if (dd != d * d or SB % B or P2.shape != (d, d)
            or x.shape != (T1, d, SB) or dx.shape != x.shape):
        raise ValueError("sampler_adj_chain: inconsistent shapes")
    args = (W, P2, xT, x, dx)
    _check_kernel_args("sampler_adj_chain", d, args)
    kw = dict(dtype=W.dtype, device=W.device)
    dhf = torch.empty((T1, d, SB), **kw)
    dxT = torch.empty((d, SB), **kw)
    dP2 = torch.empty((dd, SB), **kw)
    lib = _build.load_library()
    _launch("sampler_adj_chain", lib.svae_sampler_adj_chain_f32, W.device,
            d, B, SB // B, T1 + 1, *args, dhf, dxT, dP2)
    sampler_adj_chain.launches += 1
    return dhf, dxT, dP2


sampler_adj_chain.launches = 0


def sampler_adj_dJc(P2, P3, Jf, hf, eps, xT, x, bbar):
    """Pass 3 of :func:`sampler_adj`, parallel over (lane, step): the
    per-lane cotangent ``dJc`` (T-1, d*d, S*B) of Jc_t = Jf_t - 2 P3 from
    :func:`sampler_adj_chain`'s b-bar (its ``dhf``) and the sampler's
    inputs and output (arguments as :func:`sampler_adj`'s first seven)."""
    if P2.device.type == "cpu":
        return sampler_adj_dJc_plain(P2, P3, Jf, hf, eps, xT, x, bbar)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    args = (P2, P3, Jf, hf, eps, xT, x, bbar)
    _check_sampler_shapes("sampler_adj_dJc", *args)
    _check_kernel_args("sampler_adj_dJc", d, args)
    dJc = torch.empty((T1, dd, SB), dtype=Jf.dtype, device=Jf.device)
    lib = _build.load_library()
    _launch("sampler_adj_dJc", lib.svae_sampler_adj_dJc_f32, Jf.device, d,
            B, SB // B, T1 + 1, *args, dJc)
    sampler_adj_dJc.launches += 1
    return dJc


sampler_adj_dJc.launches = 0


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def filter_fwd_plain(J0, h0, A, C, D, jd, n2):
    """Plain PyTorch twin of :func:`filter_fwd` (same arguments)."""
    filter_fwd_plain.calls += 1
    T, d, B = jd.shape
    NL = 2 * B
    rep = lambda M: M.repeat_interleave(B, dim=0)       # (2,d,d)->(NL,d,d)
    Al, Cl, DlT = rep(A), rep(C), rep(D).mT
    wA = (torch.arange(NL, device=jd.device) >= B).to(jd.dtype)[:, None]
    wC = 1.0 - wA
    # step t: forward lanes read frame t+1, backward lanes frame T-1-t
    jds = torch.cat([jd[1:], jd.flip(0)[:T - 1]], dim=-1)  # (T-1, d, NL)
    n2s = torch.cat([n2[1:], n2.flip(0)[:T - 1]], dim=-1)
    J = J0.T.reshape(NL, d, d)
    h = h0.T
    ln = torch.zeros(NL, dtype=jd.dtype, device=jd.device)
    Js, hs = [], []
    for t in range(T - 1):
        jv, nv = jds[t].T, n2s[t].T
        L = smallchol.chol(J + Al + torch.diag_embed(wA * jv))
        v = smallchol.solve_lower(L, h + wA * nv)
        ln = ln + (0.5 * d * LOG2PI
                   - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
                   + 0.5 * (v * v).sum(-1))
        Y = torch.linalg.solve_triangular(L, DlT, upper=False)  # L^-1 D^T
        J = Cl + torch.diag_embed(wC * jv) - Y.mT @ Y
        h = (Y.mT @ v[..., None])[..., 0] + wC * nv
        Js.append(J.reshape(NL, d * d).T)
        hs.append(h.T)
    return torch.stack(Js), torch.stack(hs), ln


filter_fwd_plain.calls = 0


def sampler_fwd_plain(P2, P3, Jf, hf, eps, xT):
    """Plain PyTorch twin of :func:`sampler_fwd` (same arguments)."""
    sampler_fwd_plain.calls += 1
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    S = SB // B
    Jc = Jf.permute(0, 2, 1).reshape(T1, B, d, d) - 2.0 * P3
    L = smallchol.chol(Jc).repeat(1, S, 1, 1)            # (T1, SB, d, d)
    hfl = hf.permute(0, 2, 1).repeat(1, S, 1)             # (T1, SB, d)
    x = xT.T
    xs = [None] * T1
    for t in reversed(range(T1)):
        y = smallchol.solve_lower(L[t], hfl[t] + x @ P2)
        x = smallchol.solve_upper_from_lower(L[t], y + eps[t].T)
        xs[t] = x.T
    return torch.stack(xs)


sampler_fwd_plain.calls = 0


def _jc_chol(P3, Jf):
    """The Cholesky factors (T-1, B, d, d) of Jc_t = Jf_t - 2 P3."""
    T1, dd, B = Jf.shape
    d = P3.shape[0]
    return smallchol.chol(Jf.permute(0, 2, 1).reshape(T1, B, d, d)
                          - 2.0 * P3)


def _lane_minor(X):
    """(T-1, lanes, k...) -> (T-1, prod(k), lanes), contiguous."""
    return X.reshape(*X.shape[:2], -1).permute(0, 2, 1).contiguous()


def sampler_fwd_factor_plain(P3, Jf, hf, eps):
    """Plain version of :func:`sampler_fwd_factor` (same arguments, same
    outputs), batched over sequences and steps."""
    sampler_fwd_factor_plain.calls += 1
    S = eps.shape[-1] // Jf.shape[-1]
    L = _jc_chol(P3, Jf)
    y = smallchol.solve_lower(L, hf.permute(0, 2, 1)).repeat(1, S, 1)
    c = smallchol.solve_upper_from_lower(L.repeat(1, S, 1, 1),
                                         y + eps.permute(0, 2, 1))
    return _lane_minor(torch.cholesky_inverse(L)), _lane_minor(c)


sampler_fwd_factor_plain.calls = 0


def sampler_fwd_chain_plain(W, c, P2, xT):
    """Plain version of :func:`sampler_fwd_chain` (same arguments, same
    output), one step at a time over all lanes."""
    sampler_fwd_chain_plain.calls += 1
    T1, dd, B = W.shape
    d, SB = xT.shape
    Wl = W.permute(0, 2, 1).reshape(T1, B, d, d).repeat(1, SB // B, 1, 1)
    x = xT.T
    xs = [None] * T1
    for t in reversed(range(T1)):
        x = c[t].T + (Wl[t] @ (x @ P2)[..., None])[..., 0]
        xs[t] = x.T
    return torch.stack(xs)


sampler_fwd_chain_plain.calls = 0


def _vjp(fn, inputs, cotangents):
    """Gradients of ``fn(*inputs)`` against ``cotangents`` with respect to
    every input (zeros where an input is unused)."""
    ins = [x.detach().requires_grad_() for x in inputs]
    with torch.enable_grad():
        outs = fn(*ins)
    grads = torch.autograd.grad(outs, ins, cotangents, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(ins, grads)]


def filter_adj_plain(J0, h0, A, C, D, jd, n2, J, h, dJ, dh, dln):
    """Plain version of :func:`filter_adj` (same arguments, same outputs):
    the vector-Jacobian product of :func:`filter_fwd_plain` (``J`` and
    ``h`` are not read)."""
    filter_adj_plain.calls += 1
    return tuple(_vjp(filter_fwd_plain, (J0, h0, A, C, D, jd, n2),
                      (dJ, dh, dln)))


filter_adj_plain.calls = 0


def sampler_adj_plain(P2, P3, Jf, hf, eps, xT, x, dx):
    """Plain version of :func:`sampler_adj` (same arguments, same
    outputs): the vector-Jacobian product of :func:`sampler_fwd_plain`
    (``x`` is not read)."""
    sampler_adj_plain.calls += 1
    fwd = lambda P2, P3, Jf, hf, xT: sampler_fwd_plain(P2, P3, Jf, hf, eps,
                                                        xT)
    return tuple(_vjp(fwd, (P2, P3, Jf, hf, xT), (dx,)))


sampler_adj_plain.calls = 0


def filter_adj_factor_plain(J0, h0, A, C, D, jd, n2, J, h):
    """Plain version of :func:`filter_adj_factor` (same arguments, same
    output), batched over lanes and steps."""
    filter_adj_factor_plain.calls += 1
    T, d, B = jd.shape
    NL, T1 = 2 * B, T - 1
    lanes = lambda X: X.permute(2, 0, 1)                # (T1, k, NL) -> lanes
    Jpre = lanes(torch.cat([J0[None], J[:-1]])).reshape(NL, T1, d, d)
    hpre = lanes(torch.cat([h0[None], h[:-1]]))
    wA = (torch.arange(NL, device=jd.device) >= B).to(jd.dtype)[:, None, None]
    jds = lanes(torch.cat([jd[1:], jd.flip(0)[:T1]], dim=-1))
    n2s = lanes(torch.cat([n2[1:], n2.flip(0)[:T1]], dim=-1))
    rep = lambda X: X.repeat_interleave(B, dim=0)[:, None]
    L = smallchol.chol(Jpre + rep(A) + torch.diag_embed(wA * jds))
    W = torch.cholesky_inverse(L)
    K = W @ rep(D).mT
    w = (W @ (hpre + wA * n2s)[..., None])[..., 0]
    fac = torch.cat([W.reshape(NL, T1, d * d), K.reshape(NL, T1, d * d), w],
                    dim=-1)
    return fac.permute(1, 2, 0).contiguous()


filter_adj_factor_plain.calls = 0


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def filter_adj_chain_step(K, w, W, G, g, dln):
    """One step of the information filter adjoint's chain in products,
    batched over the lanes (the plain chain passes of :func:`filter_adj`
    and ``bpairs.bidir_adj``): with P = K (G + G^T) and a = K g, returns
    ``(M-bar, h-bar, P)``, M-bar = 1/2 P K^T - 1/2 (a w^T + w a^T) -
    1/2 lam (w w^T + W), h-bar = lam w + a, lam = ``dln`` per lane."""
    P = K @ (G + G.mT)
    a = (K @ g[..., None])[..., 0]
    Mc = (0.5 * P @ K.mT - 0.5 * (_outer(a, w) + _outer(w, a))
          - 0.5 * dln[:, None, None] * (_outer(w, w) + W))
    return Mc, dln[:, None] * w + a, P


def filter_adj_chain_plain(fac, dJ, dh, dln):
    """Plain version of :func:`filter_adj_chain` (same arguments, same
    outputs): the same products, one step at a time over all lanes."""
    filter_adj_chain_plain.calls += 1
    T1, R, NL = fac.shape
    d, B, T = dh.shape[1], NL // 2, T1 + 1
    dd = d * d
    fac = fac.permute(2, 0, 1)                            # (NL, T1, R)
    W = fac[..., :dd].reshape(NL, T1, d, d)
    K = fac[..., dd:2 * dd].reshape(NL, T1, d, d)
    w = fac[..., 2 * dd:]
    Mc = fac.new_zeros((NL, d, d))
    hc = fac.new_zeros((NL, d))
    acc = fac.new_zeros((3, NL, d, d))
    dnode = fac.new_zeros((2, 2, T, d, B))
    for t in reversed(range(T1)):
        wt = w[:, t]
        G = Mc + dJ[t].T.reshape(NL, d, d)
        g = hc + dh[t].T
        Mc, hc, P = filter_adj_chain_step(K[:, t], wt, W[:, t], G, g, dln)
        dnode[0, 0, t + 1] = torch.diagonal(G[:B], dim1=-2, dim2=-1).T
        dnode[1, 0, t + 1] = g[:B].T
        dnode[0, 1, T - 1 - t] = torch.diagonal(Mc[B:], dim1=-2, dim2=-1).T
        dnode[1, 1, T - 1 - t] = hc[B:].T
        acc = acc + torch.stack([Mc, G, _outer(g, wt) - P.mT])
    dpar = acc.reshape(3, NL, dd).transpose(1, 2).contiguous()
    return dnode, Mc.reshape(NL, dd).T.contiguous(), hc.T.contiguous(), dpar


filter_adj_chain_plain.calls = 0


def sampler_adj_factor_plain(P3, Jf):
    """Plain version of :func:`sampler_adj_factor` (same arguments, same
    output)."""
    sampler_adj_factor_plain.calls += 1
    return _lane_minor(torch.cholesky_inverse(_jc_chol(P3, Jf)))


sampler_adj_factor_plain.calls = 0


def _next_samples(xT, x):
    """x_{t+1} of every step t, (T-1, d, S*B): the forward's frames
    1..T-2, then the terminal sample."""
    return torch.cat([x[1:], xT[None]])


def sampler_adj_chain_plain(W, P2, xT, x, dx):
    """Plain version of :func:`sampler_adj_chain` (same arguments, same
    outputs), one step at a time over all lanes."""
    sampler_adj_chain_plain.calls += 1
    T1, dd, B = W.shape
    d, SB = xT.shape
    Wl = W.permute(2, 0, 1).repeat(SB // B, 1, 1).reshape(SB, T1, d, d)
    xn = _next_samples(xT, x)
    xc = xT.new_zeros((SB, d))
    acc = xT.new_zeros((SB, d, d))
    dhf = []
    for t in range(T1):
        bb = (Wl[:, t] @ (xc + dx[t].T)[..., None])[..., 0]
        acc = acc + xn[t].T[:, :, None] * bb[:, None, :]
        xc = bb @ P2.T
        dhf.append(bb.T)
    return (torch.stack(dhf), xc.T.contiguous(),
            acc.reshape(SB, dd).T.contiguous())


sampler_adj_chain_plain.calls = 0


def sampler_adj_dJc_plain(P2, P3, Jf, hf, eps, xT, x, bbar):
    """Plain version of :func:`sampler_adj_dJc` (same arguments, same
    output), batched over lanes and steps: dJc = sym(-bbar mu^T + L^-T P
    L^-1) with P = -phi(eps u^T), u = L^T bbar."""
    sampler_adj_dJc_plain.calls += 1
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    Jc = Jf.permute(0, 2, 1).reshape(T1, B, d, d) - 2.0 * P3
    L = smallchol.chol(Jc).repeat(1, SB // B, 1, 1)       # (T1, SB, d, d)
    lanes = lambda X: X.permute(0, 2, 1)                  # (T1, SB, d)
    xn = lanes(_next_samples(xT, x))
    hfl = lanes(hf).repeat(1, SB // B, 1)
    mu = smallchol.cho_solve(L, hfl + xn @ P2)
    dJc = sampler_dJc(L, mu, lanes(bbar), lanes(eps))
    return dJc.reshape(T1, SB, dd).permute(0, 2, 1).contiguous()


sampler_adj_dJc_plain.calls = 0


def sampler_dJc(L, mu, bbar, eps):
    """The cotangent of a sampler step's precision Jc = L L^T, per lane
    (the plain dJc passes of :func:`sampler_adj` and
    ``bpairs.sampler_bp_adj``): sym(-bbar mu^T + L^-T P L^-1) with P =
    -phi(eps u^T), u = L^T bbar, where ``mu`` = Jc^-1 b is the step's mean
    and ``eps`` its noise; ``L`` (..., d, d), the vectors (..., d)."""
    d = L.shape[-1]
    u = (L.mT @ bbar[..., None])[..., 0]
    P = -torch.tril(eps[..., :, None] * u[..., None, :])
    P = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
    Linv = torch.linalg.solve_triangular(L, torch.eye(d, dtype=L.dtype,
                                                      device=L.device),
                                         upper=False)
    S = Linv.mT @ P @ Linv
    outer = bbar[..., :, None] * mu[..., None, :]
    return 0.5 * (S + S.mT - outer - outer.mT)


# --------------------------------------------------------------------------
# autograd Functions (the JAX package's filter_prim / sampler_prim)
# --------------------------------------------------------------------------


class FilterFwd(torch.autograd.Function):
    """:func:`filter_fwd` with :func:`filter_adj` as its backward."""

    @staticmethod
    def forward(ctx, J0, h0, A, C, D, jd, n2):
        J, h, ln = filter_fwd(J0, h0, A, C, D, jd, n2)
        ctx.save_for_backward(J0, h0, A, C, D, jd, n2, J, h)
        return J, h, ln

    @staticmethod
    def backward(ctx, dJ, dh, dln):
        return filter_adj(*ctx.saved_tensors, dJ.contiguous(),
                          dh.contiguous(), dln.contiguous())


class SamplerFwd(torch.autograd.Function):
    """:func:`sampler_fwd` with :func:`sampler_adj` as its backward; the
    noise gets no cotangent, as in the JAX package."""

    @staticmethod
    def forward(ctx, P2, P3, Jf, hf, eps, xT):
        x = sampler_fwd(P2, P3, Jf, hf, eps, xT)
        ctx.save_for_backward(P2, P3, Jf, hf, eps, xT, x)
        return x

    @staticmethod
    def backward(ctx, dx):
        dP2, dP3, dJf, dhf, dxT = sampler_adj(*ctx.saved_tensors,
                                              dx.contiguous())
        return dP2, dP3, dJf, dhf, None, dxT


def _forward(kernel, twin, function, args, plain=False):
    """One forward recursion: the twin on the CPU (or with ``plain``); on a
    card the kernel, through its autograd ``function`` only when a gradient
    may be asked of it, so that inference saves nothing for a backward."""
    if plain or args[0].device.type == "cpu":
        return twin(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return function.apply(*args)
    return kernel(*args)


# --------------------------------------------------------------------------
# smoothed-moment assembly (batched torch ops)
# --------------------------------------------------------------------------


def smoother_assembly(pairs, nodes, Jf, hf, Jb, hb):
    """Smoothed node and pair moments ``(Ex (B, T, d), ExxT (B, T, d, d),
    Exnxt (B, T-1, d, d))`` from the two filters' messages Jf/Jb
    (B, T, d, d), hf/hb (B, T, d) (port of pallas_estep._assembly_xla and
    pallas_vjp._smoother_assembly). ``pairs`` = (P1, P2, P3, ...), shared
    (d, d) or (T-1, d, d), or per sequence (B, T-1, d, d); ``nodes`` =
    (N1 (B, T, d, d), N2)."""
    P1, P2, P3 = pairs[:3]
    N1 = nodes[0]
    Js = Jf + Jb
    L = smallchol.chol(symmetrize(Js))
    Ex = smallchol.cho_solve(L, hf + hb)
    Sig = smallchol.cho_solve_mat(L, eye_like(Js))
    ExxT = symmetrize(Sig + Ex[..., :, None] * Ex[..., None, :])

    J12l = -P2.mT
    J11 = -2.0 * P3 + Jf[:, :-1]
    J22 = -2.0 * (P1 + N1[:, 1:]) + Jb[:, 1:]
    L11 = smallchol.chol(symmetrize(J11))
    J11inv_J12 = smallchol.cho_solve_mat(L11, J12l.expand(J11.shape))
    S = J22 - J12l.mT @ J11inv_J12
    LS = smallchol.chol(symmetrize(S))
    Sinv = smallchol.cho_solve_mat(LS, eye_like(S))
    Cov12 = -J11inv_J12 @ Sinv
    Exnxt = Cov12 + Ex[:, :-1, :, None] * Ex[:, 1:, None, :]
    return Ex, ExxT, Exnxt


# --------------------------------------------------------------------------
# public entries
# --------------------------------------------------------------------------


def filter_inputs(init, pair_mats, nodes_diag):
    """The packed arguments of :func:`filter_fwd` for a batch: initial
    messages (forward lanes start from the t=0 marginal, backward lanes from
    0), the per-direction stationary blocks and the node evidence in
    (T, d, B) layout."""
    I1, I2 = init[:2]
    E1, E2, E3 = pair_mats[:3]
    jd, n2 = nodes_diag
    B, T, d = n2.shape
    dd = d * d
    # per direction [forward, backward]: C forward = -2 P1, backward -2 P3
    A = torch.stack([-2.0 * E3, -2.0 * E1])
    C = torch.stack([-2.0 * E1, -2.0 * E3])
    D = torch.stack([E2, E2.mT])
    J0f = -2.0 * I1 + torch.diag_embed(jd[:, 0])          # (B, d, d)
    h0f = I2 + n2[:, 0]
    J0 = torch.cat([J0f.reshape(B, dd).T, J0f.new_zeros(dd, B)], dim=1)
    h0 = torch.cat([h0f.T, h0f.new_zeros(d, B)], dim=1)
    return (J0, h0, A, C, D, jd.permute(1, 2, 0).contiguous(),
            n2.permute(1, 2, 0).contiguous())


def _filter_and_moments(init, pair_mats, nodes_diag, plain=False):
    """Both filters plus the smoothed-moment assembly. Returns ``(logZ (B,),
    Ex (B,T,d), ExxT (B,T,d,d), Exnxt (B,T-1,d,d), Jf, hf)`` with the
    forward messages (Jf, hf) in the packed (T, d*d, B) / (T, d, B) layout
    for the sampler."""
    Ic, Pc = init[2], pair_mats[3]
    jd, n2 = nodes_diag
    B, T, d = n2.shape
    dd = d * d
    args = filter_inputs(init, pair_mats, nodes_diag)
    Jr, hr, ln = _forward(filter_fwd, filter_fwd_plain, FilterFwd, args,
                          plain)
    J0, h0 = args[:2]

    # align the halves in frame order, packed (T, dd, B)
    Jf = torch.cat([J0[None, :, :B], Jr[:, :, :B]])
    hf = torch.cat([h0[None, :, :B], hr[:, :, :B]])
    Jb = torch.cat([Jr[:, :, B:].flip(0), Jr.new_zeros(1, dd, B)])
    hb = torch.cat([hr[:, :, B:].flip(0), hr.new_zeros(1, d, B)])

    JfT = Jf[-1].T.reshape(B, d, d)
    logZ = ln[:B] + (T - 1) * Pc + Ic + mvn_logZ_info(JfT, hf[-1].T)

    unpack_J = lambda x: x.permute(2, 0, 1).reshape(B, T, d, d)
    unpack_h = lambda x: x.permute(2, 0, 1)
    Ex, ExxT, Exnxt = smoother_assembly(
        pair_mats, (-0.5 * torch.diag_embed(jd), n2), unpack_J(Jf),
        unpack_h(hf), unpack_J(Jb), unpack_h(hb))
    return logZ, Ex, ExxT, Exnxt, Jf, hf


def sampler_inputs(pair_mats, Jf, hf, eps):
    """The arguments of :func:`sampler_fwd` from the packed forward messages
    ``Jf`` (T, d*d, B), ``hf`` (T, d, B) and the noise ``eps`` (S, B, T, d),
    plus the terminal samples ``xT`` (S, B, d) drawn here."""
    E2, E3 = pair_mats[1], pair_mats[2]
    S, B, T, d = eps.shape
    LT = smallchol.chol(symmetrize(Jf[-1].T.reshape(B, d, d)))
    xT = (smallchol.cho_solve(LT, hf[-1].T)
          + smallchol.solve_upper_from_lower(LT, eps[:, :, -1]))
    epsb = eps[:, :, :-1].reshape(S * B, T - 1, d).permute(1, 2, 0)
    args = (E2.contiguous(), E3.contiguous(), Jf[:-1], hf[:-1],
            epsb.contiguous(), xT.reshape(S * B, d).T.contiguous())
    return args, xT


def _samples(pair_mats, Jf, hf, generator, num_samples, eps=None,
             plain=False):
    """(S, B, T, d) posterior samples from the packed forward messages
    ``Jf`` (T, d*d, B), ``hf`` (T, d, B): ``generator`` draws the noise
    unless ``eps`` (S, B, T, d) gives it."""
    T, d, B = hf.shape
    S = int(num_samples)
    if eps is None:
        if generator is None:
            raise ValueError("the stationary sampler: pass a "
                             "torch.Generator or eps; the global RNG is not "
                             "used")
        eps = torch.randn((S, B, T, d), generator=generator, dtype=hf.dtype,
                          device=hf.device)
    args, xT = sampler_inputs(pair_mats, Jf, hf, eps)
    xb = _forward(sampler_fwd, sampler_fwd_plain, SamplerFwd, args,
                  plain)                                  # (T-1, d, S*B)
    x_body = xb.permute(2, 0, 1).reshape(S, B, T - 1, d)
    return torch.cat([x_body, xT[:, :, None]], dim=2)


def lds_moments_stationary(init, pair_mats, nodes_diag):
    """Smoothed posterior moments, no sampling: ``(logZ (B,), Ex (B,T,d),
    ExxT (B,T,d,d), Exnxt (B,T-1,d,d))``."""
    logZ, Ex, ExxT, Exnxt, _, _ = _filter_and_moments(
        init, pair_mats, nodes_diag)
    return logZ, Ex, ExxT, Exnxt


def lds_sample_stationary(init, pair_mats, nodes_diag, generator,
                          num_samples, eps=None):
    """Posterior samples (S, B, T, d) alone: :func:`filter_fwd`'s forward
    lanes feed :func:`sampler_fwd`, with no moment assembly, on the same
    arguments as :func:`lds_estep_stationary` (whose samples these are, for
    the same noise)."""
    B = nodes_diag[1].shape[0]
    args = filter_inputs(init, pair_mats, nodes_diag)
    Jr, hr, _ = _forward(filter_fwd, filter_fwd_plain, FilterFwd, args)
    Jf = torch.cat([args[0][None, :, :B], Jr[:, :, :B]])
    hf = torch.cat([args[1][None, :, :B], hr[:, :, :B]])
    return _samples(pair_mats, Jf, hf, generator, num_samples, eps)


def lds_estep_stationary(init, pair_mats, nodes_diag, generator,
                         num_samples, eps=None, plain=False):
    """Minibatch E-step for stationary pairs and diagonal node evidence.

    ``init`` = (I1, I2, Ic), ``pair_mats`` = (E1, E2, E3, Pc): the expected
    init and pair potentials under q(theta), not broadcast over time.
    ``nodes_diag`` = (jd, h), each (B, T, d), with node precision
    contribution -1/2 diag(jd). ``generator`` draws the (S, B, T, d) noise
    unless ``eps`` gives it. ``plain=True`` runs the twins on any device;
    it exists only so that chip_smoke.py can time the twin-path E-step on
    the card beside the kernel path, and no model code sets it.

    Returns ``(samples (S, B, T, d), (niw_stats, mniw_stats), local_kl)``,
    the statistics summed over the batch."""
    jd, n2 = nodes_diag
    B, T, d = n2.shape
    T1 = T - 1

    logZ, Ex, ExxT, Exnxt, Jf, hf = _filter_and_moments(
        init, pair_mats, nodes_diag, plain=plain)

    cnt = torch.tensor(float(B), dtype=n2.dtype, device=n2.device)
    niw_stats = (ExxT[:, 0].sum(0), Ex[:, 0].sum(0), cnt, cnt)
    ExnxtT = Exnxt.mT                               # E[x_{t+1} x_t^T]
    mniw_stats = (ExxT[:, 1:].sum((0, 1)), ExnxtT.sum((0, 1)),
                  ExxT[:, :-1].sum((0, 1)), T1 * cnt)

    # local KL: sum N1*ExxT + sum h*Ex - sum logZ (N1 diagonal)
    diag_ExxT = torch.diagonal(ExxT, dim1=-2, dim2=-1)
    local_kl = (-0.5 * (jd * diag_ExxT).sum() + (n2 * Ex).sum()
                - logZ.sum())

    samples = _samples(pair_mats, Jf, hf, generator, num_samples, eps, plain)
    return samples, (niw_stats, mniw_stats), local_kl
