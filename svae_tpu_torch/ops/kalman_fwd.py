"""Forward-only LDS E-step on pair potentials shared over the batch (port
of svae_tpu/ops/pallas_kalman.py).

The pairs (P1, P2, P3 (T-1, d, d), Pc (T-1,)) vary in time but not over
the batch, as the expected potentials of the LDS-SVAE do; the node
potentials (N1 (B, T, d, d), N2 (B, T, d)) are per sequence. Three
recursions carry it, each a CUDA kernel (``csrc/kalman_fwd.cu``) for
tensors on a card and a plain PyTorch version (``*_plain``) for tensors on
the CPU, with the launch counters and the no-fallback rule of
:mod:`~svae_tpu_torch.ops.estep`:

* :func:`filter_shared`, the forward information filter and its summed
  log-normalizer;
* :func:`backward_shared`, the backward information filter (the beta
  messages);
* :func:`sampler_shared`, the backward conditional sampler of S samples,
  on lane ``s*B + b``.

The kernels read each step's pair row once for the whole batch (the
layout of the Pallas kernels, without their 128-lane padding): the two
filters run a chain on a warp, on the Gauss-Jordan step of
:func:`~svae_tpu_torch.ops.bpairs.bidir_fwd`'s kernel, with the pair rows
and each lane's node entries staged through a ring in shared memory; the
sampler runs :func:`~svae_tpu_torch.ops.bpairs.sampler_bp_fwd`'s two
passes (``csrc/bpairs.cu``), a factor pass on the shared rows
(:func:`sampler_shared_factor`) and that sampler's chain pass
(:func:`~svae_tpu_torch.ops.bpairs.sampler_bp_fwd_chain`). The plain
versions run :mod:`~svae_tpu_torch.ops.bpairs`'s twins on the pair rows
broadcast over the lanes.

As in the JAX package, nothing here is differentiable: the Pallas kernels
carry no ``custom_vjp``. The entry points raise if a gradient could be
asked of an input; :func:`svae_tpu_torch.ops.bpairs.lds_filter` and
:func:`~svae_tpu_torch.ops.bpairs.lds_backward` are the differentiable
filters. :func:`lds_filter_bpairs` (per-sequence pairs) runs
:func:`bpairs.lds_filter`'s forward launch.
"""

import torch

from svae_tpu_torch.ops import _build, bpairs
from svae_tpu_torch.ops.bpairs import _alpha, _initial, _pack, _unpack
from svae_tpu_torch.ops.estep import (_check_kernel_args, _launch,
                                      smoother_assembly)
from svae_tpu_torch.utils.psd import f32_linalg, mvn_logZ_info
from svae_tpu_torch.utils.pytree import tree_leaves


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_shapes(name, got, want):
    if [tuple(t.shape) for t in got] != want:
        raise ValueError(f"{name}: inconsistent shapes")


def filter_shared(J0, h0, P1, P2, P3, Pc, N1, N2):
    """The forward information filter over B lanes on shared pair rows.

    ``J0`` (d*d, B), ``h0`` (d, B): the initial messages (the t=0
    marginal). ``P1``, ``P2``, ``P3`` (T-1, d*d) and ``Pc`` (T-1,): the
    pair potentials of transitions 0..T-2. ``N1`` (T-1, d*d, B), ``N2``
    (T-1, d, B): the node potentials of frames 1..T-1. Per step t,
    ``M = J - 2 P3_t``, ``J' = -2 P1_t - 2 N1_{t+1} - P2_t M^-1 P2_t^T``,
    ``h' = P2_t M^-1 h + N2_{t+1}``. Returns the messages of frames
    1..T-1, ``J`` (T-1, d*d, B) and ``h`` (T-1, d, B), and ``ln`` (B,), the
    summed ``d/2 log 2pi - 1/2 log|M| + 1/2 h^T M^-1 h + pc_t`` (without
    the initial constant and the last frame's log-partition)."""
    if J0.device.type == "cpu":
        return filter_shared_plain(J0, h0, P1, P2, P3, Pc, N1, N2)
    args = (J0, h0, P1, P2, P3, Pc, N1, N2)
    T1, dd, B = N1.shape
    d = h0.shape[0]
    _check_shapes("filter_shared", args,
                  [(d * d, B), (d, B)] + [(T1, d * d)] * 3
                  + [(T1,), (T1, d * d, B), (T1, d, B)])
    _check_kernel_args("filter_shared", d, args)
    kw = dict(dtype=J0.dtype, device=J0.device)
    J = torch.empty((T1, dd, B), **kw)
    h = torch.empty((T1, d, B), **kw)
    ln = torch.empty((B,), **kw)
    lib = _build.load_library()
    _launch("filter_shared", lib.svae_filter_shared_f32, J0.device, d, B, T1,
            *args, J, h, ln)
    filter_shared.launches += 1
    return J, h, ln


filter_shared.launches = 0


def backward_shared(P1, P2, P3, N1, N2):
    """The backward information filter over B lanes on shared pair rows,
    from the zero message at frame T-1, descending. ``P1``, ``P2``, ``P3``
    (T-1, d*d): the pair potentials of transitions 0..T-2; ``N1``
    (T-1, d*d, B), ``N2`` (T-1, d, B): the node potentials of frames
    1..T-1. Per step t, ``M = Jb_{t+1} - 2 P1_t - 2 N1_{t+1}``,
    ``Jb_t = -2 P3_t - P2_t^T M^-1 P2_t``,
    ``hb_t = P2_t^T M^-1 (hb_{t+1} + N2_{t+1})``. Returns the messages of
    frames 0..T-2, ``J`` (T-1, d*d, B) and ``h`` (T-1, d, B)."""
    if N1.device.type == "cpu":
        return backward_shared_plain(P1, P2, P3, N1, N2)
    args = (P1, P2, P3, N1, N2)
    T1, dd, B = N1.shape
    d = N2.shape[1]
    _check_shapes("backward_shared", args,
                  [(T1, d * d)] * 3 + [(T1, d * d, B), (T1, d, B)])
    _check_kernel_args("backward_shared", d, args)
    J, h = torch.empty_like(N1), torch.empty_like(N2)
    lib = _build.load_library()
    _launch("backward_shared", lib.svae_backward_shared_f32, N1.device, d, B,
            T1, *args, J, h)
    backward_shared.launches += 1
    return J, h


backward_shared.launches = 0


def sampler_shared(P2, P3, Jf, hf, eps, xT):
    """The backward conditional sampler for S*B chains (lane ``s*B + b``)
    on shared pair rows. ``P2``, ``P3`` (T-1, d*d): the pair blocks of
    transitions 0..T-2; ``Jf`` (T-1, d*d, B), ``hf`` (T-1, d, B): the
    forward messages of frames 0..T-2, shared by the S samples of a
    sequence; ``eps`` (T-1, d, S*B): standard normal noise; ``xT``
    (d, S*B): the terminal samples. Per step, ``Jc = Jf_t - 2 P3_t`` and
    ``x_t = Jc^-1 (hf_t + P2_t^T x_{t+1}) + chol(Jc)^-T eps_t``. Returns
    ``x`` (T-1, d, S*B), frames 0..T-2. On a card one C call runs the two
    passes of :func:`sampler_shared_factor` and
    :func:`~svae_tpu_torch.ops.bpairs.sampler_bp_fwd_chain`."""
    if Jf.device.type == "cpu":
        return sampler_shared_plain(P2, P3, Jf, hf, eps, xT)
    args = (P2, P3, Jf, hf, eps, xT)
    T1, dd, B = Jf.shape
    d, SB = xT.shape
    if SB % B:
        raise ValueError("sampler_shared: inconsistent shapes")
    _check_shapes("sampler_shared", args,
                  [(T1, d * d)] * 2 + [(T1, d * d, B), (T1, d, B),
                                       (T1, d, SB), (d, SB)])
    _check_kernel_args("sampler_shared", d, args)
    kw = dict(dtype=xT.dtype, device=xT.device)
    Q = torch.empty((T1, dd, B), **kw)
    c = torch.empty((T1, d, SB), **kw)
    x = torch.empty_like(eps)
    lib = _build.load_library()
    _launch("sampler_shared", lib.svae_sampler_shared_f32, xT.device, d, B,
            SB // B, T1, *args, Q, c, x)
    sampler_shared.launches += 1
    return x


sampler_shared.launches = 0


def sampler_shared_factor(P2, P3, Jf, hf, eps):
    """Pass 1 of :func:`sampler_shared`, parallel over (step, sequence),
    on the shared rows ``P2``, ``P3`` (T-1, d*d): ``Q`` (T-1, d*d, B) =
    Jc_t^-1 P2_t^T per sequence (Jc_t = Jf_t - 2 P3_t), shared by its S
    samples, in ``Jf``'s layout, and ``c`` (T-1, d, S*B) = Jc_t^-1 hf_t +
    chol(Jc_t)^-T eps_t per lane; pass 2 is
    :func:`~svae_tpu_torch.ops.bpairs.sampler_bp_fwd_chain` on them.
    Arguments as :func:`sampler_shared`'s first five."""
    if Jf.device.type == "cpu":
        return sampler_shared_factor_plain(P2, P3, Jf, hf, eps)
    args = (P2, P3, Jf, hf, eps)
    T1, dd, B = Jf.shape
    d, SB = (hf.shape[1], eps.shape[2]) if eps.dim() == 3 else (0, 0)
    if T1 < 1 or SB % B:
        raise ValueError("sampler_shared_factor: inconsistent shapes")
    _check_shapes("sampler_shared_factor", args,
                  [(T1, d * d)] * 2 + [(T1, d * d, B), (T1, d, B),
                                       (T1, d, SB)])
    _check_kernel_args("sampler_shared_factor", d, args)
    kw = dict(dtype=Jf.dtype, device=Jf.device)
    Q = torch.empty((T1, dd, B), **kw)
    c = torch.empty((T1, d, SB), **kw)
    _launch("sampler_shared_factor",
            _build.load_library().svae_sampler_shared_factor_f32, Jf.device,
            d, B, SB // B, T1, *args, Q, c)
    sampler_shared_factor.launches += 1
    return Q, c


sampler_shared_factor.launches = 0


# --------------------------------------------------------------------------
# plain versions: bpairs' twins on the pair rows broadcast over the lanes
# --------------------------------------------------------------------------


def _lanes(rows, B):
    """(T-1, m) pair rows -> the (T-1, m, B) stream of every lane."""
    return rows[..., None].expand(rows.shape + (B,))


def filter_shared_plain(J0, h0, P1, P2, P3, Pc, N1, N2):
    """Plain PyTorch twin of :func:`filter_shared` (same arguments)."""
    filter_shared_plain.calls += 1
    B = h0.shape[1]
    return bpairs.bidir_fwd_plain(
        J0, h0, _lanes(-2.0 * P3, B), -2.0 * (_lanes(P1, B) + N1),
        _lanes(P2, B), N2, torch.zeros_like(N2), _lanes(Pc, B))


filter_shared_plain.calls = 0


def backward_shared_plain(P1, P2, P3, N1, N2):
    """Plain PyTorch twin of :func:`backward_shared` (same arguments): the
    generic filter of bpairs over the streams in descending time."""
    backward_shared_plain.calls += 1
    T1, dd, B = N1.shape
    d = N2.shape[1]
    P2T = P2.reshape(T1, d, d).mT.reshape(T1, dd)
    J, h, _ = bpairs.bidir_fwd_plain(
        N1.new_zeros(dd, B), N2.new_zeros(d, B),
        (-2.0 * (_lanes(P1, B) + N1)).flip(0), _lanes(-2.0 * P3, B).flip(0),
        _lanes(P2T, B).flip(0), torch.zeros_like(N2), N2.flip(0),
        N2.new_zeros(T1, B))
    return J.flip(0), h.flip(0)


backward_shared_plain.calls = 0


def sampler_shared_plain(P2, P3, Jf, hf, eps, xT):
    """Plain PyTorch twin of :func:`sampler_shared` (same arguments)."""
    sampler_shared_plain.calls += 1
    B = Jf.shape[2]
    return bpairs.sampler_bp_fwd_plain(_lanes(P2, B), _lanes(P3, B), Jf, hf,
                                       eps, xT)


sampler_shared_plain.calls = 0


def sampler_shared_factor_plain(P2, P3, Jf, hf, eps):
    """Plain version of :func:`sampler_shared_factor` (same arguments, same
    outputs)."""
    sampler_shared_factor_plain.calls += 1
    B = Jf.shape[2]
    return bpairs.sampler_bp_fwd_factor_plain(_lanes(P2, B), _lanes(P3, B),
                                              Jf, hf, eps)


sampler_shared_factor_plain.calls = 0


# --------------------------------------------------------------------------
# public entries (forward only)
# --------------------------------------------------------------------------


def _forward_only(name, *trees):
    """Raise where autograd could be asked for a gradient of an input: the
    kernels here have no adjoint."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in tree_leaves(trees)):
        raise ValueError(
            f"kalman_fwd.{name} is forward only (no adjoint), but an input "
            f"requires grad: call it under torch.no_grad(), or use "
            f"bpairs.lds_filter / bpairs.lds_backward for gradients")


def _rows(pairs, T, d):
    """Shared pairs (P1, P2, P3 (T-1, d, d), Pc (T-1,)) -> the kernels'
    (T-1, d*d) rows and (T-1,) offsets."""
    P1, P2, P3, Pc = pairs
    if (any(tuple(P.shape) != (T - 1, d, d) for P in (P1, P2, P3))
            or tuple(Pc.shape) != (T - 1,)):
        raise ValueError("kalman_fwd: pairs must be shared over the batch, "
                         "(T-1, d, d) and (T-1,); lds_filter_bpairs takes "
                         "per-sequence pairs")
    return tuple(P.reshape(T - 1, d * d).contiguous()
                 for P in (P1, P2, P3)) + (Pc.contiguous(),)


def _node_streams(nodes):
    """Nodes (N1 (B, T, d, d), N2 (B, T, d)) -> the (T-1, m, B) streams of
    frames 1..T-1."""
    return _pack(nodes[0][:, 1:]), _pack(nodes[1][:, 1:])


def filter_inputs(init, pairs, nodes):
    """The arguments of :func:`filter_shared` for a batch: ``init`` = (I1
    (d, d), I2 (d,), Ic), ``pairs`` shared over the batch, ``nodes`` = (N1
    (B, T, d, d), N2 (B, T, d))."""
    B, T, d = nodes[1].shape
    J0, h0 = _initial(init, nodes)
    return (J0.reshape(B, d * d).T.contiguous(), h0.T.contiguous(),
            *_rows(pairs, T, d), *_node_streams(nodes))


def backward_inputs(pairs, nodes):
    """The arguments of :func:`backward_shared` for a batch."""
    T, d = nodes[1].shape[1:]
    return _rows(pairs, T, d)[:3] + _node_streams(nodes)


def sampler_inputs(pairs, Jf, hf, eps):
    """The arguments of :func:`sampler_shared` from the pairs, the forward
    messages ``Jf`` (B, T, d, d), ``hf`` (B, T, d) and the noise ``eps``
    (S, B, T, d), plus the terminal samples ``xT`` (S, B, d) drawn here."""
    S, B, T, d = eps.shape
    xT = bpairs.terminal_sample(Jf, hf, eps)
    args = (*_rows(pairs, T, d)[1:3], _pack(Jf[:, :-1]), _pack(hf[:, :-1]),
            _pack(eps[:, :, :-1].reshape(S * B, T - 1, d)),
            xT.reshape(S * B, d).T.contiguous())
    return args, xT


def lds_filter(init, pairs, nodes):
    """Forward filter (port of pallas_kalman.lds_filter_pallas). ``init``
    = (I1 (d, d), I2 (d,), Ic), ``pairs`` shared over the batch, ``nodes``
    = (N1 (B, T, d, d), N2 (B, T, d)). Returns ``(logZ (B,), Jf
    (B, T, d, d), hf (B, T, d))``."""
    _forward_only("lds_filter", init, pairs, nodes)
    args = filter_inputs(init, pairs, nodes)
    J, h, ln = filter_shared(*args)
    Jf, hf = _alpha(args[0], args[1], J, h)
    return ln + init[2] + mvn_logZ_info(Jf[:, -1], hf[:, -1]), Jf, hf


def lds_backward(pairs, nodes):
    """Backward filter, the beta messages (port of
    pallas_kalman.lds_backward_pallas): ``(Jb (B, T, d, d), hb (B, T, d))``
    with the t = T-1 entries zero."""
    _forward_only("lds_backward", pairs, nodes)
    B, _, d = nodes[1].shape
    J, h = backward_shared(*backward_inputs(pairs, nodes))
    Jb, hb = _unpack(J, (d, d)), _unpack(h, (d,))
    return (torch.cat([Jb, Jb.new_zeros(B, 1, d, d)], 1),
            torch.cat([hb, hb.new_zeros(B, 1, d)], 1))


@f32_linalg()
def lds_smoother(init, pairs, nodes, filtered=None):
    """Smoothed moments from the two filters (port of
    pallas_kalman.lds_smoother_pallas): ``(logZ (B,), Ex, ExxT, Exnxt)``.
    ``filtered`` = (logZ, Jf, hf) reuses a filter pass."""
    _forward_only("lds_smoother", init, pairs, nodes, filtered)
    logZ, Jf, hf = (lds_filter(init, pairs, nodes) if filtered is None
                    else filtered)
    Jb, hb = lds_backward(pairs, nodes)
    return (logZ,) + smoother_assembly(pairs, nodes, Jf, hf, Jb, hb)


def lds_sample(init, pairs, nodes, generator, num_samples, filtered=None,
               eps=None):
    """Posterior samples (S, B, T, d) by the backward conditional recursion
    (port of pallas_kalman.lds_sample_pallas). ``filtered`` = (Jf, hf)
    reuses a filter pass; ``generator`` draws the (S, B, T, d) noise unless
    ``eps`` gives it."""
    _forward_only("lds_sample", init, pairs, nodes, filtered, eps)
    Jf, hf = (lds_filter(init, pairs, nodes)[1:] if filtered is None
              else filtered)
    eps = bpairs.sampler_noise(hf, generator, num_samples, eps)
    S, B, T, d = eps.shape
    args, xT = sampler_inputs(pairs, Jf, hf, eps)
    x = sampler_shared(*args)
    x_body = _unpack(x, (d,)).reshape(S, B, T - 1, d)
    return torch.cat([x_body, xT[:, :, None]], 2)


def lds_estep(init, pairs, nodes, generator, num_samples, eps=None):
    """One filter pass shared by the smoother and the sampler (port of
    pallas_kalman.lds_estep_pallas): ``(samples (S, B, T, d), (Ex, ExxT,
    Exnxt), logZ (B,))``."""
    filt = lds_filter(init, pairs, nodes)
    _, Ex, ExxT, Exnxt = lds_smoother(init, pairs, nodes, filtered=filt)
    samples = lds_sample(init, pairs, nodes, generator, num_samples,
                         filtered=filt[1:], eps=eps)
    return samples, (Ex, ExxT, Exnxt), filt[0]


def lds_filter_bpairs(init, pairs, nodes):
    """Forward filter on per-sequence pairs (port of
    pallas_kalman.lds_filter_pallas_bpairs): pairs (P1, P2, P3
    (B, T-1, d, d), Pc (B, T-1)); the forward launch of
    :func:`svae_tpu_torch.ops.bpairs.lds_filter`. Returns ``(logZ (B,),
    Jf, hf)``."""
    _forward_only("lds_filter_bpairs", init, pairs, nodes)
    return bpairs.lds_filter(init, pairs, nodes)
