"""SLDS-SVAE prior: a switching linear dynamical system (port of
svae_tpu/models/slds.py: the algebra of its ``backend="pallas"`` path and,
with ``parallel=``, of its ``backend="xla"`` one).

Generative model: a discrete Markov chain z_{1:T} over K states, with
Dirichlet priors on its initial distribution and on each transition row,
and a continuous chain x_{1:T} whose first state has a NIW-governed
Gaussian and whose step x_t -> x_{t+1} follows the linear-Gaussian
dynamics of state z_{t+1}, each under its own MNIW factor.

Global natparams: ``(init_dir (K,), trans_dir (K, K), niw, mniw)`` with
every leaf of the MNIW tuple batched over a leading K axis.

The E-step is a structured mean-field q(z) q(x) over a minibatch. It
alternates an x-step, the per-sequence-pairs LDS E-step of
:mod:`svae_tpu_torch.ops.bpairs` on the state-averaged pair potentials,
with a z-step, the HMM forward-backward of
:mod:`svae_tpu_torch.ops.hmm_fb` whose observations are each state's
expected pair energies under q(x). Warm sweeps run without a graph; the
last ``num_diff_iters`` sweeps and the final x- and z-steps carry the
gradient. On a card every recursion is a CUDA kernel, on the CPU a plain
twin. ``parallel=`` routes the sweeps to the parallel-in-time scans
instead (the JAX package's ``backend="xla"`` path): the log-depth trees
of :mod:`svae_tpu_torch.ops.kalman` and :mod:`svae_tpu_torch.ops.hmm`
for ``True``, the chunked element-scan kernels of
:mod:`svae_tpu_torch.ops.chunked` for the x-steps of a chunk count.
:func:`local_meanfield` serves one sequence; :func:`make_online_filter`
is the streaming GPB2 switching filter. The local KL reduces to

  local_kl = <L, r> + <psi, x-stats> - logZ_hmm - logZ_lds

with r the HMM node marginals, L the pair energies and psi the
recognition potentials.
"""

import functools
import math

import torch

from svae_tpu_torch.expfam import dirichlet, mniw, niw
from svae_tpu_torch.models import lds
from svae_tpu_torch.ops import bpairs, estep, hmm, kalman
from svae_tpu_torch.utils import smallchol
from svae_tpu_torch.utils.psd import eye_like, f32_linalg, symmetrize
from svae_tpu_torch.utils.pytree import tree_dot, tree_map, tree_sub


def init_pgm_param(K, d, generator, alpha=1.0, kappa_sticky=5.0,
                   niw_conc=10.0, mniw_conc=10.0, A_scale=0.9, Q_scale=0.1,
                   dtype=torch.float32, device=None):
    """Random globals: a sticky transition Dirichlet (``kappa_sticky`` on
    the diagonal), one NIW on the initial state and K MNIW dynamics
    factors, each centered on its own random rotation (which breaks the
    symmetry between the states). The random draws are made on
    ``generator``'s device and the result placed on ``device`` (default
    ``"cuda"``; pass ``"cpu"`` to run on the CPU)."""
    device = "cuda" if device is None else device
    kw = dict(dtype=dtype, device=device)
    init_dir = dirichlet.standard_to_natural(alpha * torch.ones(K, **kw))
    trans_dir = dirichlet.standard_to_natural(
        alpha * torch.ones((K, K), **kw) + kappa_sticky * torch.eye(K, **kw))
    niw_np = lds.init_pgm_param(d, generator, niw_conc=niw_conc, dtype=dtype,
                                device=device)[0]
    mniws = [lds.init_pgm_param(d, generator, mniw_conc=mniw_conc,
                                A_scale=A_scale, Q_scale=Q_scale,
                                dtype=dtype, device=device)[1]
             for _ in range(K)]
    mniw_np = tuple(torch.stack(leaves) for leaves in zip(*mniws))
    return (init_dir, trans_dir, niw_np, mniw_np)


def pgm_expectedstats(global_natparam):
    init_dir, trans_dir, niw_np, mniw_np = global_natparam
    return (dirichlet.expectedstats(init_dir),
            dirichlet.expectedstats(trans_dir), niw.expectedstats(niw_np),
            mniw.expectedstats(mniw_np))


def prior_kl(global_natparam, prior_natparam):
    """KL(q(theta) || p(theta)) over the four conjugate factors."""
    total = 0.0
    for q, p in zip(global_natparam[:2], prior_natparam[:2]):
        total = total + (((q - p) * dirichlet.expectedstats(q)).sum()
                         - dirichlet.logZ(q) + dirichlet.logZ(p))
    for fam, q, p in ((niw, global_natparam[2], prior_natparam[2]),
                      (mniw, global_natparam[3], prior_natparam[3])):
        total = total + (tree_dot(tree_sub(q, p), fam.expectedstats(q))
                         - fam.logZ(q).sum() + fam.logZ(p).sum())
    return total


# --------------------------------------------------------------------------
# the batched structured mean-field
# --------------------------------------------------------------------------


def _pair_energies_b(E_pair, x_pair_stats):
    """L[b, t, k]: the expected log-density of transition t under the
    dynamics of state k at q(x)'s pair statistics; (B, T-1, K)."""
    E1, E2, E3, const = E_pair
    ExxT_next, ExnT, ExxT_prev = x_pair_stats            # (B, T-1, d, d)
    return (torch.einsum("kij,btij->btk", E1, ExxT_next)
            + torch.einsum("kij,btij->btk", E2, ExnT)
            + torch.einsum("kij,btij->btk", E3, ExxT_prev) + const)


def _averaged_pairs_b(E_pair, r_next):
    """The state-averaged pair potentials sum_k r_{t+1,k} E_k per sequence
    and transition, ``r_next`` (B, T-1, K) -> (P1, P2, P3, Pc)."""
    E1, E2, E3, const = E_pair
    return (torch.einsum("btk,kij->btij", r_next, E1),
            torch.einsum("btk,kij->btij", r_next, E2),
            torch.einsum("btk,kij->btij", r_next, E3), r_next @ const)


def _x_pair_stats_b(Ex, ExxT, Exnxt):
    """(E[x' x'^T], E[x' x^T], E[x x^T]) per transition."""
    return ExxT[:, 1:], Exnxt.mT, ExxT[:, :-1]


def _expected_globals(global_natparam, dtype):
    """(e_pi0, e_Pi, chain init (I1, I2, Ic), E_pair) under q(theta)."""
    init_dir, trans_dir, niw_np, mniw_np = global_natparam
    (I1, I2), Ic = niw.expected_gaussian_natparam(niw_np)
    return tree_map(lambda a: a.to(dtype), (
        dirichlet.expectedstats(init_dir), dirichlet.expectedstats(trans_dir),
        (I1, I2, Ic), mniw.expected_pair_potential(mniw_np)))


def _uniform_rows(log_trans, pair_weights):
    """The discrete chain's (B, T-1, K, K) transitions of a ragged batch:
    ``log_trans`` at real transitions, uniform rows at pad transitions
    (each adds exactly 0 to logZ); ``log_trans`` itself for a full
    batch."""
    if pair_weights is None:
        return log_trans
    K = log_trans.shape[-1]
    w = pair_weights[..., None, None]
    return w * log_trans + (1.0 - w) * -math.log(K)


def _x_step(E_pair, chain_init, nodes, r_next, pair_weights=None,
            parallel=False):
    """q(x) given q(z)'s next-state marginals ``r_next`` (B, T-1, K): the
    per-sequence LDS smoother on the state-averaged pair potentials (the
    normalized dummy at pad transitions), on the route ``parallel`` names:
    the bpairs kernels for ``False``, else ``lds._route(parallel)``'s
    smoother (the log-depth tree for ``True``, the chunked element scans
    for a chunk count). Returns ``(logZ_x, pairs, (Ex, ExxT, Exnxt),
    filt)`` with filt the forward messages (Jf, hf) of the bpairs route
    (None on the others)."""
    pairs = _averaged_pairs_b(E_pair, r_next)
    if pair_weights is not None:
        pairs = lds.dummy_blend_pairs(pairs, pair_weights)
    if parallel:
        logZ_x, *moments = lds._route(parallel)[1](chain_init, pairs, nodes)
        return logZ_x, pairs, tuple(moments), None
    logZ_x, Jf, hf, Jb, hb = bpairs.fb_pass(chain_init, pairs, nodes)
    moments = estep.smoother_assembly(pairs, nodes, Jf, hf, Jb, hb)
    return logZ_x, pairs, moments, (Jf, hf)


def _log_obs(L):
    """The discrete chain's (B, T, K) observations: none at the first
    frame, the pair energies ``L`` (B, T-1, K) of its transition at every
    other."""
    return torch.cat([L.new_zeros(L.shape[0], 1, L.shape[2]), L], 1)


def _z_step(E_pair, e_pi0, log_trans, moments, pair_weights=None,
            parallel=False):
    """q(z) given q(x)'s ``moments``: the HMM forward-backward whose
    observations are the pair energies (zeroed at pad transitions), on the
    kernels for ``parallel=False``, else on the log-depth scans of
    :func:`~svae_tpu_torch.ops.hmm.hmm_posterior`. Returns ``(logZ_z, L,
    r, pair_sum, r1)``."""
    L = _pair_energies_b(E_pair, _x_pair_stats_b(*moments))
    if pair_weights is not None:
        L = L * pair_weights[..., None]
    logZ_z, r, pair_sum, r1 = hmm.hmm_posterior(
        e_pi0, log_trans, _log_obs(L), parallel=parallel,
        pair_weights=pair_weights)
    return logZ_z, L, r, pair_sum, r1


def _batched_meanfield(global_natparam, nn_potentials, num_iters=15,
                       num_diff_iters=1, pair_weights=None, parallel=False):
    """Structured mean-field for a minibatch (port of
    slds._batched_meanfield_pallas and, with ``parallel``, of the vmapped
    local_meanfield). ``nn_potentials`` = (J_diag, h), each (B, T, d).
    ``pair_weights`` (B, T-1) marks the real transitions of a ragged
    batch: pad transitions get the normalized dummy factors (N(0, I) on
    the continuous chain, uniform rows on the discrete one) and their pair
    energies are zeroed. ``parallel`` routes every x-step and z-step
    (:func:`_x_step`, :func:`_z_step`). From uniform q(z), ``num_iters``
    sweeps of an x-step and a z-step run, the first ``num_iters -
    num_diff_iters`` of them without a graph; then a final x-step and
    z-step. Returns ``(hmm_post, lds_post, local_kl)`` with ``hmm_post =
    (logZ_z, r, pair_sum, r1)`` and ``lds_post = (logZ_x, (init, pairs,
    nodes), (Ex, ExxT, Exnxt), filt)``."""
    J_diag, h = nn_potentials
    e_pi0, e_Pi, chain_init, E_pair = _expected_globals(global_natparam,
                                                        h.dtype)
    K = e_pi0.shape[0]
    N1 = -0.5 * torch.diag_embed(J_diag)
    nodes = (N1, h)
    log_trans = _uniform_rows(e_Pi, pair_weights)
    x_step = functools.partial(_x_step, E_pair, chain_init, nodes,
                               pair_weights=pair_weights, parallel=parallel)
    z_step = functools.partial(_z_step, E_pair, e_pi0, log_trans,
                               pair_weights=pair_weights, parallel=parallel)

    def sweep(r):
        return z_step(x_step(r[:, 1:])[2])[2]

    num_diff = min(num_diff_iters, num_iters)
    r = torch.full(h.shape[:2] + (K,), 1.0 / K, dtype=h.dtype,
                   device=h.device)
    with torch.no_grad():
        for _ in range(num_iters - num_diff):
            r = sweep(r)
    for _ in range(num_diff):
        r = sweep(r)

    logZ_x, pairs_bar, (Ex, ExxT, Exnxt), filt = x_step(r[:, 1:])
    logZ_z, L, r, pair_sum, r1 = z_step((Ex, ExxT, Exnxt))
    local_kl = ((r[:, 1:] * L).sum() + (N1 * ExxT).sum() + (h * Ex).sum()
                - logZ_z.sum() - logZ_x.sum())
    hmm_post = (logZ_z, r, pair_sum, r1)
    lds_post = (logZ_x, (chain_init, pairs_bar, nodes), (Ex, ExxT, Exnxt),
                filt)
    return hmm_post, lds_post, local_kl


@f32_linalg()
def local_meanfield(global_natparam, nn_potentials, num_iters=15,
                    num_diff_iters=1, parallel=False, pair_weight=None):
    """Structured mean-field for one sequence: :func:`_batched_meanfield`
    on a batch of one. ``nn_potentials`` = (J_diag, h), each (T, d);
    ``pair_weight`` (T-1,) {0,1} marks the real transitions of a sequence
    padded to T; ``parallel`` as in :func:`run_inference`. Returns the JAX
    package's ``(hmm_post, lds_post, local_kl)`` with ``hmm_post =
    (logZ_z, r (T, K), pair_sum (K, K), r1 (K,))`` and ``lds_post =
    (logZ_x, (init, pairs, nodes), (Ex, ExxT, Exnxt))``."""
    parallel = lds._check_parallel(parallel)
    one = lambda x: None if x is None else x[None]
    hmm_post, lds_post, local_kl = _batched_meanfield(
        global_natparam, tuple(x[None] for x in nn_potentials), num_iters,
        num_diff_iters, one(pair_weight), parallel)
    first = lambda tree: tuple(x[0] for x in tree)
    logZ_x, (chain_init, pairs, nodes), moments, _ = lds_post
    return (first(hmm_post),
            (logZ_x[0], (chain_init, first(pairs), first(nodes)),
             first(moments)), local_kl)


def _sample_x(lds_post, generator, num_samples, parallel, eps=None):
    """Samples (S, B, T, d) of the converged q(x): on the bpairs sampler
    from the final x-step's forward messages, or the E-step of
    ``lds._route(parallel)`` on its pairs."""
    _, (chain_init, pairs_bar, nodes), _, filt = lds_post
    if parallel:
        return lds._route(parallel)[0](chain_init, pairs_bar, nodes,
                                       generator, num_samples, eps=eps)[0]
    return bpairs.lds_sample(pairs_bar, filt, generator, num_samples,
                             eps=eps)


def _batched_inference(global_natparam, nn_potentials, generator,
                       num_samples, num_iters, num_diff_iters,
                       pair_weights=None, eps=None, parallel=False):
    """Mean-field, samples (S, B, T, d) from the converged q(x) and the
    statistics summed over the batch, with pad transitions weighted out
    (port of slds._batched_inference_pallas and of the vmapped
    _sequence_inference)."""
    hmm_post, lds_post, local_kl = _batched_meanfield(
        global_natparam, nn_potentials, num_iters, num_diff_iters,
        pair_weights, parallel)
    _, r, pair_sum, r1 = hmm_post
    Ex, ExxT, Exnxt = lds_post[2]
    samples = _sample_x(lds_post, generator, num_samples, parallel, eps)
    r_next = r[:, 1:]                                    # (B, T-1, K)
    if pair_weights is not None:
        r_next = r_next * pair_weights[..., None]
    cnt = torch.tensor(float(Ex.shape[0]), dtype=Ex.dtype, device=Ex.device)
    stats = (
        r1.sum(0), pair_sum.sum(0),
        (ExxT[:, 0].sum(0), Ex[:, 0].sum(0), cnt, cnt),
        (torch.einsum("btk,btij->kij", r_next, ExxT[:, 1:]),
         torch.einsum("btk,btij->kij", r_next, Exnxt.mT),
         torch.einsum("btk,btij->kij", r_next, ExxT[:, :-1]),
         r_next.sum((0, 1))),
    )
    return samples, stats, local_kl


@f32_linalg()
def run_inference(prior_natparam, global_natparam, nn_potentials, generator,
                  num_samples=1, num_meanfield_iters=15, num_diff_iters=1,
                  parallel=False, mask=None, lengths=None, eps=None):
    """E-step + sampling + KLs.

    ``nn_potentials`` = (J_diag, h), each (T, d) for one sequence or
    (B, T, d) for a minibatch. Returns ``(samples, stats, global_kl,
    local_kl)`` with the continuous samples (S, T, d) or (S, B, T, d) and
    the statistics (congruent with the globals) and local KL summed over
    the batch. ``generator`` draws the sampling noise; ``eps``
    (S, B, T, d) overrides it (tests). ``num_meanfield_iters`` sweeps run,
    the last ``num_diff_iters`` of them carrying the gradient. ``mask``:
    optional (T,) or (B, T) evidence mask (falsy frames are missing
    observations, bridged by the dynamics). ``lengths``: optional (B,)
    lengths of a batch padded to a common T (batched input only): pad
    transitions become normalized dummies on both chains and leave every
    statistic, so the result equals that of the unpadded sequences. Both
    compose. ``parallel``: ``False`` (or 0) runs every x-step on the
    bpairs kernels and every z-step on the HMM kernels; ``True`` the
    log-depth trees of :mod:`~svae_tpu_torch.ops.kalman` and
    :mod:`~svae_tpu_torch.ops.hmm` (torch ops); a chunk count C the
    chunked element scans of :mod:`~svae_tpu_torch.ops.chunked` for the
    x-steps and the HMM trees for the z-steps (the JAX package's
    ``backend="xla"`` path with the same ``parallel``). Raises
    ``FloatingPointError`` if a Cholesky factor failed (one host sync per
    call)."""
    parallel = lds._check_parallel(parallel)
    J_diag, h, batched = lds._prepare(nn_potentials, mask, lengths)
    pair_w = (None if lengths is None else
              lds._pair_weight(lengths, h.shape[1], h.dtype, h.device))
    samples, stats, local_kl = _batched_inference(
        global_natparam, (J_diag, h), generator, num_samples,
        num_meanfield_iters, num_diff_iters, pair_weights=pair_w, eps=eps,
        parallel=parallel)
    if not batched:
        samples = samples[:, 0]
    out = (samples, stats, prior_kl(global_natparam, prior_natparam),
           local_kl)
    smallchol.check_finite(out, "run_inference")
    return out


def _z_chain_inputs(global_natparam, moments, dtype):
    """``(e_pi0, e_Pi, log_obs (B, T, K))`` of the discrete chain under the
    converged mean-field: the pair energies at q(x)'s ``moments`` = (Ex,
    ExxT, Exnxt) become the HMM's observations."""
    e_pi0, e_Pi, _, E_pair = _expected_globals(global_natparam, dtype)
    return e_pi0, e_Pi, _log_obs(_pair_energies_b(
        E_pair, _x_pair_stats_b(*moments)))


def _converged_meanfield(global_natparam, J_diag, h, num_meanfield_iters,
                         parallel=False):
    """The structured mean-field with no gradient sweep, and the discrete
    chain's inputs under it: ``(lds_post, (e_pi0, e_Pi, log_obs))``."""
    _, lds_post, _ = _batched_meanfield(
        global_natparam, (J_diag, h), num_iters=num_meanfield_iters,
        num_diff_iters=0, parallel=parallel)
    return lds_post, _z_chain_inputs(global_natparam, lds_post[2], h.dtype)


@f32_linalg()
def most_likely_states(global_natparam, nn_potentials,
                       num_meanfield_iters=15, parallel=False, mask=None):
    """MAP discrete-state paths under the converged structured mean-field
    q(z): the Viterbi decode of the HMM factor whose observations are the
    pair energies at q(x). ``nn_potentials`` = (J_diag, h), (T, d) or
    (B, T, d); returns int32 paths (T,) or (B, T). ``parallel`` routes the
    mean-field as in :func:`run_inference` and runs the decode's messages
    as a max-plus tree when truthy. ``mask`` marks missing frames (their
    evidence zeroed; the decode bridges them through the dynamics). No
    gradient is taken."""
    parallel = lds._check_parallel(parallel)
    J_diag, h, batched = lds._prepare(nn_potentials, mask, None)
    with torch.no_grad():
        _, z_inputs = _converged_meanfield(global_natparam, J_diag, h,
                                           num_meanfield_iters, parallel)
        path, _ = hmm.hmm_viterbi(*z_inputs, parallel=parallel)
    return path if batched else path[0]


@f32_linalg()
def sample_states(global_natparam, nn_potentials, generator, num_samples=(),
                  num_meanfield_iters=15, parallel=False, mask=None,
                  gumbel_noise=None):
    """Posterior samples of the discrete paths under the converged
    structured mean-field q(z): Gumbel-argmax backward sampling
    (:func:`~svae_tpu_torch.ops.hmm.hmm_sample`) through the HMM factor
    whose observations are the pair energies at q(x). ``nn_potentials`` =
    (J_diag, h), (T, d) or (B, T, d); returns int32 paths S + (T,) or
    (B,) + S + (T,) (``num_samples`` an int or a shape tuple S).
    ``parallel`` routes the mean-field as in :func:`run_inference` and the
    sampler's backward messages (a suffix scan when truthy).
    ``gumbel_noise`` overrides the noise in ``hmm_sample``'s layout (B = 1
    for one sequence). ``mask`` marks missing frames. No gradient is
    taken."""
    parallel = lds._check_parallel(parallel)
    J_diag, h, batched = lds._prepare(nn_potentials, mask, None)
    with torch.no_grad():
        _, z_inputs = _converged_meanfield(global_natparam, J_diag, h,
                                           num_meanfield_iters, parallel)
        paths = hmm.hmm_sample(*z_inputs, generator, num_samples,
                               parallel=parallel, gumbel_noise=gumbel_noise)
    return paths if batched else paths[0]


@f32_linalg()
def predict(global_natparam, nn_potentials, generator, num_steps,
            num_samples=1, num_meanfield_iters=15, parallel=False, mask=None,
            eps=None, gumbel_noise=None, step_eps=None, step_gumbel=None):
    """Regime-switching forecast: condition on an observed window through
    the structured mean-field, sample joint posterior paths (z, x) of the
    window, then roll forward ``num_steps`` with z_{n+1} ~ Cat(E[Pi]_{z_n})
    (the posterior-mean transition rows of the Dirichlet factors) and
    x_{n+1} ~ N(E[A_k] x_n, E[Sigma_k]) at k = z_{n+1}
    (``mniw.posterior_mean_params``).

    ``nn_potentials`` = (J_diag, h), (T, d) or (B, T, d). Returns
    ``(x_traj, z_traj)``, (S, T + num_steps, d) and int32
    (S, T + num_steps), with a batch axis in front for a batch, as the JAX
    package's ``vmap`` lays them out. The window's x samples come from the
    converged q(x) through ``bpairs.lds_sample``, its z paths from
    :func:`~svae_tpu_torch.ops.hmm.hmm_sample`. ``generator`` draws the
    noise unless it is given, one override for each of the JAX package's
    four draws: ``eps`` (S, B, T, d) for the window's x, ``gumbel_noise``
    for its z paths (``hmm_sample``'s layout), ``step_eps``
    (num_steps, S, B, d) and ``step_gumbel`` (num_steps, S, B, K) for the
    rollout (B = 1 for one sequence). ``parallel`` routes the mean-field,
    the window's x samples (the E-step of ``lds._route(parallel)``) and
    its z paths as in :func:`run_inference` and :func:`sample_states`.
    ``mask`` marks missing frames. No gradient is taken."""
    parallel = lds._check_parallel(parallel)
    J_diag, h, batched = lds._prepare(nn_potentials, mask, None)
    _, trans_dir, _, mniw_np = global_natparam
    with torch.no_grad():
        # posterior-mean transition probabilities, not exp E[log Pi]: the
        # rollout wants a normalized predictive kernel
        alpha = dirichlet.natural_to_standard(trans_dir)
        log_Pi = torch.log(alpha / alpha.sum(-1, keepdim=True)).to(h.dtype)
        A_k, Sigma_k = tree_map(lambda a: a.to(h.dtype),
                                mniw.posterior_mean_params(mniw_np))
        Ls_k = smallchol.chol(Sigma_k)
        lds_post, z_inputs = _converged_meanfield(
            global_natparam, J_diag, h, num_meanfield_iters, parallel)
        xs = _sample_x(lds_post, generator, num_samples, parallel,
                       eps)                                # (S, B, T, d)
        zs = hmm.hmm_sample(*z_inputs, generator, num_samples,
                            parallel=parallel,
                            gumbel_noise=gumbel_noise)     # (B, S, T)
        S, B, _, d = xs.shape
        K = log_Pi.shape[-1]
        kw = dict(dtype=h.dtype, device=h.device)
        if step_eps is None:
            step_eps = torch.randn((num_steps, S, B, d), generator=generator,
                                   **kw)
        if step_gumbel is None:
            step_gumbel = hmm.gumbel((num_steps, S, B, K), generator, **kw)
        x_frames, z_frames = [xs], [zs.transpose(0, 1).long()]
        x, z = xs[:, :, -1], z_frames[0][:, :, -1]
        for e, g in zip(step_eps, step_gumbel):
            z = (log_Pi[z] + g).argmax(-1)
            x = ((A_k[z] @ x[..., None])[..., 0]
                 + (Ls_k[z] @ e[..., None])[..., 0])
            x_frames.append(x[:, :, None])
            z_frames.append(z[:, :, None])
    x_traj = torch.cat(x_frames, 2).transpose(0, 1)
    z_traj = torch.cat(z_frames, 2).transpose(0, 1).to(torch.int32)
    return (x_traj, z_traj) if batched else (x_traj[0], z_traj[0])


# --------------------------------------------------------------------------
# the streaming (serving-side) switching filter
# --------------------------------------------------------------------------


def _collapse(w, mean, cov):
    """Moment-match a weighted Gaussian mixture to one Gaussian: ``w``
    (..., J) normalized over its last axis, ``mean`` (..., J, d), ``cov``
    (..., J, d, d) -> (..., d), (..., d, d)."""
    m = torch.einsum("...j,...jd->...d", w, mean)
    dm = mean - m[..., None, :]
    C = (torch.einsum("...j,...jde->...de", w, cov)
         + torch.einsum("...j,...jd,...je->...de", w, dm, dm))
    return m, symmetrize(C)


def make_online_filter(global_natparam, dtype=torch.float32):
    """Streaming switching-state filter: one frame's recognition potentials
    in at a time; the regime probabilities, the filtered latent posterior
    and the incremental predictive log-evidence ``log p(y_t | y_{1:t-1})``
    out. Exact inference is exponential in T, so this is the GPB2
    (interacting-multiple-model) collapse of the JAX package: one filtered
    Gaussian a regime and the regime weights are carried, the K x K
    transition branches expanded with the expected dynamics under q(theta)
    (the ``exp E[log]`` potentials of the mean-field), and each
    destination regime's branch mixture moment-matched back to one
    Gaussian. At K=1 it is the LDS online filter
    (:func:`svae_tpu_torch.models.lds.make_online_filter`).

    Returns ``(init_fn, step_fn)``::

      state, (w, mean, cov, logev) = init_fn((J_diag_1, h_1))
      state, (w, mean, cov, logev) = step_fn(state, (J_diag_t, h_t))

    ``(J_diag_t, h_t)`` are (..., d): any leading axes serve that many
    streams at once. ``w`` (..., K) is q(z_t), ``(mean, cov)`` the
    regime-collapsed filtered posterior of x_t, ``logev`` (...) the
    predictive log-evidence increment. Both run in ``dtype`` on the
    globals' device, with no TF32."""
    e_pi0, e_Pi, (I1, I2, Ic), (E1, E2, E3, Ec) = _expected_globals(
        global_natparam, dtype)
    K, d = E2.shape[0], E2.shape[-1]

    def _regime_outputs(w, J, h):
        return _collapse(w, *lds._mean_cov(J, h))

    @f32_linalg()
    def init_fn(potentials):
        n1, n2 = lds._frame_nodes(potentials, dtype)
        J1 = -2.0 * (I1 + n1)
        h1 = I2 + n2
        logZ1 = kalman._gauss_logZ_info(J1, h1, Ic)
        lead = h1.shape[:-1]
        logw = torch.log_softmax(e_pi0, -1).expand(lead + (K,))
        w = torch.exp(logw)
        logev = logZ1 + torch.logsumexp(e_pi0, -1)
        J = J1[..., None, :, :].expand(lead + (K, d, d))
        h = h1[..., None, :].expand(lead + (K, d))
        mean, cov = _regime_outputs(w, J, h)
        return (logw, J, h), (w, mean, cov, logev)

    @f32_linalg()
    def step_fn(state, potentials):
        logw, J, h = state                  # (..., K), (..., K, d, d), ...
        n1, n2 = lds._frame_nodes(potentials, dtype)
        lead = n2.shape[:-1]
        mat, vec = lead + (K, K, d, d), lead + (K, K, d)
        # each regime's Gaussian is carried normalized: the constant c_j =
        # -logZ(J_j, h_j, 0) goes into its branches' c slot
        cnorm = -kalman._gauss_logZ_info(J, h, J.new_zeros(lead + (K,)))
        # branch (j -> k), axes (..., j, k): one chain leaf on (x_t,
        # x_{t+1}) under regime k's expected dynamics, regime j's
        # normalized filtered potential in its (J11, h1) slots: the LDS
        # online step a branch
        e = ((-2.0 * E3 + J[..., :, None, :, :]).expand(mat),
             (-E2.mT).expand(mat),
             (-2.0 * (E1 + n1[..., None, :, :]))[..., None, :, :, :].expand(
                 mat),
             h[..., :, None, :].expand(vec),
             n2[..., None, None, :].expand(vec),
             Ec + cnorm[..., :, None])
        Jb, hb, cb = kalman.marginalize_first(e)
        logZb = kalman._gauss_logZ_info(Jb, hb, cb)         # (..., j, k)
        # branch log-weights; the carried Gaussians are normalized, so
        # logZb is the branch's evidence increment
        lw = logw[..., :, None] + e_Pi + logZb
        logev = torch.logsumexp(lw, (-2, -1))
        lw = lw - logev[..., None, None]
        logw_new = torch.logsumexp(lw, -2)                   # (..., k)
        # each destination k's responsibilities over the source j, and its
        # branch mixture collapsed over j
        r = torch.exp(lw - logw_new[..., None, :])
        means, covs = lds._mean_cov(Jb, hb)
        mean_k, cov_k = _collapse(r.mT, means.transpose(-3, -2),
                                  covs.transpose(-4, -3))
        # back to normalized information form
        Lc = smallchol.chol(cov_k)
        J_new = symmetrize(smallchol.cho_solve_mat(Lc, eye_like(cov_k)))
        h_new = torch.einsum("...kde,...ke->...kd", J_new, mean_k)
        # the emitted weights renormalized: logsumexp keeps them within
        # ~1e-4 of the simplex in float32, and the outputs sum to 1
        w = torch.exp(logw_new)
        w = w / w.sum(-1, keepdim=True)
        mean, cov = _collapse(w, mean_k, cov_k)
        return (logw_new, J_new, h_new), (w, mean, cov, logev)

    return init_fn, step_fn
