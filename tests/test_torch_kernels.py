"""The CUDA kernels of svae_tpu_torch/csrc/*.cu against their plain
versions, on a card. Every test is marked ``gpu`` and skips on a host
without one. The file imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Kernels run in float32, plain versions in float64 on the same inputs; the
tolerances are chip_smoke.py's (the float32 tiers of
tests/test_f32_parity.py, and a normwise 1e-3 for the adjoints)."""

import ctypes
import os
import sys

import pytest
import torch

from svae_tpu_torch.models import lds
from svae_tpu_torch.ops import bpairs, chunked, estep, hmm_fb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.gpu


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("shape", ["small", "config2"])
def test_kernels_match_twins(smoke, shape):
    smoke.check_kernels(smoke.SHAPES[shape], seed=0)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_kernels_match_twins_at_every_built_d(smoke, d):
    smoke.check_kernels(dict(B=5, T=9, d=d, S=3), seed=d)


def test_estep_on_card_matches_cpu_twins(smoke):
    init, mats, nodes, eps = smoke._problem(dict(B=7, T=12, d=4, S=2), 1,
                                            "cuda")
    f32 = smoke._f32
    samples, stats, lkl = estep.lds_estep_stationary(
        f32(init), f32(mats), f32(nodes), None, 2, eps=eps.float())
    cpu = lambda xs: tuple(x.cpu() for x in xs)
    samples_r, stats_r, lkl_r = estep.lds_estep_stationary(
        cpu(init), cpu(mats), cpu(nodes), None, 2, eps=eps.cpu())
    assert float((samples.double().cpu() - samples_r).abs().max()) < 2e-3
    assert abs(float(lkl) - float(lkl_r)) / abs(float(lkl_r)) < 2e-4
    for a, b in zip(stats[0] + stats[1], stats_r[0] + stats_r[1]):
        assert float((a.double().cpu() - b).abs().max()) <= (
            2e-4 * float(b.abs().max()))


def test_wrappers_reject_what_the_kernels_do_not_take(smoke):
    init, mats, nodes, _ = smoke._problem(smoke.SHAPES["small"], 0, "cuda")
    fin = estep.filter_inputs(init, mats, nodes)
    with pytest.raises(TypeError, match="float32"):
        estep.filter_fwd(*fin)
    f32 = list(smoke._f32(fin))
    strided = list(f32)
    strided[5] = f32[5].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        estep.filter_fwd(*strided)
    mixed = list(f32)
    mixed[2] = f32[2].cpu()
    with pytest.raises(ValueError, match="CUDA"):
        estep.filter_fwd(*mixed)
    init5, mats5, nodes5, _ = smoke._problem(dict(B=3, T=7, d=5, S=2), 0,
                                             "cuda")
    with pytest.raises(ValueError, match="d=5"):
        estep.filter_fwd(*smoke._f32(estep.filter_inputs(init5, mats5,
                                                         nodes5)))


def test_launch_counters_count_launches(smoke):
    init, mats, nodes, eps = smoke._problem(smoke.SHAPES["small"], 0, "cuda")
    f32 = smoke._f32
    before = (estep.filter_fwd.launches, estep.sampler_fwd.launches,
              estep.filter_fwd_plain.calls, estep.sampler_fwd_plain.calls)
    estep.lds_estep_stationary(f32(init), f32(mats), f32(nodes), None, 2,
                               eps=eps.float())
    torch.cuda.synchronize()
    after = (estep.filter_fwd.launches, estep.sampler_fwd.launches,
             estep.filter_fwd_plain.calls, estep.sampler_fwd_plain.calls)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_sampler_fwd_passes_match_plain_at_every_built_d(smoke, d):
    """Each pass of the forward sampler (estep.sampler_fwd_factor,
    sampler_fwd_chain) against its own plain version."""
    sin = smoke.sampler_problem(dict(B=5, T=9, d=d, S=3), seed=d)
    errs = smoke.check_sampler_fwd_passes(sin)
    assert len(errs) == len(smoke.FWD_PASS_WRAPPERS)
    assert all(e <= smoke.TOL_ABS for e in errs.values()), errs


def test_sampler_fwd_pass_launch_counters_count_launches(smoke):
    sin = smoke.sampler_problem(smoke.SHAPES["small"], seed=0)
    smoke._reset_counters()
    smoke.check_sampler_fwd_passes(sin)
    assert [w.launches for w in smoke.FWD_PASS_WRAPPERS] == [1, 1]
    assert [p.calls for p in smoke.FWD_PASS_PLAINS] == [1, 1]
    assert estep.sampler_fwd.launches == 0
    # sampler_fwd launches both passes' kernels in one C call of its own,
    # and counts that call alone
    estep.sampler_fwd(*smoke._f32(sin))
    torch.cuda.synchronize()
    assert [w.launches for w in smoke.FWD_PASS_WRAPPERS] == [1, 1]
    assert estep.sampler_fwd.launches == 1
    assert estep.sampler_fwd_plain.calls == 0


def test_forward_kernels_in_the_stiff_case(smoke):
    """Node precisions over [1e-2, 1e3] at config-2 width: each forward
    kernel's error against float64 at most twice the float32 plain
    version's on the card."""
    errs = smoke.check_stiff()
    assert all(k <= smoke.STIFF_FACTOR * p for k, p in errs.values()), errs


def test_non_spd_step_gives_non_finite_outputs(smoke):
    """A non-positive pivot poisons the filter's step, its lane's ln and
    the sampler's samples that it reaches, and nothing else."""
    counts = smoke.check_non_spd()
    assert all(n > 0 for n in counts.values()), counts


@pytest.mark.parametrize("shape", ["small", "config2"])
def test_adjoints_match_plain(smoke, shape):
    smoke.check_adjoints(smoke.SHAPES[shape], seed=0)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_adjoints_match_plain_at_every_built_d(smoke, d):
    smoke.check_adjoints(dict(B=5, T=9, d=d, S=3), seed=d)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_adjoint_passes_match_plain_at_every_built_d(smoke, d):
    """Each pass of the two adjoints (estep.filter_adj_factor, ...) against
    its own plain version."""
    errs = smoke.check_adjoint_passes(
        *smoke.adjoint_problem(dict(B=5, T=9, d=d, S=3), seed=d))
    assert len(errs) == len(smoke.PASS_WRAPPERS)
    assert all(rel <= smoke.TOL_ADJ_REL for rel, _ in errs.values()), errs


def test_adjoint_pass_launch_counters_count_launches(smoke):
    problem = smoke.adjoint_problem(smoke.SHAPES["small"], seed=0)
    smoke._reset_counters()
    smoke.check_adjoint_passes(*problem)
    assert [w.launches for w in smoke.PASS_WRAPPERS] == [1] * 5
    assert [p.calls for p in smoke.PASS_PLAINS] == [1] * 5
    assert [w.launches for w in smoke.WRAPPERS] == [0] * 4


def _estep_grads(init, mats, nodes, eps):
    """Gradients of a fixed scalar of the E-step's outputs with respect to
    its inputs (init, pair matrices, jd, h)."""
    leaves = [x.detach().clone().requires_grad_()
              for x in (*init, *mats, *nodes)]
    init, mats, nodes = leaves[:3], leaves[3:7], leaves[7:]
    s, (niw_s, mniw_s), kl = estep.lds_estep_stationary(
        init, mats, nodes, None, eps.shape[0], eps=eps)
    parts = (s, niw_s[0], niw_s[1], mniw_s[0], mniw_s[1], mniw_s[2], kl)
    g = torch.Generator().manual_seed(4)
    w = [torch.randn(p.shape, generator=g, dtype=torch.float64) for p in parts]
    loss = sum((wi.to(p) * p).sum() for wi, p in zip(w, parts))
    return torch.autograd.grad(loss, leaves)


def test_estep_gradients_on_card_match_cpu_twins(smoke):
    """The Functions' backward (the adjoint kernels) against torch's
    autograd through the float64 twins on the CPU."""
    init, mats, nodes, eps = smoke._problem(dict(B=7, T=12, d=4, S=2), 1,
                                            "cuda")
    f32 = smoke._f32
    got = _estep_grads(f32(init), f32(mats), f32(nodes), eps.float())
    cpu = lambda xs: tuple(x.cpu() for x in xs)
    want = _estep_grads(cpu(init), cpu(mats), cpu(nodes), eps.cpu())
    for a, b in zip(got, want):
        assert float((a.double().cpu() - b).norm() / b.norm()) < 1e-3


def test_adjoint_launch_counters_count_launches(smoke):
    init, mats, nodes, eps = smoke._problem(smoke.SHAPES["small"], 0, "cuda")
    f32 = smoke._f32
    smoke._reset_counters()
    _estep_grads(f32(init), f32(mats), f32(nodes), eps.float())
    torch.cuda.synchronize()
    assert [w.launches for w in smoke.WRAPPERS] == [1, 1, 1, 1]
    assert [p.calls for p in smoke.PLAINS] == [0, 0, 0, 0]


@pytest.mark.parametrize("shape", ["small", "ragged"])
def test_bpairs_kernels_match_plain(smoke, shape):
    smoke.check_bpairs(smoke.RAGGED_SHAPES[shape], seed=0)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_bpairs_kernels_match_plain_at_every_built_d(smoke, d):
    smoke.check_bpairs(dict(B=5, T=9, d=d, S=3), seed=d)


def _ragged_grads(init, mats, nodes, eps, lengths):
    """Gradients of a fixed scalar of the per-sequence-pairs E-step's
    outputs with respect to the node potentials (N1, N2) of a ragged
    batch."""
    jd, h, _ = lds._prepare(nodes, None, lengths)
    pairs, (N1, N2) = lds._chain(mats, (jd, h), lengths)
    N1, N2 = (x.detach().clone().requires_grad_() for x in (N1, N2))
    s, moments, logZ = bpairs.lds_estep(init, pairs, (N1, N2), None,
                                        eps.shape[0], eps=eps)
    parts = (s,) + moments + (logZ,)
    g = torch.Generator().manual_seed(5)
    w = [torch.randn(p.shape, generator=g, dtype=torch.float64) for p in parts]
    loss = sum((wi.to(p) * p).sum() for wi, p in zip(w, parts))
    return torch.autograd.grad(loss, (N1, N2))


def test_ragged_estep_gradients_on_card_match_cpu_twins(smoke):
    """BidirFwd / SamplerBp on the card (the four bpairs kernels, one launch
    each, no plain version) against torch's autograd through the float64
    twins on the CPU."""
    init, mats, nodes, eps = smoke._problem(dict(B=7, T=12, d=4, S=2), 1,
                                            "cuda")
    lengths = torch.tensor([12, 9, 2, 12, 5, 7, 11], device="cuda")
    f32 = smoke._f32
    smoke._reset_counters()
    got = _ragged_grads(f32(init), f32(mats), f32(nodes), eps.float(),
                        lengths)
    torch.cuda.synchronize()
    assert [w.launches for w in smoke.RAGGED_WRAPPERS] == [1, 1, 1, 1]
    assert [p.calls for p in smoke.RAGGED_PLAINS] == [0, 0, 0, 0]
    cpu = lambda xs: tuple(x.cpu() for x in xs)
    want = _ragged_grads(cpu(init), cpu(mats), cpu(nodes), eps.cpu(),
                         lengths.cpu())
    for a, b in zip(got, want):
        assert float((a.double().cpu() - b).norm() / b.norm()) < 1e-3


def test_bpairs_wrappers_reject_what_the_kernels_do_not_take(smoke):
    filt, samp, _ = smoke.bpairs_problem(smoke.RAGGED_SHAPES["small"], 0,
                                         "cuda")
    with pytest.raises(TypeError, match="float32"):
        bpairs.bidir_fwd(*filt[:8])
    with pytest.raises(TypeError, match="float32"):
        bpairs.sampler_bp_adj(*samp)
    mixed = list(smoke._f32(filt[:8]))
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError, match="CUDA"):
        bpairs.bidir_fwd(*mixed)
    filt5, _, _ = smoke.bpairs_problem(dict(B=3, T=7, d=5, S=1), 0, "cuda")
    with pytest.raises(ValueError, match="d=5"):
        bpairs.bidir_adj(*smoke._f32(filt5))


HMM_CASES = [("small", "stationary"), ("slds", "stationary"),
             ("slds", "ragged"), ("slds", "forced"),
             ("measure_hmm", "stationary")]


@pytest.mark.parametrize("shape,case", HMM_CASES)
def test_hmm_kernels_match_plain(smoke, shape, case):
    smoke.check_hmm(smoke.HMM_SHAPES[shape], case)


@pytest.mark.parametrize("K", hmm_fb.KERNEL_STATES)
def test_hmm_kernels_match_plain_at_every_built_K(smoke, K):
    """Every kernel and each pass of ``hmm_fb_adj`` (check_hmm) at every
    built K: B=5 leaves the last warp of the chain kernels part-full, and
    K=3 a lane of each chain's segment idle."""
    smoke.check_hmm(dict(B=5, T=9, K=K), seed=K)


def _hazard(name):
    """tests/test_pallas_hmm.py's two hazards in float64: sharp messages
    (sticky transitions, evidence 40 N(0, 1)) and a near-forbidden switch
    forced by the observations."""
    f64 = dict(dtype=torch.float64)
    if name == "sharp":
        g = torch.Generator().manual_seed(2)
        return (torch.full((3,), 1.0 / 3.0, **f64).log(),
                torch.log(0.999 * torch.eye(3, **f64) + 1e-3),
                40.0 * torch.randn((2, 12, 3), generator=g, **f64))
    lt = torch.log(torch.tensor([[0.999, 0.001], [0.001, 0.999]], **f64))
    lt[0, 1] = -100.0
    lo = torch.tensor([[50.0, -50.0]] * 3 + [[-50.0, 50.0]] * 3, **f64)
    return torch.log(torch.tensor([0.999, 0.001], **f64)), lt, lo[None]


@pytest.mark.parametrize("name", ["sharp", "forced"])
def test_hmm_hazards_on_card_in_float32(smoke, name):
    """The hazards on the kernels in float32: values and gradients finite,
    node marginals within the moments tier of the float64 CPU path, and
    the forced switch counted once; then each pass of ``hmm_fb_adj`` on the
    hazard's packed inputs: finite, every weight in [0, 1], and together
    the whole adjoint's outputs."""
    li, lt, lo = _hazard(name)
    lo32 = lo.float().cuda().requires_grad_()
    out = hmm_fb.hmm_posterior(li.float().cuda(), lt.float().cuda(), lo32)
    (g,) = torch.autograd.grad(out[0].sum() + (out[1] ** 2).sum(), [lo32])
    assert all(bool(torch.isfinite(x).all()) for x in (*out, g))
    ref = hmm_fb.hmm_posterior(li, lt, lo)
    node = out[1].detach().double().cpu()
    assert float((node - ref[1]).abs().max()) <= smoke.TOL_ABS
    if name == "forced":
        assert 0.9 < float(out[2][0, 0, 1]) < 1.1

    a0, M = smoke._f32(smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_fwd"])
    a0, M = a0.cuda(), M.cuda()
    alpha, beta = hmm_fb.hmm_fb_fwd(a0, M)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dalpha, dbeta = (torch.randn(x.shape, generator=gen, device="cuda")
                     for x in (alpha, beta))
    W, V = hmm_fb.hmm_fb_adj_weights(a0, M, alpha, beta)
    gg, hh, da0 = hmm_fb.hmm_fb_adj_chain(W, V, dalpha, dbeta)
    dM = hmm_fb.hmm_fb_adj_dM(W, V, gg, hh)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in (W, V, gg, hh, da0, dM))
    assert all(bool(((x >= 0) & (x <= 1)).all()) for x in (W, V))
    whole = hmm_fb.hmm_fb_adj(a0, M, alpha, beta, dalpha, dbeta)
    assert torch.equal(whole[0], da0) and torch.equal(whole[1], dM)


def test_hmm_stationary_path(smoke):
    smoke.hmm_stationary_path()


def test_slds_training_on_card_matches_cpu(smoke):
    """A small SLDS run on the card: the launch schedule of every step,
    one step and one ragged step against the float64 CPU path, and the
    padded-batch theorem."""
    cfg = dict(smoke.SLDS_CONFIG, N=24, B=6, T=12, sweeps=3)
    smoke.slds_path(cfg=cfg)
    smoke.slds_padded_theorem(lengths=(5, 12), cfg=cfg)


def test_hmm_wrappers_reject_what_the_kernels_do_not_take(smoke):
    li, lt, lo, _ = smoke.hmm_problem(smoke.HMM_SHAPES["small"], 0, "cuda")
    args = smoke.hmm_kernel_args(li, lt, lo)
    with pytest.raises(TypeError, match="float32"):
        hmm_fb.hmm_fb_fwd(*args["hmm_fb_fwd"])
    mixed = list(smoke._f32(args["hmm_fb_stat_fwd"]))
    mixed[1] = mixed[1].cpu()
    with pytest.raises(ValueError, match="CUDA"):
        hmm_fb.hmm_fb_stat_fwd(*mixed)
    li, lt, lo, _ = smoke.hmm_problem(dict(B=3, T=7, K=5), 0, "cuda")
    with pytest.raises(ValueError, match="K=5"):
        hmm_fb.hmm_fb_fwd(*smoke._f32(smoke.hmm_kernel_args(
            li, lt, lo)["hmm_fb_fwd"]))


@pytest.mark.parametrize("shape", ["small", "config2"])
def test_elem_scan_kernels_match_plain(smoke, shape):
    smoke.check_elem_scan(smoke.ELEM_SHAPES[shape], seed=0)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_elem_scan_kernels_match_plain_at_every_built_d(smoke, d):
    smoke.check_elem_scan(dict(B=7, T=20, d=d, C=3), seed=d)


def test_chunked_training_on_card_matches_cpu(smoke):
    """Two small chunked (parallel=8) train steps on the card: four
    launches of each element-scan kernel a step, nothing else, and one
    step against the float64 CPU path."""
    smoke.chunked_train_path(B=6, T=30, steps=2)


def test_elem_scan_wrappers_reject_what_the_kernels_do_not_take(smoke):
    leaves = smoke.elem_problem(smoke.ELEM_SHAPES["small"], 0, "cuda")
    with pytest.raises(TypeError, match="float32"):
        chunked.elem_scan(leaves)
    f32 = leaves.float()
    with pytest.raises(ValueError, match="CUDA"):
        chunked.elem_scan_adj(f32, f32.cpu(), f32)
    with pytest.raises(ValueError, match="contiguous"):
        chunked.elem_scan(f32.transpose(0, 2).contiguous().transpose(0, 2))
    with pytest.raises(ValueError, match="inconsistent"):
        chunked.elem_scan(f32[:, :-1].contiguous())
    d5 = smoke.elem_problem(dict(B=3, T=7, d=5, C=2), 0, "cuda")
    with pytest.raises(ValueError, match="d=5"):
        chunked.elem_scan(d5.float())


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_scan_and_bidir_adjoint_passes_match_plain_at_every_built_d(smoke,
                                                                    d):
    """Each pass of the element scan's and the bidirectional filter's
    adjoints (chunked.elem_scan_adj_factor, elem_scan_adj_chain;
    bpairs.bidir_adj_factor, bidir_adj_chain) against its own plain
    version."""
    errs = smoke.check_elem_scan(dict(B=7, T=20, d=d, C=3), seed=d)
    filt = smoke.bpairs_problem(dict(B=5, T=9, d=d, S=1), seed=d)[0]
    errs.update(smoke.check_bidir_adj(filt))
    names = [w.__name__ for w in smoke.CHUNK_PASS_WRAPPERS
             + smoke.RAGGED_PASS_WRAPPERS]
    assert all(errs[k][0] <= smoke.TOL_ADJ_REL for k in names), errs


def test_bidir_adj_and_its_passes_at_their_other_shapes(smoke):
    """The slds_synth x-step's lanes and one direction's lanes at T=2048."""
    errs = smoke.check_bidir_adj_shapes()
    assert set(errs) == set(smoke.BIDIR_ADJ_SHAPES)


def test_scan_and_bidir_adjoint_pass_launch_counters(smoke):
    leaves = smoke.elem_problem(smoke.ELEM_SHAPES["small"], 0, "cuda")
    filt = smoke.bpairs_problem(smoke.RAGGED_SHAPES["small"], 0, "cuda")[0]
    smoke._reset_counters()
    smoke.check_elem_scan(smoke.ELEM_SHAPES["small"], seed=0)
    smoke.check_bidir_adj(filt)
    passes = smoke.CHUNK_PASS_WRAPPERS + smoke.RAGGED_PASS_WRAPPERS
    assert [w.launches for w in passes] == [1] * 4
    assert [p.calls for p in smoke.CHUNK_PASS_PLAINS
            + smoke.RAGGED_PASS_PLAINS] == [1] * 4
    # each adjoint launches its passes' kernels in one C call of its own,
    # and counts that call alone
    assert chunked.elem_scan_adj.launches == 1
    assert bpairs.bidir_adj.launches == 1
    pref = chunked.elem_scan_plain(leaves)
    chunked.elem_scan_adj(*smoke._f32((leaves, pref, pref)))
    bpairs.bidir_adj(*smoke._f32(filt))
    torch.cuda.synchronize()
    assert [w.launches for w in passes] == [1] * 4
    assert chunked.elem_scan_adj.launches == 2
    assert bpairs.bidir_adj.launches == 2


def test_scan_and_bidir_adjoint_c_entries_reject_what_they_do_not_take(
        smoke):
    """Every C entry of the two adjoints refuses an unbuilt d
    (cudaErrorInvalidValue) before it reads a pointer, and every wrapper
    refuses float64, mixed devices and an unbuilt d."""
    from svae_tpu_torch.ops import _build
    lib = _build.load_library()
    for name in ("svae_elem_scan_adj_f32", "svae_elem_scan_adj_factor_f32",
                 "svae_elem_scan_adj_chain_f32", "svae_bidir_adj_f32",
                 "svae_bidir_adj_factor_f32", "svae_bidir_adj_chain_f32"):
        fn = getattr(lib, name)
        ints = sum(t is ctypes.c_int for t in fn.argtypes)
        assert fn(5, *[3] * (ints - 1),
                  *[None] * (len(fn.argtypes) - ints)) != 0, name
    leaves = smoke.elem_problem(smoke.ELEM_SHAPES["small"], 0, "cuda")
    pref = chunked.elem_scan_plain(leaves)
    fac = chunked.elem_scan_adj_factor(*smoke._f32((leaves, pref)))
    filt = smoke.bpairs_problem(smoke.RAGGED_SHAPES["small"], 0, "cuda")[0]
    bfac = bpairs.bidir_adj_factor(*smoke._f32(filt[:10]))
    with pytest.raises(TypeError, match="float32"):
        chunked.elem_scan_adj_factor(leaves, pref)
    with pytest.raises(ValueError, match="CUDA"):
        chunked.elem_scan_adj_chain(fac, pref.float().cpu())
    with pytest.raises(TypeError, match="float32"):
        bpairs.bidir_adj_factor(*filt[:10])
    with pytest.raises(ValueError, match="CUDA"):
        bpairs.bidir_adj_chain(bfac, *[x.float().cpu() for x in filt[10:]])
    d5 = smoke.elem_problem(dict(B=3, T=7, d=5, C=2), 0, "cuda").float()
    with pytest.raises(ValueError, match="d=5"):
        chunked.elem_scan_adj_factor(d5, d5)
    filt5 = smoke.bpairs_problem(dict(B=3, T=7, d=5, S=1), 0, "cuda")[0]
    with pytest.raises(ValueError, match="d=5"):
        bpairs.bidir_adj_factor(*smoke._f32(filt5[:10]))


def test_bidir_fwd_at_its_other_shapes_and_cases(smoke):
    """The slds_synth x-step's 32 lanes (d=4, T=80), one direction's lanes
    at T=2048, C with its upper triangle perturbed (J written with C in
    full, the carry on C's lower triangle) and an indefinite step (its
    lane's J, h and ln non-finite from there, every other lane finite)."""
    errs = smoke.check_bidir_fwd()
    assert set(errs) == {"slds", "one_direction", "asymmetric_C", "non_spd"}
    assert errs["non_spd"] > 0


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_sampler_bp_adj_passes_match_plain_at_every_built_d(smoke, d):
    """Each pass of the per-sequence sampler's adjoint
    (bpairs.sampler_bp_adj_factor, sampler_bp_adj_chain,
    sampler_bp_adj_dJc) against its own plain version."""
    samp = smoke.bpairs_problem(dict(B=5, T=9, d=d, S=2), seed=d)[1]
    errs = smoke.check_sampler_bp_adj_passes(samp)
    assert len(errs) == len(smoke.SAMPLER_BP_PASS_WRAPPERS)
    assert all(rel <= smoke.TOL_ADJ_REL for rel, _ in errs.values()), errs


@pytest.mark.parametrize("S", [1, 2])
def test_sampler_bp_adj_sums_the_samples_of_a_sequence(smoke, S):
    """The composed adjoint (one C call, three passes) at one and two
    samples a sequence, at the ragged width."""
    samp = smoke.bpairs_problem(dict(B=64, T=40, d=10, S=S), seed=S)[1]
    got = bpairs.sampler_bp_adj(*smoke._f32(samp))
    torch.cuda.synchronize()
    rel, _ = smoke._rel_err(got, bpairs.sampler_bp_adj_plain(*samp))
    assert rel <= smoke.TOL_ADJ_REL


def test_sampler_bp_adj_pass_launch_counters(smoke):
    samp = smoke.bpairs_problem(smoke.RAGGED_SHAPES["small"], 0)[1]
    smoke._reset_counters()
    smoke.check_sampler_bp_adj_passes(samp)
    assert [w.launches for w in smoke.SAMPLER_BP_PASS_WRAPPERS] == [1] * 3
    assert [p.calls for p in smoke.SAMPLER_BP_PASS_PLAINS] == [1] * 3
    assert bpairs.sampler_bp_adj.launches == 0
    # sampler_bp_adj launches the three passes' kernels in one C call of
    # its own, and counts that call alone
    bpairs.sampler_bp_adj(*smoke._f32(samp))
    torch.cuda.synchronize()
    assert [w.launches for w in smoke.SAMPLER_BP_PASS_WRAPPERS] == [1] * 3
    assert bpairs.sampler_bp_adj.launches == 1
    assert bpairs.sampler_bp_adj_plain.calls == 0


def test_bpairs_c_entries_reject_an_unbuilt_d(smoke):
    """The C entries of bidir_fwd and of sampler_bp_adj and its passes
    refuse d=5 (cudaErrorInvalidValue) before they read a pointer, and the
    pass wrappers refuse float64, mixed devices and d=5."""
    from svae_tpu_torch.ops import _build
    lib = _build.load_library()
    for name in ("svae_bidir_fwd_f32", "svae_sampler_bp_adj_f32",
                 "svae_sampler_bp_adj_factor_f32",
                 "svae_sampler_bp_adj_chain_f32",
                 "svae_sampler_bp_adj_dJc_f32"):
        fn = getattr(lib, name)
        ints = sum(t is ctypes.c_int for t in fn.argtypes)
        assert fn(5, *[3] * (ints - 1),
                  *[None] * (len(fn.argtypes) - ints)) != 0, name
    P2, P3, Jf, hf, eps, xT, x, dx = smoke.bpairs_problem(
        smoke.RAGGED_SHAPES["small"], 0)[1]
    with pytest.raises(TypeError, match="float32"):
        bpairs.sampler_bp_adj_factor(P3, Jf)
    W = bpairs.sampler_bp_adj_factor(*smoke._f32((P3, Jf)))
    with pytest.raises(ValueError, match="CUDA"):
        bpairs.sampler_bp_adj_chain(W, P2.float(), dx.float().cpu())
    bbar = bpairs.sampler_bp_adj_chain(*smoke._f32((W, P2, dx)))[0]
    with pytest.raises(TypeError, match="float32"):
        bpairs.sampler_bp_adj_dJc(P2, P3, Jf, hf, eps, xT, x, bbar)
    samp5 = smoke.bpairs_problem(dict(B=3, T=7, d=5, S=1), 0)[1]
    with pytest.raises(ValueError, match="d=5"):
        bpairs.sampler_bp_adj_factor(*smoke._f32(samp5[1:3]))


@pytest.mark.parametrize("shape", ["small", "config2", "longT"])
def test_kalman_fwd_kernels_match_plain(smoke, shape):
    smoke.check_kalman_fwd(smoke.KFWD_SHAPES[shape], seed=0)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_kalman_fwd_kernels_match_plain_at_every_built_d(smoke, d):
    smoke.check_kalman_fwd(dict(B=5, T=9, d=d, S=3), seed=d)


def test_kalman_fwd_entry_points_launch_their_kernels(smoke):
    """Each entry point of ops/kalman_fwd.py launches its kernels once and
    no plain version; lds_estep agrees with bpairs.lds_estep and with
    float64."""
    assert smoke.kalman_fwd_path() == {"filter_shared": 1,
                                       "backward_shared": 1,
                                       "sampler_shared": 1}


def test_one_direction_filters_and_gradients_on_card(smoke):
    smoke.one_direction_filters()


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_sampler_bp_fwd_passes_match_plain_at_every_built_d(smoke, d):
    """Each pass of the per-sequence sampler (bpairs.sampler_bp_fwd_factor,
    sampler_bp_fwd_chain) against its own plain version, and the two in
    one C call against sampler_bp_fwd_plain."""
    sin = smoke.bpairs_problem(dict(B=5, T=9, d=d, S=3), seed=d)[1][:6]
    errs = smoke.check_sampler_bp_fwd_passes(sin)
    assert len(errs) == len(smoke.SAMPLER_BP_FWD_PASS_WRAPPERS)
    x = bpairs.sampler_bp_fwd(*smoke._f32(sin))
    torch.cuda.synchronize()
    errs["sampler_bp_fwd"] = smoke._max_err(
        (x,), (bpairs.sampler_bp_fwd_plain(*sin),))
    assert all(e <= smoke.TOL_ABS for e in errs.values()), errs


def test_sampler_bp_fwd_at_the_slds_lanes(smoke):
    """The slds_synth x-step's 16 sequences of two samples (d=4, T=80)."""
    errs = smoke.check_sampler_bp_fwd()
    assert set(errs) == set(smoke.SAMPLER_BP_FWD_ERRS)


def test_sampler_bp_fwd_pass_launch_counters(smoke):
    sin = smoke.bpairs_problem(smoke.RAGGED_SHAPES["small"], 0)[1][:6]
    smoke._reset_counters()
    smoke.check_sampler_bp_fwd_passes(sin)
    assert [w.launches for w in smoke.SAMPLER_BP_FWD_PASS_WRAPPERS] == [1, 1]
    assert [p.calls for p in smoke.SAMPLER_BP_FWD_PASS_PLAINS] == [1, 1]
    assert bpairs.sampler_bp_fwd.launches == 0
    # sampler_bp_fwd launches both passes' kernels in one C call of its
    # own, and counts that call alone
    bpairs.sampler_bp_fwd(*smoke._f32(sin))
    torch.cuda.synchronize()
    assert [w.launches for w in smoke.SAMPLER_BP_FWD_PASS_WRAPPERS] == [1, 1]
    assert bpairs.sampler_bp_fwd.launches == 1
    assert bpairs.sampler_bp_fwd_plain.calls == 0


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_elem_scan_short_chains_at_every_built_d(smoke, d):
    """Chains of one element (passed through) and of two (one combine)."""
    for T in (2, 3):
        leaves = smoke.elem_problem(dict(B=4, T=T, d=d, C=1), seed=d)
        got = chunked.elem_scan(leaves.float())
        torch.cuda.synchronize()
        errs = smoke._field_rel(got, chunked.elem_scan_plain(leaves), d)
        assert max(errs.values()) <= smoke.TOL_LOGZ_REL, (T, errs)


def test_redesigned_c_entries_reject_what_they_do_not_take(smoke):
    """The C entries of sampler_bp_fwd and its passes and of elem_scan
    refuse d=5 (cudaErrorInvalidValue) before they read a pointer, and the
    pass wrappers refuse float64, mixed devices and d=5."""
    from svae_tpu_torch.ops import _build
    lib = _build.load_library()
    for name in ("svae_sampler_bp_fwd_f32", "svae_sampler_bp_fwd_factor_f32",
                 "svae_sampler_bp_fwd_chain_f32", "svae_elem_scan_f32"):
        fn = getattr(lib, name)
        ints = sum(t is ctypes.c_int for t in fn.argtypes)
        assert fn(5, *[3] * (ints - 1),
                  *[None] * (len(fn.argtypes) - ints)) != 0, name
    P2, P3, Jf, hf, eps, xT = smoke.bpairs_problem(
        smoke.RAGGED_SHAPES["small"], 0)[1][:6]
    with pytest.raises(TypeError, match="float32"):
        bpairs.sampler_bp_fwd_factor(P2, P3, Jf, hf, eps)
    Q, c = bpairs.sampler_bp_fwd_factor(*smoke._f32((P2, P3, Jf, hf, eps)))
    with pytest.raises(ValueError, match="CUDA"):
        bpairs.sampler_bp_fwd_chain(Q, c, xT.float().cpu())
    sin5 = smoke.bpairs_problem(dict(B=3, T=7, d=5, S=1), 0)[1][:6]
    with pytest.raises(ValueError, match="d=5"):
        bpairs.sampler_bp_fwd_factor(*smoke._f32(sin5[:5]))


def test_shared_filters_at_their_other_shapes_and_cases(smoke):
    """The shared-pair filters (a warp per chain on filter_chain.cuh's
    step) at B=37 (a multiple of no count of chains a block but one), on
    chains of one step (T=2) at every built d, and with the upper triangles
    of the pair rows P1, P3 and of the node blocks N1 perturbed."""
    errs = smoke.check_shared_filters()
    assert set(errs) == ({"B37", "asymmetric"}
                         | {f"T2_d{d}" for d in estep.KERNEL_DIMS})


@pytest.mark.parametrize("B,T,d,b0,f0",
                         [(4, 9, 3, 1, 4), (37, 40, 10, 36, 20)])
def test_shared_filters_poison_exactly_what_an_indefinite_step_reaches(
        smoke, B, T, d, b0, f0):
    """A node with a large negative precision makes the forward filter's
    next step and the backward filter's step at that node indefinite: their
    rows from there on (and the forward's ln) come back non-finite in that
    sequence's lane, every other entry finite; also in the last lane of a
    batch that is a multiple of no count of chains a block but one."""
    counts = smoke._kfwd_non_spd(dict(B=B, T=T, d=d, S=1), b0, f0, seed=d,
                                 device="cuda")
    assert counts["filter_shared"] == (T - 1 - f0) * (d * d + d) + 1
    assert counts["backward_shared"] == f0 * (d * d + d)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_sampler_shared_passes_match_plain_at_every_built_d(smoke, d):
    """Each pass of the shared-pair sampler (kalman_fwd.sampler_shared_factor,
    then bpairs.sampler_bp_fwd_chain) against its own plain version, and
    the two in one C call against sampler_shared_plain: at B=37 (not a
    multiple of a warp) on chains of one step (T=2) and at B=5, T=9. The
    factor pass on the shared rows gives what sampler_bp_fwd_factor gives
    on the rows expanded over the batch, bit for bit."""
    from svae_tpu_torch.ops import kalman_fwd
    for B, T in ((37, 2), (5, 9)):
        sin = smoke._kfwd_sampler_problem(smoke.kfwd_problem(
            dict(B=B, T=T, d=d, S=2), d, "cuda"), "cuda")
        errs = smoke.check_sampler_shared_passes(sin)
        x = kalman_fwd.sampler_shared(*smoke._f32(sin))
        torch.cuda.synchronize()
        errs["sampler_shared"] = smoke._max_err(
            (x,), (kalman_fwd.sampler_shared_plain(*sin),))
        assert all(e <= smoke.TOL_ABS for e in errs.values()), (B, T, errs)
        P2, P3, Jf, hf, eps = smoke._f32(sin[:5])
        lanes = lambda X: X[..., None].expand(X.shape + (B,)).contiguous()
        got = kalman_fwd.sampler_shared_factor(P2, P3, Jf, hf, eps)
        want = bpairs.sampler_bp_fwd_factor(lanes(P2), lanes(P3), Jf, hf,
                                            eps)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (B, T)


def test_sampler_shared_pass_launch_counters(smoke):
    from svae_tpu_torch.ops import kalman_fwd
    sin = smoke._kfwd_sampler_problem(smoke.kfwd_problem(
        smoke.KFWD_SHAPES["small"], 0, "cuda"), "cuda")
    smoke._reset_counters()
    smoke.check_sampler_shared_passes(sin)
    assert kalman_fwd.sampler_shared_factor.launches == 1
    assert bpairs.sampler_bp_fwd_chain.launches == 1
    assert kalman_fwd.sampler_shared_factor_plain.calls == 1
    assert kalman_fwd.sampler_shared.launches == 0
    # sampler_shared launches both passes' kernels in one C call of its
    # own, and counts that call alone
    kalman_fwd.sampler_shared(*smoke._f32(sin))
    torch.cuda.synchronize()
    assert kalman_fwd.sampler_shared_factor.launches == 1
    assert kalman_fwd.sampler_shared.launches == 1
    assert kalman_fwd.sampler_shared_plain.calls == 0


@pytest.mark.parametrize("B,T,d,b0,t0",
                         [(4, 9, 3, 1, 3), (37, 40, 10, 36, 20)])
def test_sampler_shared_poisons_exactly_what_an_indefinite_step_reaches(
        smoke, B, T, d, b0, t0):
    """An indefinite Jc at step t0 of sequence b0: that step's and every
    earlier step's samples of b0, in both samples' lanes, come back
    non-finite, every other entry finite; also in the last lane of a batch
    that is not a multiple of a warp."""
    count = smoke._kfwd_sampler_non_spd(dict(B=B, T=T, d=d, S=2), b0, t0,
                                        seed=d, device="cuda")
    assert count == (t0 + 1) * d * 2


@pytest.mark.parametrize("K", hmm_fb.KERNEL_STATES)
def test_hmm_kernels_on_chains_of_one_step_at_every_built_K(smoke, K):
    """Every HMM kernel and the passes of both adjoints (check_hmm) on
    chains of one step (T=2) at B=37, not a multiple of the chains a warp
    holds at any K."""
    errs = smoke.check_hmm(dict(B=37, T=2, K=K), seed=K)
    assert set(smoke.HMM_STAT_ADJ_ERRS) <= set(errs)


def test_hmm_stat_adj_pass_launch_counters(smoke):
    li, lt, lo, _ = smoke.hmm_problem(smoke.HMM_SHAPES["small"], 0, "cuda")
    args = smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_stat_fwd"]
    alpha, beta = hmm_fb.hmm_fb_stat_fwd_plain(*args)
    adj = (*args, alpha, beta, torch.ones_like(alpha), torch.ones_like(beta))
    smoke._reset_counters()
    smoke.check_hmm_stat_adj_passes(adj)
    assert [w.launches for w in smoke.HMM_STAT_PASS_WRAPPERS] == [1, 1]
    assert [p.calls for p in smoke.HMM_STAT_PASS_PLAINS] == [1, 1]
    assert hmm_fb.hmm_fb_adj_chain.launches == 1
    assert hmm_fb.hmm_fb_stat_adj.launches == 0
    # hmm_fb_stat_adj launches the three kernels in one C call of its own,
    # and counts that call alone
    hmm_fb.hmm_fb_stat_adj(*smoke._f32(adj))
    torch.cuda.synchronize()
    assert [w.launches for w in smoke.HMM_STAT_PASS_WRAPPERS] == [1, 1]
    assert hmm_fb.hmm_fb_stat_adj.launches == 1
    assert hmm_fb.hmm_fb_stat_adj_plain.calls == 0


def test_redesigned_stationary_c_entries_reject_an_unbuilt_size(smoke):
    """The C entries of sampler_shared, its factor pass and the stationary
    HMM adjoint and its passes refuse d=5 / K=5 (cudaErrorInvalidValue)
    before they read a pointer."""
    from svae_tpu_torch.ops import _build
    lib = _build.load_library()
    for name in ("svae_sampler_shared_f32", "svae_sampler_shared_factor_f32",
                 "svae_hmm_fb_stat_adj_f32",
                 "svae_hmm_fb_stat_adj_weights_f32",
                 "svae_hmm_fb_stat_adj_sums_f32"):
        fn = getattr(lib, name)
        ints = sum(t is ctypes.c_int for t in fn.argtypes)
        assert fn(5, *[3] * (ints - 1),
                  *[None] * (len(fn.argtypes) - ints)) != 0, name


@pytest.mark.parametrize("K", hmm_fb.KERNEL_STATES)
@pytest.mark.parametrize("shape", ["slds", "measure_hmm"])
def test_hmm_stat_fwd_is_the_streamed_kernel_on_LT_plus_lo(smoke, shape, K):
    """The stationary forward (K lanes a chain, LT in registers, only the
    observations streamed) gives hmm_fb_fwd's messages on the packed
    float32 LT + lo bit for bit, at the slds_synth z-step's and
    measure_hmm's B and T and every built K."""
    B, T = (smoke.HMM_SHAPES[shape][k] for k in "BT")
    li, lt, lo, _ = smoke.hmm_problem(dict(B=B, T=T, K=K), K, "cuda")
    smoke.check_hmm_stat_fwd_bitwise(
        smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_stat_fwd"])


def test_hmm_stat_fwd_writes_every_message_once_in_a_partial_warp(smoke):
    """K = 3 (a segment of four lanes, one idle) at B=37: 74 chains of 4
    lanes fill 9 warps and a quarter of a tenth. Through the C entry, onto
    outputs filled with NaN and followed by a guard of NaN: every message
    is written, none past the outputs, and each is the streamed kernel's
    on LT + lo (a shadow or idle lane storing would break one of these)."""
    from svae_tpu_torch.ops import _build
    K, B, T = 3, 37, 9
    li, lt, lo, _ = smoke.hmm_problem(dict(B=B, T=T, K=K), 3, "cuda")
    args = smoke.hmm_kernel_args(li, lt, lo)["hmm_fb_stat_fwd"]
    a0, LT, lo32 = smoke._f32(args)
    n, guard = (T - 1) * K * B, 256
    buf = torch.full((2, n + guard), float("nan"), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    assert _build.load_library().svae_hmm_fb_stat_fwd_f32(
        K, B, T - 1, a0.data_ptr(), LT.data_ptr(), lo32.data_ptr(),
        buf[0].data_ptr(), buf[1].data_ptr(), stream) == 0
    want = hmm_fb.hmm_fb_fwd(*smoke.hmm_stat_as_streamed(*args))
    torch.cuda.synchronize()
    assert torch.isnan(buf[:, n:]).all()
    for got, w in zip(buf[:, :n], want):
        assert torch.isfinite(got).all()
        assert torch.equal(got.reshape(w.shape), w)
