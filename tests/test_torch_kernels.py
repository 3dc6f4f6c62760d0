"""The CUDA kernels of svae_tpu_torch/csrc/*.cu against their plain
versions, on a card. Every test is marked ``gpu`` and skips on a host
without one. The file imports no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Kernels run in float32, plain versions in float64 on the same inputs; the
tolerances are chip_smoke.py's (the float32 tiers of
tests/test_f32_parity.py, and a normwise 1e-3 for the adjoints)."""

import os
import sys

import pytest
import torch

from svae_tpu_torch.models import lds
from svae_tpu_torch.ops import bpairs, estep

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


@pytest.mark.parametrize("shape", ["small", "config2"])
def test_adjoints_match_plain(smoke, shape):
    smoke.check_adjoints(smoke.SHAPES[shape], seed=0)


@pytest.mark.parametrize("d", estep.KERNEL_DIMS)
def test_adjoints_match_plain_at_every_built_d(smoke, d):
    smoke.check_adjoints(dict(B=5, T=9, d=d, S=3), seed=d)


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
    jd, h, _ = lds._prepare(nodes, None, lengths, False)
    pairs, (N1, N2) = lds._ragged_chain(mats, (jd, h), lengths)
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
