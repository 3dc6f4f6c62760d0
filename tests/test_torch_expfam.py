"""Parity of the port's utils and exponential families with the JAX
package, in float64 on the CPU: NIW/MNIW log-normalizers, expected
statistics and expected potentials (and expectedstats == autograd of
logZ), the PSD helpers, the nested-tuple algebra, f32_linalg and the dot
data. Tolerance rtol 1e-8 / atol 1e-10: both sides are float64, and
LAPACK's Cholesky rounds differently from the JAX package's unrolled one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svae_tpu.data import synthetic as jax_synthetic
from svae_tpu.expfam import mniw as jax_mniw
from svae_tpu.expfam import niw as jax_niw
from svae_tpu.utils import psd as jax_psd
from svae_tpu.utils import pytree as jax_pytree

from svae_tpu_torch.data import synthetic
from svae_tpu_torch.expfam import mniw, niw
from svae_tpu_torch.utils import psd, pytree

torch.set_num_threads(1)
RTOL, ATOL = 1e-8, 1e-10


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(port, ref):
    for p, r in zip(pytree.tree_leaves(port), jax.tree.leaves(ref)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


def _spd(rng, d, shift):
    G = rng.standard_normal((d, d))
    return G @ G.T + shift * np.eye(d)


def _niw_standard(rng, d=3):
    return (_spd(rng, d, d), rng.standard_normal(d), np.float64(2.5),
            np.float64(d + 4.0))


def _mniw_standard(rng, d=3, n=3):
    return (_spd(rng, d, d), rng.standard_normal((d, n)), _spd(rng, n, 1.0),
            np.float64(d + n + 3.0))


# family, its JAX twin, a standard-parameter maker, and the natparam slots
# that are symmetric matrices (their gradient is symmetrized to compare)
FAMILIES = {
    "niw": (niw, jax_niw, _niw_standard, (0,)),
    "mniw": (mniw, jax_mniw, _mniw_standard, (0, 2)),
}


@pytest.fixture(params=sorted(FAMILIES))
def family(request):
    fam, jax_fam, make, sym_slots = FAMILIES[request.param]
    std = make(np.random.default_rng(0))
    nat_j = jax_fam.standard_to_natural(*(jnp.asarray(a) for a in std))
    nat_t = fam.standard_to_natural(*(_t(a) for a in std))
    return fam, jax_fam, nat_t, nat_j, sym_slots


def test_natparam_roundtrip_matches_jax(family):
    fam, jax_fam, nat_t, nat_j, _ = family
    _close(nat_t, nat_j)
    _close(fam.natural_to_standard(nat_t), jax_fam.natural_to_standard(nat_j))


def test_logZ_matches_jax(family):
    fam, jax_fam, nat_t, nat_j, _ = family
    _close(fam.logZ(nat_t), jax_fam.logZ(nat_j))


def test_expectedstats_matches_jax(family):
    fam, jax_fam, nat_t, nat_j, _ = family
    _close(fam.expectedstats(nat_t), jax_fam.expectedstats(nat_j))


def test_expectedstats_is_autograd_of_logZ(family):
    fam, _, nat_t, _, sym_slots = family
    leaves = tuple(x.clone().requires_grad_(True) for x in nat_t)
    grads = torch.autograd.grad(fam.logZ(leaves), leaves)
    stats = fam.expectedstats(nat_t)
    for i, (g, s) in enumerate(zip(grads, stats)):
        if i in sym_slots:
            g = psd.symmetrize(g)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-8,
                                   atol=1e-10)


def test_expected_potentials_match_jax():
    rng = np.random.default_rng(1)
    niw_std, mniw_std = _niw_standard(rng), _mniw_standard(rng)
    nat_j = jax_niw.standard_to_natural(*(jnp.asarray(a) for a in niw_std))
    nat_t = niw.standard_to_natural(*(_t(a) for a in niw_std))
    _close(niw.expected_gaussian_natparam(nat_t),
           jax_niw.expected_gaussian_natparam(nat_j))
    nat_j = jax_mniw.standard_to_natural(*(jnp.asarray(a) for a in mniw_std))
    nat_t = mniw.standard_to_natural(*(_t(a) for a in mniw_std))
    _close(mniw.expected_pair_potential(nat_t),
           jax_mniw.expected_pair_potential(nat_j))


@pytest.mark.parametrize("fn", ["logdet_psd", "inv_psd", "mvn_logZ_info",
                                "solve_psd"])
def test_psd_helpers_match_jax(fn):
    rng = np.random.default_rng(2)
    a = np.stack([_spd(rng, 3, 1.0) for _ in range(4)])
    v = rng.standard_normal((4, 3))
    args = {"logdet_psd": (a,), "inv_psd": (a,), "mvn_logZ_info": (a, v),
            "solve_psd": (a, a[::-1])}[fn]
    _close(getattr(psd, fn)(*(_t(x) for x in args)),
           getattr(jax_psd, fn)(*(jnp.asarray(x) for x in args)))


def test_chol_failure_is_nan():
    from svae_tpu_torch.utils import smallchol

    a = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 2.0], [2.0, 1.0]]],
                     dtype=torch.float64)
    L = smallchol.chol(a)
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).all()


def test_tree_algebra_matches_jax():
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((2, 2)), (rng.standard_normal(3), np.float64(2)))
    b = (rng.standard_normal((2, 2)), (rng.standard_normal(3), np.float64(5)))
    ta, tb = pytree.tree_map(_t, a), pytree.tree_map(_t, b)
    ja, jb = jax.tree.map(jnp.asarray, (a, b))
    _close(pytree.tree_add(ta, tb), jax_pytree.tree_add(ja, jb))
    _close(pytree.tree_sub(ta, tb), jax_pytree.tree_sub(ja, jb))
    _close(pytree.tree_scale(ta, 0.5), jax_pytree.tree_scale(ja, 0.5))
    _close(pytree.tree_dot(ta, tb), jax_pytree.tree_dot(ja, jb))


def test_f32_linalg_sets_and_restores_precision():
    seen = {}

    @psd.f32_linalg()
    def probe():
        seen["tf32"] = (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32)
        seen["precision"] = torch.get_float32_matmul_precision()

    before = torch.get_float32_matmul_precision()
    cudnn_before = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    try:
        probe()
        assert seen == {"tf32": (False, False), "precision": "highest"}
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 == cudnn_before
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_dot_data_matches_jax_package(seed):
    kw = dict(seed=seed, num_seqs=5, T=9, image_width=8)
    np.testing.assert_array_equal(synthetic.make_dot_data(**kw),
                                  jax_synthetic.make_dot_data(**kw))
